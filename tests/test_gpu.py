"""Checks that need an NVIDIA card (marker ``gpu``; skipped elsewhere by the
``gpu_device`` fixture): the fused device step compiled for the GPU against
the host's C dense scanner at a realistic chunk size."""

import numpy as np
import pytest

from monkey_moore_tpu.dense import TILE_ELEMS, fused_count_extract
from monkey_moore_tpu.ops.scan_host import host_candidates_values
from monkey_moore_tpu.pattern import compile_pattern


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 2])
def test_fused_step_matches_host_scanner(gpu_device, width, rng):
    import jax

    dtype = np.uint8 if width == 1 else np.uint16
    mod = 1 << (8 * width)
    n = (256 << 20) // width  # a 256 MiB chunk
    data = rng.integers(0, mod, n + TILE_ELEMS).astype(dtype)
    data[n:] = 0
    pat = compile_pattern("abcde", dtype=dtype)
    kw = np.array(pat.keyword, dtype=np.int64)
    for i, pos in enumerate([0, TILE_ELEMS - 2, n // 2 + 1, n - 5]):
        data[pos : pos + 5] = ((kw + 7 * i) % mod).astype(dtype)
    dev = jax.device_put(data, gpu_device)
    offs, vals, info = fused_count_extract(pat, dev, n)
    want_offs, want_vals = host_candidates_values(pat, data[:n], False)
    assert not info.fallback
    assert offs.tolist() == want_offs.tolist()
    assert vals.tolist() == want_vals.tolist()
