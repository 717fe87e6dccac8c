#!/usr/bin/env python
"""Headline benchmark: 8-bit relative-search scan throughput on one device.

Mirrors the reference's benchmark setup (``benchmarks/bench_search.cpp:29,67``:
random data, 5-char keyword "abcde", bytes/s) on device-resident data — the
interactive ROM-exploration workload where the corpus is loaded to device
memory once and searched repeatedly.  The corpus is generated on the device
(threefry, from a fixed seed) as one flat 8-bit array below the scan's
``2**31``-element limit; each timed step runs the full production path — ONE
fused dispatch computing the tile-count prefilter, gathering hot tiles and
extracting exact candidates on device (``dense.fused_count_extract``).

In the same process it times a plain XLA read-reduce of the same bytes, the
ceiling a sweep that touches every byte once can reach on this device.

Prints the device, its name and power limit (``nvidia-smi``) on stderr and
ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "bytes/s", "pct_hbm_roofline": N,
     "plain_read_bytes_per_s": N, "sweep_over_read": N, "device": {...}}

``pct_hbm_roofline`` is the end-to-end rate as a percentage of the device's
published memory bandwidth (:data:`HBM_BYTES_PER_S`); a device missing from
that table is an error, so the benchmark refuses to run on a CPU.

Knobs: ``MMTPU_BENCH_MB`` (corpus MiB, default 1024), ``MMTPU_BENCH_WARMUP``,
``MMTPU_BENCH_ITERS``, ``MMTPU_BENCH_PIPELINE`` (fused steps in flight).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

#: 1 GiB default: one flat 8-bit array stays under the scan's 2**31-element
#: limit (``dense.MAX_DEVICE_ELEMS``)
DATA_MB = int(os.environ.get("MMTPU_BENCH_MB", "1024"))
WARMUP = int(os.environ.get("MMTPU_BENCH_WARMUP", "3"))
ITERS = int(os.environ.get("MMTPU_BENCH_ITERS", "15"))
PIPELINE = int(os.environ.get("MMTPU_BENCH_PIPELINE", "3"))

#: Published device-memory bandwidth by ``device_kind``, bytes/s.
#: NVIDIA H100 SXM5 80 GB: 3.35 TB/s HBM3 (NVIDIA H100 Tensor Core GPU
#: data sheet).  A kind missing here is an error, never a default.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device_kind: str) -> float:
    """Published memory bandwidth of *device_kind*; ``ValueError`` for a
    device the table does not know."""
    try:
        return HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(HBM_BYTES_PER_S)}"
        ) from None


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, read
    in a child process that does not use JAX.  Raises ``OSError`` /
    ``subprocess.CalledProcessError`` when there is no NVIDIA card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def read_reduce_fn():
    """Jitted plain read of a device array: every byte is loaded once and
    reduced to one uint32 (bitcast to 32-bit words, wrapping sum)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def read_reduce(x):
        w = jax.lax.bitcast_convert_type(
            x.reshape(-1, 4 // x.dtype.itemsize), jnp.uint32
        )
        return jnp.sum(w, dtype=jnp.uint32)

    return read_reduce


def best_seconds(fn, iters: int) -> float:
    """Best wall time of ``fn()`` over *iters* calls; ``fn`` must block on
    its device result."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from monkey_moore_tpu.dense import (
        MAX_DEVICE_ELEMS,
        TILE_ELEMS,
        fused_count_extract,
        fused_count_extract_finish,
        fused_count_extract_start,
    )
    from monkey_moore_tpu.pattern import compile_pattern
    from monkey_moore_tpu.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()
    dev0 = jax.devices()[0]
    peak = hbm_bytes_per_s(dev0.device_kind)
    device = {
        "platform": dev0.platform,
        "kind": dev0.device_kind,
        "count": len(jax.devices()),
    }
    print(f"device: {device} | card: {card_line()}", file=sys.stderr)

    n = DATA_MB * 1024 * 1024
    if n + TILE_ELEMS >= MAX_DEVICE_ELEMS:
        print(f"error: MMTPU_BENCH_MB={DATA_MB} exceeds one device array "
              f"(< 2**31 elements)", file=sys.stderr)
        return 1
    pat = compile_pattern("abcde")

    # random corpus generated on the device + one zero halo tile
    @jax.jit
    def make_corpus(key):
        body = jax.random.bits(key, (n,), dtype=jnp.uint8)
        return jnp.concatenate([body, jnp.zeros(TILE_ELEMS, jnp.uint8)])

    data = jax.block_until_ready(make_corpus(jax.random.PRNGKey(42)))

    def step():
        return fused_count_extract(pat, data, n)[2]

    step()  # compile
    for _ in range(WARMUP):
        step()
    best = best_seconds(step, ITERS)

    # pipelined steady state (the engine's chunk loop,
    # SearchConfig.pipeline_depth): PIPELINE fused steps in flight, every
    # result still fetched, one step late
    from collections import deque

    depth = max(1, PIPELINE)
    pend = deque()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        pend.append(fused_count_extract_start(pat, data, n))
        if len(pend) >= depth:
            fused_count_extract_finish(pend.popleft())
    while pend:
        fused_count_extract_finish(pend.popleft())
    piped = (time.perf_counter() - t0) / ITERS

    read = read_reduce_fn()
    jax.block_until_ready(read(data))  # compile
    t_read = best_seconds(lambda: jax.block_until_ready(read(data)), ITERS)
    read_rate = data.nbytes / t_read

    value = n / min(best, piped)
    print(
        f"fused step sync best {n / best / 1e9:.1f} GB/s | pipelined "
        f"x{depth} {n / piped / 1e9:.1f} GB/s | plain read "
        f"{read_rate / 1e9:.1f} GB/s over {ITERS} steps",
        file=sys.stderr,
    )
    record = {
        "metric": "relative_search_scan_8bit_bytes_per_s",
        "value": value,
        "unit": "bytes/s",
        "pct_hbm_roofline": 100.0 * value / peak,
        "plain_read_bytes_per_s": read_rate,
        "sweep_over_read": value / read_rate,
        "device": device,
    }
    print(json.dumps(record))


if __name__ == "__main__":
    sys.exit(main() or 0)
