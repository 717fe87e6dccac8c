"""Resident device corpus.

The interactive workflow this framework is built for — explore a ROM by
searching many keywords — uploads the corpus to device memory **once** and
then runs every scan against the resident bytes, so repeat searches move no
corpus bytes host→device.  (The reference re-reads the file from disk per
search, ``src/core/search_engine.cpp:120-127``.)

Storage layout: the file's bytes live as a FLAT little-endian i32 word
array, and every element grid the engine needs (8/16-bit, either
endianness, either byte alignment) is derived from it with pure word
arithmetic — shifts for the byte-unaligned grids, masked rotates for the
16-bit byteswap — keeping every intermediate 1-D.

A process-wide cache holds the most recent corpus, keyed by
(path, size, mtime).
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .config import Endianness
from .utils.logging import log

__all__ = [
    "ResidentCorpus",
    "get_resident_corpus",
    "clear_corpus_cache",
    "resident_pad_bytes",
]

_cache: dict = {}
_cache_lock = threading.Lock()


class ResidentCorpus:
    """Device-resident corpus for one file, stored as flat LE i32 words."""

    def __init__(self, data_bytes: np.ndarray, pad_bytes: int):
        import jax
        import jax.numpy as jnp

        self.n_bytes = len(data_bytes)
        # pad to whole words + one spare word (the byte-shift borrows from
        # the next word)
        total = -(-(self.n_bytes + pad_bytes + 4) // 4) * 4
        padded = np.zeros(total, dtype=np.uint8)
        padded[: self.n_bytes] = data_bytes
        words = padded.view("<u4").view(np.int32)  # zero-copy host view
        self.device_words = jax.device_put(jnp.asarray(words))
        jax.block_until_ready(self.device_words)
        #: True until the first engine run accounts the upload in its stats
        self.fresh = True

    def __len__(self):
        """Byte capacity of the device buffer."""
        return self.device_words.size * 4

    def grid_chunk(
        self,
        element_width: int,
        endianness: Endianness,
        align: int,
        e_start: int,
        want_elems: int,
    ):
        """Device element array of ``want_elems`` elements of the
        (alignment, endianness) grid starting at element ``e_start``.
        Reads past EOF yield padding zeros (masked by the caller's
        valid count)."""
        b0 = align + e_start * element_width
        return _grid_fn()(
            self.device_words,
            b0 // 4,
            byte_shift=b0 % 4,
            s=element_width,
            big=endianness is Endianness.BIG,
            want=want_elems,
        )


@functools.lru_cache(maxsize=1)
def _grid_fn():
    import jax
    import jax.numpy as jnp

    @functools.partial(
        jax.jit, static_argnames=("byte_shift", "s", "big", "want")
    )
    def grid_on_device(words, word_start, *, byte_shift, s, big, want):
        n_words = -(-(want * s) // 4)
        raw = jax.lax.dynamic_slice(words, (word_start,), (n_words + 1,))
        w = jax.lax.bitcast_convert_type(raw, jnp.uint32)
        if byte_shift:
            # shift the byte stream down: each word takes its own top bytes
            # and the next word's low bytes
            k = jnp.uint32(8 * byte_shift)
            w = (w[:-1] >> k) | (w[1:] << (jnp.uint32(32) - k))
        else:
            w = w[:-1]
        if s == 2 and big:
            # byte swap within each 16-bit element
            w = ((w >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF)) | (
                (w << jnp.uint32(8)) & jnp.uint32(0xFF00FF00)
            )
        # element output via 1-D gather + shift
        per_word = 4 // s
        idx = jnp.arange(want, dtype=jnp.int32)
        shift = (idx % per_word).astype(jnp.uint32) * jnp.uint32(8 * s)
        out = (w[idx // per_word] >> shift) & jnp.uint32((1 << (8 * s)) - 1)
        return out.astype(jnp.uint8 if s == 1 else jnp.uint16)

    return grid_on_device


def resident_pad_bytes(chunk_bytes: int, tile_elems: int) -> int:
    """Zero padding past EOF a resident corpus needs so the last chunk's
    grid (one chunk + one halo tile of elements) reads inside the buffer.
    Sized for the widest (16-bit) halo tile, so 8- and 16-bit searches of
    one file share one upload."""
    return chunk_bytes + 2 * tile_elems + 8


def get_resident_corpus(
    path, file_size: int, limit_bytes: int, pad_bytes: int, stats=None
) -> Optional[ResidentCorpus]:
    """Cached resident corpus for *path*, or None when over the limit or the
    device rejects the allocation.  Holds one corpus (the most recent).

    A rejected upload is logged and counted in
    ``stats.resident_upload_failures`` (a ``profiling.SearchStats``) so a
    search that falls back to streaming is visible."""
    import jax

    if limit_bytes <= 0 or file_size > limit_bytes or file_size == 0:
        return None
    p = Path(path)
    try:
        stat = p.stat()
    except OSError:
        return None
    key = (str(p.resolve()), stat.st_size, stat.st_mtime_ns)
    # miss-check + build under the lock: concurrent searches must not
    # double-upload a multi-GiB corpus
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None and len(hit) >= file_size + pad_bytes:
            return hit
        data = np.fromfile(p, dtype=np.uint8)
        try:
            corpus = ResidentCorpus(data, pad_bytes)
        except jax.errors.JaxRuntimeError as e:  # e.g. out of device memory
            log("resident corpus upload of ", len(data), " bytes failed (",
                e, "); streaming chunks instead")
            if stats is not None:
                stats.resident_upload_failures += 1
            return None
        _cache.clear()
        _cache[key] = corpus
        return corpus


def clear_corpus_cache() -> None:
    with _cache_lock:
        _cache.clear()
