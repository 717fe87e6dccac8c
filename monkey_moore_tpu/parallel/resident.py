"""Sharded resident corpus — upload once, scan many, across a device mesh.

The mesh analog of :mod:`monkey_moore_tpu.corpus`: the file's bytes are
packed into little-endian i32 words on the host (a zero-copy view) and
``jax.device_put`` ONCE with a ``NamedSharding`` over the mesh's data axis.
Every element grid the engine needs — 8/16-bit, either endianness, either
byte alignment — is derived ON DEVICE per shard (word shifts + byte swaps, with an 8-byte ``ppermute`` borrow from
the right neighbor for the odd-alignment grids), so repeat searches and
16-bit/byte-swapped views transfer **zero** corpus bytes host→device.

This is the production shape for multi-chip scans: the reference re-reads
the file from disk per search (``src/core/search_engine.cpp:120-127``); the
round-3 mesh path re-uploaded the corpus every chunk.  Here the whole
corpus is scanned in ONE collective dispatch per alignment grid
(``scan_resident``), with the per-(pattern, geometry) boundary operands
memoized as device arrays so a repeat search's H2D traffic is zero.
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import Endianness
from ..utils.logging import log
from .mesh import DATA_AXIS

__all__ = [
    "ShardedResidentCorpus",
    "get_sharded_corpus",
    "clear_sharded_corpus_cache",
]

_cache: dict = {}
_cache_lock = threading.Lock()

#: derived grids are memoized only below this size (each memoized grid is
#: another corpus-sized device buffer; big corpora re-derive per search —
#: one cheap on-device dispatch — instead of doubling HBM)
_GRID_MEMO_LIMIT = 512 * 1024 * 1024


class ShardedResidentCorpus:
    """One file resident across a mesh as packed little-endian i32 words."""

    def __init__(self, data_bytes: np.ndarray, mesh, tile_elems: int):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = mesh
        self.tile_elems = tile_elems
        self.n_bytes = len(data_bytes)
        d = mesh.shape[DATA_AXIS]
        self.n_devices = d

        # Unit = one 16-bit tile = 2*tile_elems bytes; B (bytes/device) a
        # whole number of units makes every grid's per-device element count
        # a whole number of count tiles (u8: 2 tiles/unit, u16: 1).
        unit = 2 * tile_elems
        units_total = max(1, -(-self.n_bytes // unit))  # ceil(bytes/unit)
        u_loc = -(-units_total // d)  # ceil(units/devices)
        self.bytes_per_device = u_loc * unit
        total = d * self.bytes_per_device
        padded = np.zeros(total, dtype=np.uint8)
        padded[: self.n_bytes] = data_bytes
        words = padded.view("<u4").view(np.int32)  # zero-copy host view
        self.words_per_device = self.bytes_per_device // 4
        self.device_words = jax.device_put(
            words, NamedSharding(mesh, P(DATA_AXIS))
        )
        jax.block_until_ready(self.device_words)
        self.uploaded_bytes = total
        #: True until the first engine run accounts the upload in its stats
        self.fresh = True
        self._grids: dict = {}
        self._operands: dict = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def t_loc(self, element_width: int) -> int:
        """Count tiles per device of an ``element_width`` grid."""
        return self.bytes_per_device // element_width // self.tile_elems

    def grid(self, element_width: int, endianness: Endianness, align: int):
        """Device grid (sharded flat element array) for one (width,
        endianness, alignment) view.  Derived on device; memoized for
        corpora under ``_GRID_MEMO_LIMIT``."""
        big = endianness is Endianness.BIG
        key = (element_width, big, align)
        with self._lock:
            hit = self._grids.get(key)
        if hit is not None:
            return hit
        dev = _derive_grid_fn(
            self.mesh, element_width, big, align, self.words_per_device,
        )(self.device_words)
        if self.n_bytes <= _GRID_MEMO_LIMIT:
            with self._lock:
                self._grids[key] = dev
        return dev

    def step_operands(self, pat, valid_count: int, element_width: int):
        """Memoized DEVICE copies of the per-(pattern, geometry) boundary
        operands, so a repeat search uploads nothing."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .sharded import sharded_step_operands

        key = (pat.kernel_key(), id(pat), valid_count, element_width)
        with self._lock:
            hit = self._operands.get(key)
        if hit is not None:
            return hit[1:]
        t_loc = self.t_loc(element_width)
        valid2, vtvr2, expected_in = sharded_step_operands(
            pat, valid_count, t_loc, self.tile_elems, self.n_devices
        )
        rows = NamedSharding(self.mesh, P(DATA_AXIS))
        # the stored pattern ref pins its id: kernel_key alone does not
        # distinguish same-shape keywords, so a freed-and-recycled object
        # id must never serve another pattern's expected/boundary operands
        out = (
            pat,
            jax.device_put(valid2, rows),
            jax.device_put(vtvr2, rows),
            expected_in,
        )
        with self._lock:
            if len(self._operands) > 64:
                self._operands.clear()
            self._operands[key] = out
        return out[1:]


@functools.lru_cache(maxsize=64)
def _derive_grid_fn(mesh, s: int, big: bool, align: int,
                    words_per_device: int):
    """Jitted SPMD grid derivation: local word shard → local grid shard.

    Byte-stream view: local words hold bytes ``[base, base + B)``; grid
    elements of alignment ``align`` start at byte ``align + e*s``, so the
    local grid needs bytes ``[base + align, base + B + align)`` — the
    trailing ``align`` bytes come from the right neighbor via one 8-byte
    ``ppermute`` (wrapping at the last device, where padding masks it).
    All reshaping is word arithmetic on device; no host transfer.
    """
    import jax
    import jax.numpy as jnp

    n_dev = mesh.shape[DATA_AXIS]
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local(words_local):
        w = jax.lax.bitcast_convert_type(words_local, jnp.uint32)
        borrow = jax.lax.ppermute(w[:1], DATA_AXIS, perm)
        nxt = jnp.concatenate([w[1:], borrow])
        if align:
            # shift the byte stream down by one: each word takes its own
            # top 3 bytes and the next word's low byte
            w = (w >> jnp.uint32(8)) | (nxt << jnp.uint32(24))
        if s == 2 and big:
            # byte swap within each 16-bit element
            w = ((w >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF)) | (
                (w << jnp.uint32(8)) & jnp.uint32(0xFF00FF00)
            )
        # element output via 1-D gather + shift
        per_word = 4 // s
        n_el = words_per_device * per_word
        idx = jnp.arange(n_el, dtype=jnp.int32)
        shift = (idx % per_word).astype(jnp.uint32) * jnp.uint32(8 * s)
        out = (w[idx // per_word] >> shift) & jnp.uint32((1 << (8 * s)) - 1)
        return out.astype(jnp.uint8 if s == 1 else jnp.uint16)

    from jax.sharding import PartitionSpec as P

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(DATA_AXIS),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(mapped)


def get_sharded_corpus(
    path, file_size: int, mesh, tile_elems: int, limit_bytes: int,
    stats=None,
) -> Optional["ShardedResidentCorpus"]:
    """Cached sharded corpus for *path* on *mesh* (most recent held), or
    None when over the limit / unreadable.  A rejected upload is logged and
    counted in ``stats.resident_upload_failures`` (see
    ``corpus.get_resident_corpus``)."""
    import jax

    if limit_bytes <= 0 or file_size > limit_bytes or file_size == 0:
        return None
    p = Path(path)
    try:
        stat = p.stat()
    except OSError:
        return None
    key = (
        str(p.resolve()), stat.st_size, stat.st_mtime_ns,
        tuple(d.id for d in mesh.devices.flat), tile_elems,
    )
    # the whole miss-check + build runs under the lock: two concurrent
    # searches must not double-upload a multi-GiB corpus (transient 2x
    # HBM residency during the upload window)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            return hit
        data = np.fromfile(p, dtype=np.uint8)
        try:
            corpus = ShardedResidentCorpus(data, mesh, tile_elems)
        except jax.errors.JaxRuntimeError as e:  # e.g. out of device memory
            log("sharded corpus upload of ", len(data), " bytes failed (",
                e, "); streaming chunks instead")
            if stats is not None:
                stats.resident_upload_failures += 1
            return None
        _cache.clear()
        _cache[key] = corpus
        return corpus


def clear_sharded_corpus_cache() -> None:
    with _cache_lock:
        _cache.clear()
