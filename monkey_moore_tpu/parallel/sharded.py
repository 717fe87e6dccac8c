"""Sharded dense scan over a device mesh (layer L4).

The multi-device counterpart of the reference's block/thread-pool runtime
(``src/core/search_engine.cpp:82-175``): the element array is sharded across
the mesh's "data" axis; each device scans its shard plus a halo of
``pattern_len - 1`` elements fetched from its right neighbor with
``lax.ppermute`` (one neighbor exchange) — mirroring the reference's overlapping block
reads (``search_engine.cpp:223-252``).  Every match is found by exactly one
shard (the one whose base region contains its start), so no dedup is needed;
per-shard fixed-capacity candidate buffers are returned sharded and
concatenated on host (the collective analog of the reference's future
harvesting + merge, ``search_engine.cpp:83-102``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.scan_jnp import match_bitmap, compact_matches, pattern_device_args
from ..pattern import CompiledPattern
from .mesh import DATA_AXIS

__all__ = [
    "sharded_scan_fn",
    "sharded_candidates",
    "sharded_tile_counts",
    "sharded_fused_step",
    "sharded_fused_step_start",
    "sharded_fused_step_finish",
    "ShardedPending",
    "sharded_step_operands",
    "parse_sharded_combos",
    "shard_grid",
]


def sharded_scan_fn(
    mesh: Mesh, length: int, signed_compare: bool, capacity: int
):
    """Build the jitted SPMD scan step for a given mesh/pattern shape.

    Returns ``fn(data, valid, shift_cur, shift_prev, expected, recovery)``
    with ``data`` length divisible by the mesh size; output arrays are
    per-shard stacked: counts [D], offsets [D, capacity] (global element
    offsets, -1 fill), values [D, capacity, 2].
    """
    halo = length - 1
    n_dev = mesh.shape[DATA_AXIS]

    def local_scan(d_local, valid, sc, sp, exp, rec):
        # d_local: [shard] — this device's slice of the corpus.
        shard = d_local.shape[0]
        my = jax.lax.axis_index(DATA_AXIS)

        # Halo exchange: receive the first ``halo`` elements of the right
        # neighbor (one neighbor permute; wraps at the boundary, where the
        # stale values are masked off by the global valid count).
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo_elems = jax.lax.ppermute(d_local[:halo], DATA_AXIS, perm)
        ext = jnp.concatenate([d_local, halo_elems])  # [shard + halo]

        base = (my * shard).astype(jnp.int32)
        # Windows starting inside this shard; global validity via local count.
        valid_local = jnp.clip(valid - base, 0, shard + halo)
        bitmap = match_bitmap(
            ext, valid_local, length, sc, sp, exp, signed_compare
        )
        count, offsets = compact_matches(bitmap, capacity)
        values = ext[
            jnp.clip(jnp.maximum(offsets, 0)[:, None] + rec[None, :], 0,
                     shard + halo - 1)
        ]
        offsets_global = jnp.where(offsets >= 0, offsets + base, -1)
        return count[None], offsets_global[None], values[None]

    mapped = jax.shard_map(
        local_scan,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _cached_fn(mesh, length, signed_compare, capacity):
    return sharded_scan_fn(mesh, length, signed_compare, capacity)


# ---------------------------------------------------------------------------
# Two-phase sharded scan: the multi-device twin of the single-device design
# (device tile-count prefilter + host hot-tile extraction, ``dense.py``),
# replacing on-device offset compaction with 4-bytes-per-tile counts.


def shard_grid(arr: np.ndarray, mesh: Mesh, tile_elems: int):
    """Pad a host element array to whole per-device tile spans and place it
    sharded across the mesh's data axis.  Returns (device_array, T) where T
    is the number of counted tiles covering ``len(arr)`` elements."""
    import jax

    from jax.sharding import NamedSharding

    n = len(arr)
    d = mesh.shape[DATA_AXIS]
    t_total = max(1, -(-n // tile_elems))
    t_loc = -(-t_total // d)
    padded = d * t_loc * tile_elems
    if padded != n:
        arr = np.pad(arr, (0, padded - n))
    dev = jax.device_put(arr, NamedSharding(mesh, P(DATA_AXIS)))
    return dev, t_total


def _sharded_counts_fn(mesh: Mesh, pairs, length: int, tile_elems: int):
    """Jitted SPMD phase-1 prefilter: each device counts matches per tile in
    its shard, with a one-neighbor ``ppermute`` halo of one tile from the
    right neighbor (the collective analog of the reference's overlapping
    block reads, ``search_engine.cpp:223-252``)."""
    import jax

    from ..ops.scan_jnp import _count_body

    n_dev = mesh.shape[DATA_AXIS]
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_counts(d_local, valid_local, expected):
        # d_local: [T_loc * tile_elems]; valid_local: [1] int32 (the number
        # of valid elements relative to this shard's base, pre-clipped on
        # host so int32 never overflows on huge corpora)
        halo = jax.lax.ppermute(d_local[:tile_elems], DATA_AXIS, perm)
        ext = jnp.concatenate([d_local, halo])
        counts = _count_body(
            ext, valid_local[0], expected, pairs, length, tile_elems
        )
        return counts[None]

    mapped = jax.shard_map(
        local_counts,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _cached_counts_fn(mesh, pairs, length, tile_elems):
    return _sharded_counts_fn(mesh, pairs, length, tile_elems)


def sharded_tile_counts(
    pat: CompiledPattern,
    data,
    mesh: Mesh,
    valid_count: int,
    tile_elems: int,
) -> np.ndarray:
    """Phase 1 across a mesh: int32[T] per-tile prefilter match counts for
    the whole corpus in ONE collective dispatch.

    ``data`` is either a host element array (placed sharded on first use) or
    a device array already produced by :func:`shard_grid`.  Same count
    contract as ``dense.tile_counts``; exact offsets are recovered on host
    from the hot tiles only.
    """
    import jax

    if isinstance(data, np.ndarray):
        dev, t_total = shard_grid(
            np.ascontiguousarray(data, dtype=pat.dtype), mesh, tile_elems
        )
    else:
        dev, t_total = data, max(1, -(-valid_count // tile_elems))
    d = mesh.shape[DATA_AXIS]
    shard = dev.shape[0] // d

    from ..ops.scan_jnp import prefilter_checks
    from jax.sharding import NamedSharding

    bases = np.arange(d, dtype=np.int64) * shard
    if shard + tile_elems >= 2**31:
        raise ValueError(
            "per-device shard exceeds 2^31 elements (int32 valid encoding "
            "would wrap and undercount); use smaller chunks"
        )
    valid_local = np.clip(
        valid_count - bases, 0, shard + tile_elems
    ).astype(np.int32)
    valid_dev = jax.device_put(
        valid_local, NamedSharding(mesh, P(DATA_AXIS))
    )
    pairs, exp_sel = prefilter_checks(pat)
    fn = _cached_counts_fn(mesh, pairs, pat.length, tile_elems)
    counts = fn(dev, valid_dev, jnp.asarray(exp_sel))
    return np.asarray(counts).reshape(-1)[:t_total]


# ---------------------------------------------------------------------------
# Fused multi-device step: the PRODUCTION scan (device prefilter + on-device
# exact phase 2 + O(matches) D2H) under shard_map — each device runs the
# same fused body the single-device path uses (``dense.fused_count_extract``),
# with a one-neighbor ``ppermute`` halo of one count tile.  This is the
# multi-device analog of the reference's claim that block parallelism is
# *the* scaling story (``src/core/search_engine.cpp:82-175``).


@functools.lru_cache(maxsize=64)
def _sharded_fused_fn(
    mesh, *, pairs, length, tile_elems, k_cap, p_cap, signed_compare,
    pairs_exact,
):
    import jax

    from ..ops.scan_jnp import fused_body_xla

    n_dev = mesh.shape[DATA_AXIS]
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    span_elems = tile_elems + length - 1

    def local_step(d_local, valid2, vtvr2, expected, exp_exact, rec):
        halo = jax.lax.ppermute(d_local[:tile_elems], DATA_AXIS, perm)
        ext = jnp.concatenate([d_local, halo])
        counts, combo = fused_body_xla(
            ext, valid2[0, 0], expected, vtvr2[0], exp_exact, rec,
            pairs=pairs, length=length, tile_elems=tile_elems,
            k_cap=k_cap, span=span_elems, p_cap=p_cap,
            signed_compare=signed_compare, pairs_exact=pairs_exact,
        )
        return counts[None], combo[None]

    mapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(), P(), P(),
        ),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_step_operands(
    pat: CompiledPattern,
    valid_count: int,
    t_loc: int,
    tile_elems: int,
    d: int,
):
    """Host-side per-device boundary/expected operands for the sharded
    fused step: ``(valid2, vtvr2, expected_in)``.

    ``valid2`` carries the per-device valid element count the scan body
    masks on; ``vtvr2`` the phase-2 [valid-tiles, remainder] pairs.  Shared
    by the chunked path (:func:`sharded_fused_step`) and the resident-corpus
    path, which memoizes the device copies per (pattern, geometry).
    """
    from ..dense import MAX_DEVICE_ELEMS, _prefilter_sel

    _, exp_sel, _ = _prefilter_sel(pat)
    e_loc = t_loc * tile_elems
    bases = np.arange(d, dtype=np.int64) * e_loc
    # per-device valid counts / boundary encodings (int32-safe clipping)
    valid_loc = np.clip(valid_count - bases, 0, e_loc + tile_elems)
    vtvr2 = np.stack(
        [valid_loc // tile_elems, valid_loc % tile_elems], axis=1
    ).astype(np.int32)
    # the body masks windows with a flat int32 element count — shards past
    # 2^31 elements would WRAP and silently mask valid windows (false
    # negatives); callers keep shards under the bound (the engine falls
    # back to the chunked path)
    if e_loc + tile_elems >= MAX_DEVICE_ELEMS:
        raise ValueError(
            "per-device shard reaches 2^31 elements; use smaller chunks"
        )
    valid2 = valid_loc.astype(np.int32)[:, None]
    return valid2, vtvr2, jnp.asarray(exp_sel)


class ShardedPending(NamedTuple):
    """An in-flight collective fused step: the sharded device result
    buffers plus the geometry :func:`sharded_fused_step_finish` needs to
    fetch and decode them (mesh twin of ``dense.FusedPending``)."""

    counts_dev: object
    combos_dev: object
    d: int
    t_loc: int
    t_total: int
    k_cap: int
    p_cap: int
    tile_elems: int
    grid_offset: int


def sharded_fused_step(
    pat: CompiledPattern,
    arr: np.ndarray,
    mesh: Mesh,
    valid_count: int,
    tile_elems: int,
    k_cap: int | None = None,
    p_cap: int = 1024,
    grid_offset: int = 0,
):
    """Fused phases 1 + 2 of one chunk across a device mesh in ONE
    collective dispatch: per-device prefilter counts, ppermute tile halo,
    on-device
    hot-tile gather + EXACT phase 2, one small per-device result buffer
    D2H.  The multi-device twin of ``dense.fused_count_extract``.

    Returns ``(offsets, values, info, overflow_counts)``.  When any
    device overflows ``k_cap`` hot tiles or ``p_cap`` candidates,
    ``overflow_counts`` is the global int32[T] count array (offsets/values
    empty) and the caller runs host extraction — mirroring the
    single-device fallback contract.
    """
    return sharded_fused_step_finish(
        sharded_fused_step_start(
            pat, arr, mesh, valid_count, tile_elems, k_cap=k_cap,
            p_cap=p_cap, grid_offset=grid_offset,
        )
    )


def sharded_fused_step_start(
    pat: CompiledPattern,
    arr: np.ndarray,
    mesh: Mesh,
    valid_count: int,
    tile_elems: int,
    k_cap: int | None = None,
    p_cap: int = 1024,
    grid_offset: int = 0,
) -> "ShardedPending":
    """Dispatch the collective fused step WITHOUT fetching the result.

    The async half of :func:`sharded_fused_step` (the mesh twin of
    ``dense.fused_count_extract_start``): JAX dispatch is asynchronous, so
    returning the sharded device buffers lets a chunked caller keep
    ``pipeline_depth`` collective steps in flight and fetch each result
    one step late — the same deferred-fetch pipelining the single-device
    paths use.
    """
    import jax

    from ..dense import _prefilter_sel, auto_k_cap
    from jax.sharding import NamedSharding

    L = pat.length
    d = mesh.shape[DATA_AXIS]
    pairs, _, _ = _prefilter_sel(pat)
    if k_cap is None:
        k_cap = auto_k_cap(pat, valid_count, tile_elems, len(pairs))

    arr = np.ascontiguousarray(arr, dtype=pat.dtype)
    t_total = max(1, -(-valid_count // tile_elems))
    t_loc = -(-t_total // d)
    total = d * t_loc * tile_elems
    if len(arr) < total:
        arr = np.pad(arr, (0, total - len(arr)))
    else:
        arr = arr[:total]

    valid2, vtvr2, expected_in = sharded_step_operands(
        pat, valid_count, t_loc, tile_elems, d
    )
    _, _, exp_exact, recovery = pattern_device_args(pat)
    pairs_exact = tuple(
        (int(c), int(p))
        for c, p in zip(pat.chk_shift_cur, pat.chk_shift_prev)
    )
    rows = NamedSharding(mesh, P(DATA_AXIS))
    fn = _sharded_fused_fn(
        mesh, pairs=pairs, length=L, tile_elems=tile_elems, k_cap=k_cap,
        p_cap=p_cap, signed_compare=pat.signed_compare,
        pairs_exact=pairs_exact,
    )
    counts_dev, combos_dev = fn(
        jax.device_put(arr, rows),
        jax.device_put(valid2, rows),
        jax.device_put(vtvr2, rows),
        expected_in,
        exp_exact,
        recovery,
    )
    return ShardedPending(
        counts_dev, combos_dev, d, t_loc, t_total, k_cap, p_cap,
        tile_elems, grid_offset,
    )


def sharded_fused_step_finish(pending: "ShardedPending"):
    """Fetch + decode an in-flight collective fused step (the blocking
    half of :func:`sharded_fused_step`)."""
    return parse_sharded_combos(
        pending.counts_dev, pending.combos_dev, pending.d, pending.t_loc,
        pending.t_total, pending.k_cap, pending.p_cap, pending.tile_elems,
        pending.grid_offset,
    )


def parse_sharded_combos(
    counts_dev, combos_dev, d, t_loc, t_total, k_cap, p_cap, tile_elems,
    grid_offset,
):
    """Decode the per-device fused result buffers (the step's single D2H
    transaction) into global offsets/values — shared by the chunked and
    resident mesh paths.  Returns ``(offsets, values, info,
    overflow_counts)`` with the same contract as
    :func:`sharded_fused_step`."""
    from ..dense import FusedInfo

    combos = np.asarray(combos_dev)  # (D, 3 + 2k + 3p)
    n_hot = combos[:, 0]
    n_cand = combos[:, 2]
    info = FusedInfo(
        int(n_hot.sum()), int(combos[:, 1].sum()),
        candidates=int(n_cand.sum()), d2h_bytes=combos.nbytes,
        per_device=tuple(int(c) for c in n_cand),
    )
    if (n_hot > k_cap).any() or (n_cand > p_cap).any():
        counts = np.asarray(counts_dev).reshape(-1)[:t_total]
        # the capped gather's per-device counts undercount on overflow —
        # not meaningful as balance evidence
        info = info._replace(
            fallback=True, d2h_bytes=info.d2h_bytes + counts.nbytes,
            per_device=None,
        )
        return (
            np.zeros(0, dtype=np.int64),
            np.zeros((0, 2), dtype=np.int64),
            info,
            counts,
        )

    from ..dense import _parse_combo

    all_offs, all_vals = [], []
    for dev in range(d):
        if int(n_cand[dev]) == 0:
            continue
        # the shared decoder with the device's global tile base folded
        # into grid_offset
        offs, vals = _parse_combo(
            combos[dev], k_cap, p_cap, tile_elems,
            grid_offset + dev * t_loc * tile_elems,
        )
        all_offs.append(offs)
        all_vals.append(vals)
    if not all_offs:
        return (
            np.zeros(0, dtype=np.int64),
            np.zeros((0, 2), dtype=np.int64),
            info,
            None,
        )
    return (
        np.concatenate(all_offs),
        np.concatenate(all_vals),
        info,
        None,
    )


def sharded_candidates(
    pat: CompiledPattern,
    data: np.ndarray,
    mesh: Mesh,
    capacity_per_shard: int = 16384,
) -> Tuple[np.ndarray, np.ndarray]:
    """All matching offsets of *data* scanned across *mesh*.

    Host-facing convenience used by the engine's multi-device path and the
    partitioning-invariance tests: pads to shard divisibility, runs the SPMD
    step, concatenates + filters per-shard buffers.
    """
    data = np.ascontiguousarray(data, dtype=pat.dtype)
    n = len(data)
    if n >= 2**31:
        raise ValueError(
            "sharded_candidates is int32-indexed (< 2^31 elements); use "
            "the engine's chunked paths for larger inputs"
        )
    if n < pat.length:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)
    d = len(mesh.devices)
    shard = -(-n // d)
    padded = shard * d
    if padded != n:
        data = np.pad(data, (0, padded - n))

    fn = _cached_fn(mesh, pat.length, pat.signed_compare, capacity_per_shard)
    sc, sp, exp, rec = pattern_device_args(pat)
    counts, offsets, values = fn(
        jnp.asarray(data), jnp.int32(n), sc, sp, exp, rec
    )
    counts = np.asarray(counts)
    if int(counts.max(initial=0)) > capacity_per_shard:
        return sharded_candidates(
            pat, data[:n], mesh, capacity_per_shard * 4
        )
    offs = np.asarray(offsets).reshape(-1)
    vals = np.asarray(values).reshape(-1, 2)
    keep = offs >= 0
    offs, vals = offs[keep].astype(np.int64), vals[keep].astype(np.int64)
    order = np.argsort(offs, kind="stable")
    return offs[order], vals[order]
