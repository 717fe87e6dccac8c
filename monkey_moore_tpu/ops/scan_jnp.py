"""Dense relative-search scan — pure-XLA path (layer L2).

The device replacement for the reference's sequential hot loops
(``src/core/monkey_moore.cpp:316-410`` and ``:425-546``): instead of a
pointer-chasing Boyer-Moore walk, every window position is evaluated
branchlessly against the compiled check tables.  The work is O(N·C) simple
elementwise ops (C = number of checks ≈ pattern length), which XLA fuses
into a memory-bandwidth-bound sweep; candidates are compacted into a
fixed-capacity offset buffer on device so the host only ever sees
O(matches) data.

Semantics per mode (see ``pattern.py``):

- SIMPLE/VALUE_SCAN: signed integer compare of adjacent diffs.
- WILDCARD: unsigned element-width wraparound compare of bridged diffs under
  a bitmask.

This module is the device scan on every backend; the host route and the
exact walkers (``scan_host.py``, ``oracle.py``) are its references.
"""

from __future__ import annotations

import functools
import threading
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..pattern import CompiledPattern

__all__ = [
    "match_bitmap",
    "compact_matches",
    "scan_chunk",
    "tile_counts_xla",
    "tile_counts_gather_xla",
    "fused_body_xla",
    "pattern_device_args",
]


def _widen_dtype(dtype) -> jnp.dtype:
    """Signed compute dtype wide enough for exact signed diffs."""
    return jnp.int16 if np.dtype(dtype) == np.uint8 else jnp.int32


_operand_cache_lock = threading.Lock()


def pattern_operand_cache(pat) -> dict:
    """Per-pattern memo for small DEVICE operand arrays (check tables,
    splatted expected words, valid-limit encodings).

    Every host→device transfer is a separate copy; rebuilding these
    KB-sized arrays per step made the fused scan pay several uploads per
    dispatch.  Searches reuse one CompiledPattern across chunks/steps, so
    the device copies are built once and live on the pattern object.

    Thread-safety: create/size-clear run under a lock so concurrent
    AsyncSearch/MultiSearcher threads cannot race a clear against an
    insert (worst case without it was benign recompute, but the lock is
    cheap).  Single-backend assumption: cached buffers are pinned to the
    JAX backend active at first use; a process that re-initializes its
    platform must discard patterns (``compile_pattern`` memo) first.
    """
    with _operand_cache_lock:
        cache = getattr(pat, "_device_operands", None)
        if cache is None:
            cache = {}
            object.__setattr__(pat, "_device_operands", cache)
        elif len(cache) > 64:
            # patterns are memoized process-long (compile_pattern); bound
            # the per-pattern device-operand entries (keyed by chunk
            # geometry) so many distinct file/chunk sizes can't pin
            # buffers without limit.  The geometry-INDEPENDENT check-table
            # uploads ('args') survive the eviction — dropping them would
            # re-upload them on the very next step.
            keep = {k: v for k, v in cache.items() if k == "args"}
            cache.clear()
            cache.update(keep)
    return cache


def pattern_device_args(pat: CompiledPattern) -> Tuple[jnp.ndarray, ...]:
    """Device-array form of the dense check tables + recovery shifts.

    Returned as plain arrays (not static) so that jit caches key only on
    :meth:`CompiledPattern.kernel_key` — searching a different same-length
    keyword reuses the compiled executable.  Memoized per pattern
    (:func:`pattern_operand_cache`) so repeat steps reuse the device
    copies instead of re-uploading.
    """
    from .recover import recovery_shifts

    cache = pattern_operand_cache(pat)
    if "args" in cache:
        return cache["args"]

    if pat.signed_compare:
        expected = jnp.asarray(pat.chk_expected, dtype=_widen_dtype(pat.dtype))
    else:
        expected = jnp.asarray(pat.chk_expected, dtype=pat.dtype)
    shifts = recovery_shifts(pat)
    # Always pass two recovery shifts (second may duplicate the first) so the
    # traced shape is mode-independent.
    s0 = shifts[0]
    s1 = shifts[1] if len(shifts) > 1 else shifts[0]
    cache["args"] = (
        jnp.asarray(pat.chk_shift_cur, dtype=jnp.int32),
        jnp.asarray(pat.chk_shift_prev, dtype=jnp.int32),
        expected,
        jnp.asarray([s0, s1], dtype=jnp.int32),
    )
    return cache["args"]


def match_bitmap(
    data: jnp.ndarray,
    valid_count: jnp.ndarray,
    length: int,
    shift_cur: jnp.ndarray,
    shift_prev: jnp.ndarray,
    expected: jnp.ndarray,
    signed_compare: bool,
) -> jnp.ndarray:
    """Boolean match flag for every window start in ``[0, N - L]``.

    ``data``: 1-D element array (u8/u16), padded to a static size N.
    ``valid_count``: actual number of valid elements (<= N); windows that
    would read past it are masked off.

    The check tables are *traced* values but their length C and the pattern
    length L are static, so the C shifted compares unroll at trace time into
    a fused elementwise sweep.
    """
    n = data.shape[0]
    num_checks = expected.shape[0]
    positions = n - length + 1
    if positions <= 0:
        return jnp.zeros((0,), dtype=bool)

    if signed_compare:
        wide = data.astype(_widen_dtype(data.dtype))
        # Adjacent-diff special case: shift_cur = 1..L-1, shift_prev = cur-1.
        d1 = wide[1:] - wide[:-1]  # length n-1
        ok = jnp.ones((positions,), dtype=bool)
        for c in range(num_checks):
            # diff at window position chk_cur = d1[p + chk_cur - 1]; for the
            # simple mode chk_cur == c+1.
            ok = ok & (
                jax.lax.dynamic_slice_in_dim(d1, c, positions) == expected[c]
            )
    else:
        ok = jnp.ones((positions,), dtype=bool)
        for c in range(num_checks):
            # Shifts are static per pattern *shape* but traced values — use
            # dynamic_slice with traced starts so same-shape keywords share
            # one compiled executable.
            cur = jax.lax.dynamic_slice_in_dim(data, shift_cur[c], positions)
            prev = jax.lax.dynamic_slice_in_dim(data, shift_prev[c], positions)
            ok = ok & ((cur - prev) == expected[c])

    # Mask off windows that extend past the valid element count.
    idx = jnp.arange(positions, dtype=jnp.int32)
    ok = ok & (idx <= valid_count - length)
    return ok


def compact_matches(
    bitmap: jnp.ndarray, capacity: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-capacity compaction: (count, offsets[capacity], fill = -1).

    SPMD-friendly replacement for the reference's ``std::vector`` result
    accumulation (``monkey_moore.cpp:395-396``): the true count is returned
    so callers can detect capacity overflow and retry.
    """
    count = jnp.sum(bitmap, dtype=jnp.int32)
    idx = nonzero_capped(bitmap, capacity)
    # preserve the documented fill = -1 (nonzero_capped pads with
    # unspecified duplicate indices)
    pos = jnp.arange(capacity, dtype=jnp.int32)
    offsets = jnp.where(pos < count, idx, -1)
    return count, offsets


def prefilter_expected(pat) -> np.ndarray:
    """Expected diffs wrapped to the element dtype for the device prefilter.

    The device phase may overcount (mod-2^width compare admits diffs that
    differ from the expected signed value by exactly 2^width); the host
    extraction phase applies exact semantics, so prefilter counts only need
    to never *under*count.  Dropping the signed comparison removes the
    int16/int32 widening from the hot graph — pure element-width work.
    """
    return np.asarray(
        pat.chk_expected.astype(np.int64).astype(pat.dtype)
    )


def prefilter_cap(dtype) -> int:
    """Default number of checks the device prefilter evaluates (see
    :func:`prefilter_checks`); ``MMTPU_PREFILTER_CHECKS`` overrides
    (0 = evaluate every check)."""
    import os

    env = os.environ.get("MMTPU_PREFILTER_CHECKS")
    if env is not None:
        v = int(env)
        return v if v > 0 else 1 << 30
    return 4 if np.dtype(dtype).itemsize == 1 else 2


def prefilter_checks(pat, cap: int | None = None):
    """Check subset the device prefilter evaluates: ``(pairs, expected)``.

    Any subset of a pattern's checks is a valid prefilter — phase 1 may
    overcount but never undercounts, and host extraction re-applies every
    check exactly — so at most ``cap`` checks run on device, making kernel
    compute O(cap) instead of O(keyword length).  The default cap (4 for
    8-bit, 2 for 16-bit elements) keeps random-data false positives
    negligible: FP rate per window is ~(2^-width)^cap → ~2 spurious 64 KiB
    hot tiles per 8 GiB scanned at u8/cap=4, while every true match always
    passes.  Selection prefers checks with nonzero expected diffs (zero
    diffs also match the zero-filled runs that dominate real ROM images);
    the selected checks keep their original order so adjacent-pair
    (simple-mode) structure survives.
    """
    keep = prefilter_check_indices(pat, cap)
    cur = pat.chk_shift_cur[keep]
    prev = pat.chk_shift_prev[keep]
    exp = prefilter_expected(pat)[keep]
    pairs = tuple((int(c), int(p)) for c, p in zip(cur, prev))
    return pairs, exp


def prefilter_check_indices(pat, cap: int | None = None) -> np.ndarray:
    """Indices (ascending) of the checks :func:`prefilter_checks` selects."""
    exp = prefilter_expected(pat)
    if cap is None:
        cap = prefilter_cap(pat.dtype)
    n = len(exp)
    if n <= cap:
        return np.arange(n)
    order = sorted(range(n), key=lambda i: (exp[i] == 0, i))
    return np.asarray(sorted(order[:cap]))


@functools.partial(
    jax.jit,
    static_argnames=("pairs", "length", "tile_elems"),
)
def tile_counts_xla(
    data: jnp.ndarray,
    valid_count: jnp.ndarray,
    expected_ty: jnp.ndarray,
    *,
    pairs: tuple,
    length: int,
    tile_elems: int,
) -> jnp.ndarray:
    """Per-tile prefilter match counts (phase 1 of the two-phase scan).

    Contract: ``data`` holds
    ``(T+1) * tile_elems`` elements — T counted tiles plus one trailing tile
    of halo/padding, so every counted window reads inside the array.  Returns
    int32[T]; only these counts cross the device boundary — exact offsets are
    recovered on host from the hot tiles (``scan_np.py``).

    ``pairs`` are static (window-relative shift pairs), so slice starts are
    compile-time constants; ``expected_ty`` stays traced so same-shape
    keywords share the executable.  Comparison is unsigned mod-2^width (see
    :func:`prefilter_expected`).
    """
    return _count_body(
        data, valid_count, expected_ty, pairs, length, tile_elems
    )


def _count_body(
    data, valid_count, expected_ty, pairs, length, tile_elems, active=None
):
    """Shared prefilter count body.  ``active`` (traced bool[C], optional)
    disables padded checks: inactive checks are forced true, letting callers
    pad check tables to a canonical shape for executable sharing."""
    counted = data.shape[0] - tile_elems
    adjacent = bool(pairs) and all(c == p + 1 for c, p in pairs)
    ok = None
    if adjacent:
        d1 = data[1:] - data[:-1]
        for i, (c, _) in enumerate(pairs):
            eq = (
                jax.lax.slice_in_dim(d1, c - 1, c - 1 + counted)
                == expected_ty[i]
            )
            if active is not None:
                eq = eq | ~active[i]
            ok = eq if ok is None else ok & eq
    else:
        for i, (c, p) in enumerate(pairs):
            cur = jax.lax.slice_in_dim(data, c, c + counted)
            prev = jax.lax.slice_in_dim(data, p, p + counted)
            eq = (cur - prev) == expected_ty[i]
            if active is not None:
                eq = eq | ~active[i]
            ok = eq if ok is None else ok & eq
    if ok is None:
        ok = jnp.ones((counted,), dtype=bool)
    idx = jnp.arange(counted, dtype=jnp.int32)
    ok = ok & (idx <= valid_count - length)
    return jnp.sum(ok.astype(jnp.int32).reshape(-1, tile_elems), axis=1)


def nonzero_capped(flat: jnp.ndarray, cap: int, blk: int = 128) -> jnp.ndarray:
    """First ``cap`` indices where ``flat != 0`` (ascending, 0-filled) —
    ``jnp.nonzero(size=cap)`` semantics at a fraction of its cost.

    XLA lowers full-array ``nonzero`` to a cumsum + scatter over EVERY
    element; over the fused step's ``k_cap × tile_elems`` phase-2 bitmap
    that dominated the whole dispatch.  Two-level compaction instead: one
    block-any reduce
    pass, ``nonzero`` over the N/blk block flags, gather the ≤cap hot
    blocks, ``nonzero`` over the (cap, blk) sub-array — total nonzero
    input is ``N/blk + cap*blk`` elements instead of N.

    Contract matches the capped-buffer design everywhere in this module:
    the first ``count_nonzero(flat)`` entries are exact (ascending) as
    long as that count is ≤ cap; entries past it are unspecified
    (duplicates of early blocks, not necessarily 0), and callers detect
    overflow via the separately-computed true count.
    """
    n = flat.shape[0]
    if n <= cap * blk:  # small inputs: plain nonzero is already cheap
        return jnp.nonzero(flat, size=cap, fill_value=0)[0].astype(jnp.int32)
    pad = (-n) % blk
    if pad:
        flat = jnp.concatenate(
            [flat, jnp.zeros((pad,), dtype=flat.dtype)]
        )
    g = flat.reshape(-1, blk)
    coarse = jnp.any(g != 0, axis=1)
    bidx = jnp.nonzero(coarse, size=cap, fill_value=0)[0].astype(jnp.int32)
    sub = g[bidx] != 0  # (cap, blk); fill rows may duplicate block 0
    sidx = jnp.nonzero(
        sub.reshape(-1), size=cap, fill_value=0
    )[0].astype(jnp.int32)
    return bidx[sidx // jnp.int32(blk)] * jnp.int32(blk) + sidx % jnp.int32(
        blk
    )


def exact_phase2(
    slots: jnp.ndarray,
    hot: jnp.ndarray,
    nhot: jnp.ndarray,
    vt2: jnp.ndarray,
    vr2: jnp.ndarray,
    *,
    tile_elems: int,
    length: int,
    pairs_exact: tuple,
    expected: jnp.ndarray,
    signed_compare: bool,
    recovery: jnp.ndarray,
    p_cap: int,
):
    """Device-side EXACT phase 2 over gathered hot-tile slots.

    ``slots`` is ``(K, span)`` element-dtype data, slot i covering tile
    ``hot[i]``'s ``tile_elems + L - 1`` elements; ``vt2/vr2`` encode the
    valid element count as ``vt2 * tile_elems + vr2`` (int32-safe past 2^31
    elements).  Runs the FULL exact check tables (same semantics as
    :func:`match_bitmap` / ``scan_np.match_positions_np``: every check,
    signed where the mode requires; NOT the capped mod-2^width prefilter)
    on every slot, so prefilter false positives die on device and only
    true candidates cross to the host.  ``pairs_exact`` is static so every
    check is a fused static slice + compare over the (K, positions) block
    rather than a slower vmapped dynamic-start slice (traced shifts).
    Returns ``(n_cand, flat_idx[p_cap],
    v0[p_cap], v1[p_cap])`` where ``flat_idx = slot * tile_elems + rel``
    ascending (slot-major) and v0/v1 are the recovery values.

    Slots past ``nhot`` duplicate tile 0 (nonzero padding); their valid
    count is forced to 0 so they contribute no candidates.
    """
    K, span = slots.shape
    positions = span - length + 1  # == tile_elems by construction
    dt = jnp.clip(vt2 - hot, -1, 2)
    valid_slot = jnp.clip(dt * jnp.int32(tile_elems) + vr2, 0, span)
    valid_slot = jnp.where(
        jnp.arange(K, dtype=jnp.int32) < nhot, valid_slot, 0
    )
    cmp = (
        slots.astype(_widen_dtype(slots.dtype))
        if signed_compare
        else slots
    )
    ok = None
    for i, (c, p) in enumerate(pairs_exact):
        eq = (
            jax.lax.slice_in_dim(cmp, c, c + positions, axis=1)
            - jax.lax.slice_in_dim(cmp, p, p + positions, axis=1)
        ) == expected[i]
        ok = eq if ok is None else ok & eq
    if ok is None:
        ok = jnp.ones((K, positions), dtype=bool)
    pos_idx = jnp.arange(positions, dtype=jnp.int32)[None, :]
    bitmap = ok & (pos_idx <= valid_slot[:, None] - length)
    flat = bitmap.reshape(-1)
    n_cand = jnp.sum(flat, dtype=jnp.int32)
    idx = nonzero_capped(flat, p_cap)
    slot = idx // jnp.int32(positions)
    rel = idx % jnp.int32(positions)
    lim = jnp.maximum(valid_slot[slot] - 1, 0)
    v0 = slots[slot, jnp.clip(rel + recovery[0], 0, lim)].astype(jnp.int32)
    v1 = slots[slot, jnp.clip(rel + recovery[1], 0, lim)].astype(jnp.int32)
    return n_cand, idx, v0, v1


def fused_body_xla(
    data: jnp.ndarray,
    valid_count: jnp.ndarray,
    expected_ty: jnp.ndarray,
    vtvr: jnp.ndarray,
    expected_exact: jnp.ndarray,
    recovery: jnp.ndarray,
    *,
    pairs: tuple,
    length: int,
    tile_elems: int,
    k_cap: int,
    span: int,
    p_cap: int,
    signed_compare: bool,
    pairs_exact: tuple,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused :func:`tile_counts_xla` + hot-tile gather + on-device EXACT
    extraction (:func:`exact_phase2`); returns ``(counts, combo)``
    where combo = ``[n_hot, total, n_cand, hot_ids[k], hot_counts[k],
    flat_idx[p], v0[p], v1[p]]`` as int32, the step's single D2H buffer.

    Plain traced body (no jit wrapper) so it can also serve as the
    per-device step of the multi-device ``shard_map`` scan
    (``parallel/sharded.py``); the single-device entry point is
    :func:`tile_counts_gather_xla`.

    Element-index gather: requires ``data.shape[0] < 2**31`` (the callers
    in ``dense.py`` and ``parallel/sharded.py`` refuse larger arrays; the
    engine scans bigger corpora in chunks).
    """
    counts = _count_body(
        data, valid_count, expected_ty, pairs, length, tile_elems
    )
    hot = nonzero_capped(counts, k_cap)
    nhot = jnp.sum((counts > 0).astype(jnp.int32))
    # gather whole tiles (2 per slot: tile + halo) with vmapped dynamic
    # slices: O(k_cap) temporary memory.  Slices never read out of bounds:
    # hot <= T-1 and data holds T+1 tiles.
    slots = jax.vmap(
        lambda h: jax.lax.dynamic_slice(
            data, (h * jnp.int32(tile_elems),), (2 * tile_elems,)
        )
    )(hot)[:, :span]
    n_cand, flat_idx, v0, v1 = exact_phase2(
        slots, hot, nhot, vtvr[0], vtvr[1],
        tile_elems=tile_elems, length=length, pairs_exact=pairs_exact,
        expected=expected_exact, signed_compare=signed_compare,
        recovery=recovery, p_cap=p_cap,
    )
    combo = jnp.concatenate(
        [
            jnp.stack([nhot, jnp.sum(counts), n_cand]),
            hot,
            counts[hot],
            flat_idx,
            v0,
            v1,
        ]
    )
    return counts, combo


tile_counts_gather_xla = functools.partial(
    jax.jit,
    static_argnames=(
        "pairs", "length", "tile_elems", "k_cap", "span", "p_cap",
        "signed_compare", "pairs_exact",
    ),
)(fused_body_xla)


def canonical_check_tables(pats):
    """Selected prefilter checks for a batch of patterns, with simple-mode
    patterns padded to a canonical shape: identical static pairs + traced
    active masks mean every batch of K plain keywords shares one compiled
    executable regardless of the keywords or their lengths.

    Canonicalizable = the check table is dense from zero (check j uses
    pair (j+1, j)).  Adjacency alone is NOT enough: a leading-wildcard
    keyword like "?bcde" compiles to adjacent checks starting at (2, 1),
    and remapping those onto the canonical table would test windows
    shifted by the leading-wildcard count.

    Returns ``(pair_sets, exp_list, active_list)`` — static pair tuples,
    element-dtype expected arrays, and bool active masks, one per pattern.
    Used by the multi-count path (``tile_counts_multi_xla``).
    """
    sel_idx = [prefilter_check_indices(pat) for pat in pats]
    full_exp = [prefilter_expected(pat) for pat in pats]
    full_simple = [
        len(pat.chk_shift_cur) > 0
        and all(
            int(c) == j + 1 and int(p) == j
            for j, (c, p) in enumerate(
                zip(pat.chk_shift_cur, pat.chk_shift_prev)
            )
        )
        for pat in pats
    ]
    # canonical width: smallest pow2 (>=4) covering every simple pattern's
    # highest selected check position, so batches with any mix of short
    # keywords land on the same executable
    c_max = max(
        (
            int(idx[-1]) + 1
            for idx, is_s in zip(sel_idx, full_simple)
            if is_s and len(idx)
        ),
        default=0,
    )
    if c_max:
        c_max = max(4, 1 << (c_max - 1).bit_length())
    raw_pairs, raw_exp, raw_active = [], [], []
    for pat, idx, fexp, is_s in zip(pats, sel_idx, full_exp, full_simple):
        if is_s:
            exp = np.zeros(c_max, dtype=fexp.dtype)
            act = np.zeros(c_max, dtype=bool)
            exp[idx] = fexp[idx]
            act[idx] = True
            raw_pairs.append(tuple((k + 1, k) for k in range(c_max)))
            raw_exp.append(exp)
            raw_active.append(act)
        else:
            raw_pairs.append(
                tuple(
                    (int(pat.chk_shift_cur[j]), int(pat.chk_shift_prev[j]))
                    for j in idx
                )
            )
            raw_exp.append(fexp[idx])
            raw_active.append(np.ones(len(idx), dtype=bool))
    return tuple(raw_pairs), raw_exp, raw_active


@functools.partial(
    jax.jit,
    static_argnames=("pair_sets", "tile_elems"),
)
def tile_counts_multi_xla(
    data: jnp.ndarray,
    valid_count: jnp.ndarray,
    expected_list: tuple,
    active_list: tuple,
    lengths: jnp.ndarray,
    *,
    pair_sets: tuple,
    tile_elems: int,
):
    """Per-tile prefilter counts for MANY patterns in ONE dispatch.

    The corpus is read from device memory once per pattern inside a single
    executable — amortizing the per-dispatch overhead across keywords, the
    core of the interactive multi-keyword workflow (``multi.MultiSearcher``).  Returns a
    tuple of int32[T] arrays, one per pattern.

    ``lengths`` (int32[K]) and the per-check ``active`` masks are traced;
    callers pad simple-mode check tables to a canonical adjacent-pair shape,
    so every batch of K plain keywords shares one compiled executable
    regardless of the keywords or their lengths.
    """
    return tuple(
        _count_body(
            data, valid_count, exp, pairs, lengths[i], tile_elems, act
        )
        for i, (pairs, exp, act) in enumerate(
            zip(pair_sets, expected_list, active_list)
        )
    )


@functools.partial(
    jax.jit,
    static_argnames=("length", "signed_compare", "capacity"),
)
def scan_chunk(
    data: jnp.ndarray,
    valid_count: jnp.ndarray,
    shift_cur: jnp.ndarray,
    shift_prev: jnp.ndarray,
    expected: jnp.ndarray,
    recovery: jnp.ndarray,
    *,
    length: int,
    signed_compare: bool,
    capacity: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One-dispatch dense scan of a device chunk.

    Returns ``(count, offsets[capacity], recovery_values[capacity, 2])``:
    element offsets of every match (ALL semantics — suppression happens on
    host over the sparse candidate list) and the data values needed for
    equivalency-map recovery (``ops/recover.py``), gathered on device.
    """
    bitmap = match_bitmap(
        data, valid_count, length, shift_cur, shift_prev, expected,
        signed_compare,
    )
    count, offsets = compact_matches(bitmap, capacity)
    safe = jnp.maximum(offsets, 0)
    n = data.shape[0]
    gather_idx = jnp.clip(safe[:, None] + recovery[None, :], 0, n - 1)
    values = data[gather_idx]  # [capacity, 2]
    return count, offsets, values
