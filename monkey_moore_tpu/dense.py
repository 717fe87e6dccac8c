"""Single-device dense search (layer L2 public surface).

``dense_search`` is the device-path equivalent of ``MonkeyMoore<Ty>::search``
(``src/core/monkey_moore.cpp:41-49``): in-memory element array in, list of
(offset, equivalency_map) out.

The production scan is **two-phase**, fused into one device dispatch
(:func:`fused_count_extract`):

1. *Count* — per-tile prefilter match counts, one sweep over the corpus
   (``ops/scan_jnp.py``, compiled by XLA).
2. *Extract* — the hot tiles are gathered on device and re-checked with the
   full exact check tables; only exact candidate offsets and their recovery
   values cross to the host.

This replaces on-device offset compaction (``jnp.nonzero``) over the whole
chunk, whose scatter graph both compiles and runs far slower than the scan
itself at large chunk sizes.

Arrays handed to the device paths must hold fewer than ``2**31`` elements:
the XLA body indexes elements with int32 (:data:`MAX_DEVICE_ELEMS`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from .config import MatchSemantics
from .ops.recover import recover_from_values, recovery_shifts
from .ops.scan_np import match_positions_np
from .ops.suppress import greedy_suppress
from .oracle import oracle_search
from .pattern import CompiledPattern

__all__ = [
    "dense_search",
    "dense_candidates",
    "two_phase_candidates",
    "tile_counts",
    "fused_count_extract",
    "fused_count_extract_start",
    "fused_count_extract_finish",
    "FusedPending",
    "auto_k_cap",
    "FusedInfo",
    "extract_hot_tiles",
    "extract_hot_tiles_device",
    "TILE_ELEMS",
    "MAX_DEVICE_ELEMS",
]

Result = Tuple[int, Dict[int, int]]

#: elements per counted tile (256 KiB of 8-bit data)
TILE_ELEMS = 262144

#: exclusive bound on the element count of one device array: the XLA body's
#: position and slice indices are int32, so a larger array would wrap them
#: and silently drop matches
MAX_DEVICE_ELEMS = 2**31


def _check_device_elems(arr_device, valid_count: int) -> None:
    """Refuse arrays the int32-indexed XLA body would wrap on."""
    n = int(np.prod(arr_device.shape))
    if n >= MAX_DEVICE_ELEMS or valid_count >= MAX_DEVICE_ELEMS:
        raise ValueError(
            f"device array of {n} elements (valid {valid_count}) reaches "
            f"2**31; the int32-indexed scan would wrap — scan it in chunks "
            f"(SearchConfig.device_chunk_bytes)"
        )


def _prefilter_sel(pat):
    """Selected prefilter checks + the max window shift among them."""
    from .ops.scan_jnp import prefilter_checks

    pairs, exp = prefilter_checks(pat)
    return pairs, exp, max((c for c, _ in pairs), default=0)


def tile_counts(
    pat: CompiledPattern,
    arr_device,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
) -> np.ndarray:
    """Phase 1: int32[T] match counts per tile.

    ``arr_device`` is a device (or host) element array of ``(T+1)*tile_elems``
    elements — T counted tiles + one halo/padding tile.
    """
    import jax.numpy as jnp

    from .ops.scan_jnp import tile_counts_xla

    _check_device_elems(arr_device, valid_count)
    pairs, exp_sel, _ = _prefilter_sel(pat)
    counts = tile_counts_xla(
        arr_device,
        jnp.int32(valid_count),
        jnp.asarray(exp_sel),
        pairs=pairs,
        length=pat.length,
        tile_elems=tile_elems,
    )
    return np.asarray(counts)


_EMPTY = (
    np.zeros(0, dtype=np.int64),
    np.zeros((0, 2), dtype=np.int64),
)

def auto_k_cap(
    pat: CompiledPattern, valid_count: int, tile_elems: int, n_pairs: int
) -> int:
    """Hot-tile gather capacity for the fused step.

    Sized from the expected prefilter-FP positions on random data with 2x +
    slack headroom (hot tiles <= positions); the gather stays device-side,
    so a large cap costs HBM reads, not D2H bytes.  Additionally bounded by
    a slot-bytes budget (the fused step materializes ``k_cap`` slots of
    ``2 * tile_elems`` elements; 64 MiB — without the bound, large count
    tiles + a high-FP pattern drove a ~1 GiB device gather per chunk).
    """
    bits = 8 * np.dtype(pat.dtype).itemsize
    exp_fp = valid_count * (2.0 ** (-bits * max(1, n_pairs)))
    k_cap = int(min(2048, 1 << int(2 * exp_fp + 16).bit_length()))
    slot_bytes = 2 * tile_elems * np.dtype(pat.dtype).itemsize
    budget_slots = max(8, (64 * 1024 * 1024) // slot_bytes)
    if k_cap > budget_slots:
        k_cap = 1 << (budget_slots.bit_length() - 1)
    return k_cap


def _gather_fallback_bytes(pat: CompiledPattern, n_hot: int,
                           tile_elems: int) -> int:
    """Approximate D2H bytes of :func:`extract_hot_tiles_device`'s batched
    fetch: ``n_hot`` padded to a power of two, one tile+halo span per slot
    — the dominant transfer of the degraded (overflow/all-wildcard)
    steps, so the d2h stat must include it."""
    if n_hot <= 0:
        return 0
    n_pad = 1 << (n_hot - 1).bit_length()
    span = tile_elems + pat.length - 1
    return n_pad * span * np.dtype(pat.dtype).itemsize


class FusedInfo(NamedTuple):
    """Stats sidecar of :func:`fused_count_extract` (device-computed)."""

    hot_tiles: int  #: tiles with a nonzero prefilter count
    prefilter_total: int  #: sum of prefilter counts (int32 stats field)
    candidates: int = 0  #: exact candidates extracted this step
    fallback: bool = False  #: capacity overflow → counts fetch + batched gather
    d2h_bytes: int = 0  #: bytes this step shipped device→host
    #: per-shard exact candidate counts (mesh paths only; None on the
    #: single-device paths) — the load-balance evidence the scaling harness
    #: reports
    per_device: tuple = None


class FusedPending(NamedTuple):
    """An in-flight fused step: device futures + the metadata
    :func:`fused_count_extract_finish` needs to fetch and decode them.

    JAX dispatch is asynchronous — ``counts_dev``/``combo_dev`` are device
    buffers whose computation may still be running.  Keeping ``depth``
    pendings alive overlaps step ``k+1``'s dispatch/execution with step
    ``k``'s result fetch (the engine's ``pipeline_depth`` knob).  ``eager``
    holds an already-final result for the branch that cannot pipeline (the
    all-wildcard special case).
    """

    counts_dev: object
    combo_dev: object
    pat: object
    arr_device: object
    valid_count: int
    tile_elems: int
    grid_offset: int
    k_cap: int
    p_cap: int
    eager: tuple = None


def fused_count_extract_start(
    pat: CompiledPattern,
    arr_device,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
    k_cap: int | None = None,
    p_cap: int = 1024,
) -> "FusedPending":
    """Dispatch phases 1 + 2 WITHOUT fetching the result buffer.

    The async half of :func:`fused_count_extract`: returns immediately
    after enqueueing the fused device step, so a caller can dispatch the
    next chunk before paying the device→host round trip for this one
    (:class:`FusedPending`).  ``arr_device`` is a flat element array of
    fewer than ``2**31`` elements (``ValueError`` otherwise).
    """
    import jax.numpy as jnp

    from .ops.scan_jnp import (
        pattern_device_args,
        pattern_operand_cache,
        tile_counts_gather_xla,
    )

    _check_device_elems(arr_device, valid_count)
    L = pat.length
    pairs, exp_sel, _ = _prefilter_sel(pat)
    if k_cap is None:
        k_cap = auto_k_cap(pat, valid_count, tile_elems, len(pairs))
    if not pairs:
        # all-wildcard keywords match every window — every tile is hot, so
        # fusion buys nothing; use the two-dispatch path's host special-case
        counts = tile_counts(
            pat, arr_device, valid_count, tile_elems=tile_elems
        )
        offs, vals = extract_hot_tiles_device(
            pat, arr_device, counts, valid_count, tile_elems, grid_offset
        )
        info = FusedInfo(
            int((counts > 0).sum()), int(counts.sum()),
            candidates=len(offs), fallback=True,
            d2h_bytes=counts.nbytes + _gather_fallback_bytes(
                pat, int((counts > 0).sum()), tile_elems
            ),
        )
        return FusedPending(
            None, None, pat, arr_device, valid_count, tile_elems,
            grid_offset, k_cap, p_cap, eager=(offs, vals, info),
        )

    _, _, exp_exact, recovery = pattern_device_args(pat)
    # memoized device copies of the per-step operands: repeat steps with
    # the same pattern and geometry upload nothing
    cache = pattern_operand_cache(pat)
    okey = ("xla_step", valid_count, tile_elems)
    if okey in cache:
        exp_sel_dev, vtvr = cache[okey]
    else:
        exp_sel_dev = jnp.asarray(exp_sel)
        vtvr = jnp.asarray(
            [valid_count // tile_elems, valid_count % tile_elems],
            dtype=jnp.int32,
        )
        cache[okey] = (exp_sel_dev, vtvr)
    counts_dev, combo_dev = tile_counts_gather_xla(
        arr_device,
        jnp.int32(valid_count),
        exp_sel_dev,
        vtvr,
        exp_exact,
        recovery,
        pairs=pairs,
        length=L,
        tile_elems=tile_elems,
        k_cap=k_cap,
        span=tile_elems + L - 1,
        p_cap=p_cap,
        signed_compare=pat.signed_compare,
        pairs_exact=tuple(
            (int(c), int(p))
            for c, p in zip(pat.chk_shift_cur, pat.chk_shift_prev)
        ),
    )
    return FusedPending(
        counts_dev, combo_dev, pat, arr_device, valid_count, tile_elems,
        grid_offset, k_cap, p_cap,
    )


def fused_count_extract_finish(
    pending: "FusedPending",
) -> Tuple[np.ndarray, np.ndarray, "FusedInfo"]:
    """Fetch + decode an in-flight fused step (the blocking half)."""
    if pending.eager is not None:
        return pending.eager
    # ONE device→host transfer per step: [n_hot, total, n_cand, hot_ids,
    # hot_counts, flat_idx, v0, v1]
    combo = np.asarray(pending.combo_dev)
    k_cap, p_cap = pending.k_cap, pending.p_cap
    info = _combo_info(combo, k_cap, p_cap)
    if info.hot_tiles == 0:
        return *_EMPTY, info
    if info.fallback:
        # capacity overflow: fetch the full counts and run the batched
        # gather + host extraction (degraded mode — surfaced via
        # ``info.fallback`` so callers can log/count it)
        counts_np = np.asarray(pending.counts_dev)
        offs, vals = extract_hot_tiles_device(
            pending.pat, pending.arr_device, counts_np,
            pending.valid_count, pending.tile_elems, pending.grid_offset,
        )
        info = info._replace(
            candidates=len(offs),
            d2h_bytes=info.d2h_bytes + counts_np.nbytes
            + _gather_fallback_bytes(
                pending.pat, int((counts_np > 0).sum()),
                pending.tile_elems,
            ),
        )
        return offs, vals, info
    offsets, values = _parse_combo(
        combo, k_cap, p_cap, pending.tile_elems, pending.grid_offset
    )
    return offsets, values, info


def fused_count_extract(
    pat: CompiledPattern,
    arr_device,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
    k_cap: int | None = None,
    p_cap: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, "FusedInfo"]:
    """Phases 1 + 2 for device-resident data in ONE device dispatch.

    Returns ``(offsets, values, info)``.  The jitted step computes per-tile
    prefilter counts, gathers the first ``k_cap`` hot tiles, re-evaluates
    them with the FULL exact check tables on device (``scan_jnp.
    exact_phase2`` — prefilter false positives never reach the host), and
    packs the hot-tile header + exact candidate offsets + recovery values
    into one int32 buffer: the step's single D2H transfer.  This removes
    the separate extraction dispatch, the counts-array transfer, and any
    per-hot-tile data transfer relative to ``tile_counts`` +
    :func:`extract_hot_tiles_device`.  ``k_cap`` auto-sizes from the
    expected prefilter false-positive rate (capped checks admit ~2^-8c of
    random windows); overflowing ``k_cap`` tiles or ``p_cap`` candidates
    falls back to the batched path (one extra dispatch — rare).

    The device replacement for the reference's per-thread "scan then walk
    the block again" structure (``src/core/search_engine.cpp:107-168``).
    Split into :func:`fused_count_extract_start` (async dispatch) +
    :func:`fused_count_extract_finish` (fetch) so chunked callers can
    pipeline steps (``SearchConfig.pipeline_depth``).
    """
    return fused_count_extract_finish(
        fused_count_extract_start(
            pat, arr_device, valid_count, tile_elems=tile_elems,
            grid_offset=grid_offset, k_cap=k_cap, p_cap=p_cap,
        )
    )


#: fused result-buffer layout, shared byte-for-byte by the assembler
#: (``scan_jnp.fused_body_xla``) and every decoder below + ``parallel.sharded.parse_sharded_combos``:
#: ``[n_hot, prefilter_total, n_cand, hot_ids[k_cap], hot_counts[k_cap],
#:   flat_idx[p_cap], v0[p_cap], v1[p_cap]]`` — change it in ALL places or
#: offsets silently decode from the wrong region.
COMBO_HEADER = 3


def combo_fields(combo: np.ndarray, k_cap: int, p_cap: int):
    """Decode one packed result buffer into its raw fields:
    ``(n_hot, prefilter_total, n_cand, hot_ids, flat_idx, v0, v1)``
    (candidate arrays trimmed to ``n_cand``)."""
    n_hot, total, n_cand = int(combo[0]), int(combo[1]), int(combo[2])
    hot = combo[COMBO_HEADER : COMBO_HEADER + k_cap].astype(np.int64)
    base = COMBO_HEADER + 2 * k_cap
    m = min(n_cand, p_cap)
    flat_idx = combo[base : base + p_cap][:m].astype(np.int64)
    v0 = combo[base + p_cap : base + 2 * p_cap][:m]
    v1 = combo[base + 2 * p_cap : base + 3 * p_cap][:m]
    return n_hot, total, n_cand, hot, flat_idx, v0, v1


def _combo_info(combo: np.ndarray, k_cap: int, p_cap: int) -> FusedInfo:
    n_hot, total, n_cand = int(combo[0]), int(combo[1]), int(combo[2])
    return FusedInfo(
        n_hot, total, candidates=n_cand, d2h_bytes=combo.nbytes,
        fallback=n_hot > k_cap or n_cand > p_cap,
    )


def _parse_combo(combo, k_cap, p_cap, tile_elems, grid_offset):
    """Decode one fused result buffer → (offsets, values)."""
    _, _, n_cand, hot, flat_idx, v0, v1 = combo_fields(combo, k_cap, p_cap)
    if n_cand == 0:
        return _EMPTY
    slot, rel = flat_idx // tile_elems, flat_idx % tile_elems
    offsets = hot[slot] * tile_elems + rel + grid_offset
    values = np.stack([v0, v1], axis=1).astype(np.int64)
    return offsets, values


def two_phase_candidates(
    pat: CompiledPattern,
    data: np.ndarray,
    tile_elems: int = TILE_ELEMS,
) -> Tuple[np.ndarray, np.ndarray]:
    """All matching window offsets in *data* (host element array), plus the
    recovery values [M, 2] read from the host buffer."""
    import jax.numpy as jnp

    data = np.ascontiguousarray(data, dtype=pat.dtype)
    n = len(data)
    L = pat.length
    if n < L:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)

    t_count = -(-n // tile_elems)
    arr = np.zeros((t_count + 1) * tile_elems, dtype=pat.dtype)
    arr[:n] = data
    counts = tile_counts(pat, jnp.asarray(arr), n, tile_elems=tile_elems)
    return extract_hot_tiles(pat, data, counts, tile_elems)


def extract_hot_tiles(
    pat: CompiledPattern,
    data: np.ndarray,
    counts: np.ndarray,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Phase 2: exact offsets + recovery values from tiles with count > 0.

    ``data`` is the host element buffer covering the counted region plus any
    trailing halo; ``grid_offset`` shifts reported offsets (for chunked
    scans).  Each hot tile costs one vectorized NumPy pass over
    ``tile_elems + L - 1`` elements.
    """
    n = len(data)
    L = pat.length
    shifts = recovery_shifts(pat)
    hot = np.nonzero(counts)[0]
    all_offsets = []
    for t in hot.tolist():
        s0 = t * tile_elems
        sl = data[s0 : min(n, s0 + tile_elems + L - 1)]
        pos = match_positions_np(pat, sl)
        pos = pos[pos < tile_elems] + s0
        all_offsets.append(pos)
    if not all_offsets:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)
    offsets = np.concatenate(all_offsets)
    values = np.stack(
        [
            data[np.minimum(offsets + shifts[0], n - 1)].astype(np.int64),
            data[
                np.minimum(
                    offsets + (shifts[1] if len(shifts) > 1 else shifts[0]),
                    n - 1,
                )
            ].astype(np.int64),
        ],
        axis=1,
    )
    return offsets + grid_offset, values


def extract_hot_tiles_device(
    pat: CompiledPattern,
    arr_device,
    counts: np.ndarray,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Phase 2 for device-resident corpora with no host mirror: fetch only
    the hot tiles' bytes device→host (``tile_elems + L - 1`` elements each)
    and run the exact matcher on them.

    ``arr_device`` is the same flat element array given to
    :func:`tile_counts`.
    """
    L = pat.length
    total = arr_device.size
    shifts = recovery_shifts(pat)
    hot = np.nonzero(counts)[0]
    if len(hot) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)

    # ONE batched gather for every hot tile instead of a dispatch per tile.
    # The hot count is padded to the next power of two (duplicated last
    # tile) to bound the number of distinct gather shapes the compile
    # cache must hold.
    span = tile_elems + L - 1
    starts = hot * tile_elems
    n_pad = 1 << int(len(hot) - 1).bit_length()
    starts_pad = np.concatenate(
        [starts, np.repeat(starts[-1:], n_pad - len(starts))]
    ).astype(np.int64)
    idx = np.clip(
        starts_pad[:, None] + np.arange(span)[None, :], 0, total - 1
    )
    fetched = np.asarray(arr_device[idx])

    all_offsets = []
    all_values = []
    for i, t in enumerate(hot.tolist()):
        s0 = t * tile_elems
        sl = fetched[i][: min(total, s0 + span) - s0]
        # trim device padding past the valid element count
        sl = sl[: max(0, valid_count - s0)]
        pos = match_positions_np(pat, sl)
        pos = pos[pos < tile_elems]
        if len(pos):
            v0 = sl[np.minimum(pos + shifts[0], len(sl) - 1)].astype(np.int64)
            v1 = sl[
                np.minimum(
                    pos + (shifts[1] if len(shifts) > 1 else shifts[0]),
                    len(sl) - 1,
                )
            ].astype(np.int64)
            all_offsets.append(pos + s0)
            all_values.append(np.stack([v0, v1], axis=1))
    if not all_offsets:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)
    return (
        np.concatenate(all_offsets) + grid_offset,
        np.concatenate(all_values),
    )


def dense_candidates(
    pat: CompiledPattern,
    data: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """All matching window offsets in *data*, plus recovery values [M, 2]."""
    return two_phase_candidates(pat, data)


def dense_search(
    pat: CompiledPattern,
    data: np.ndarray,
    semantics: MatchSemantics = MatchSemantics.GREEDY,
) -> List[Result]:
    """Search an in-memory element array; returns [(offset, values_map), ...].

    ``semantics`` selects ALL (every match), GREEDY (dense + advance replay,
    default), or REFERENCE (delegates to the exact sequential walker).
    """
    if pat.length < 2:
        raise ValueError("pattern length must be >= 2")
    if semantics is MatchSemantics.REFERENCE:
        return oracle_search(pat, data)

    offsets, values = two_phase_candidates(pat, data)
    if semantics is MatchSemantics.GREEDY and len(offsets) > 1:
        kept = greedy_suppress(offsets, pat.advance)
        keep_mask = np.isin(offsets, kept)
        offsets = offsets[keep_mask]
        values = values[keep_mask]

    return [
        (int(o), recover_from_values(pat, values[i]))
        for i, o in enumerate(offsets)
    ]
