"""Chunked file search engine (layer L3).

Device counterpart of ``mmoore::SearchEngine<DataType>::run``
(``src/core/search_engine.cpp:23-216``).  Where the reference partitions the
file into ~512 KiB blocks scanned by a CPU thread pool, this engine streams
large device chunks through the dense scan kernel and applies the reference's
block structure *logically*:

- **Block math parity** — blocks advance by ``preferred_search_block_size``
  bytes and read ``(pattern_len-1)*element_size`` halo bytes
  (``compute_search_blocks``, ``search_engine.cpp:218-253``).  A match is
  reported by exactly one block (its start lies in the block's base region),
  so a single global scan finds the identical match set; the block id of a
  match is just ``byte_offset // block_base_size``.
- **Alignment phases** — 16-bit searches scan both byte alignments of each
  block (``search_engine.cpp:129-141``); globally this is the even-offset and
  odd-offset element grids, with per-grid valid counts
  ``floor((file_size - a) / element_size)``.
- **Suppression grouping** — the reference's post-match advance restarts at
  each block start; candidates are therefore grouped per (block, alignment)
  and greedily suppressed per group (``ops/suppress.py``).
- **Progress / abort** — one callback per logical block with the reference's
  ``float`` accumulation (``search_engine.cpp:75-80,161-165``), abort checks
  after each callback and between chunks, empty result on abort
  (``:177-187``).
- **Previews** — byte-exact window math + equivalency decode (``preview.py``).

``MatchSemantics.REFERENCE`` runs the exact sequential walker per (block,
alignment) instead of the dense kernel (oracle or native C++ walker).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .config import (
    MatchSemantics,
    ProgressCallback,
    SearchConfig,
    SearchResult,
    SearchStep,
)
from .ops.recover import recover_from_values
from .ops.suppress import greedy_suppress
from .oracle import reference_walk
from .pattern import CompiledPattern, compile_pattern
from .preview import decode_elements, generate_preview
from .utils.logging import log

__all__ = ["SearchEngine", "compute_search_blocks"]


def compute_search_blocks(
    file_size: int, pattern_len: int, element_size: int, base_size: int
) -> List[Tuple[int, int]]:
    """(offset, size) logical blocks with halo overlap.

    Parity: ``compute_search_blocks`` (``search_engine.cpp:218-253``): blocks
    advance by ``base_size`` bytes; each reads
    ``base_size + (pattern_len-1)*element_size`` bytes clipped at EOF.
    """
    overlap = (pattern_len - 1) * element_size
    full = base_size + overlap
    num_blocks = -(-file_size // base_size) if file_size else 0
    blocks = []
    for i in range(num_blocks):
        offset = i * base_size
        size = min(full, file_size - offset)
        blocks.append((offset, size))
    return blocks


def finalize_candidates(
    pat, semantics, s, base, file_size, per_group, candidate_info
):
    """Dense candidates → final (byte_offset, values_map) list, applying the
    reference's per-(block, alignment) match semantics.

    ``per_group``: {(block_id, alignment): [element offsets]};
    ``candidate_info``: {(alignment, element offset): (byte_offset, values)}.
    """
    L = pat.length
    results = []
    suppress = semantics is MatchSemantics.GREEDY
    for (block_id, a), elems in per_group.items():
        elems = np.array(sorted(elems), dtype=np.int64)
        if suppress and s > 1:
            # Block-fit parity filter: the reference's halo is
            # ``(L-1)*element_size`` bytes (``search_engine.cpp:227``), one
            # element too short for the shifted alignment grid, so an
            # odd-aligned match whose window pokes past its owning block's
            # trimmed element count is silently missed by the reference.
            # GREEDY mode replicates that; ALL mode reports the match.
            fit = []
            for e in elems.tolist():
                byte_off, _ = candidate_info[(a, e)]
                rel = byte_off - block_id * base
                a_loc = rel % s
                j = rel // s
                size_i = min(base + (L - 1) * s, file_size - block_id * base)
                count_i = (size_i - a_loc) // s
                if j + L <= count_i:
                    fit.append(e)
            elems = np.array(fit, dtype=np.int64)
        if suppress:
            elems = greedy_suppress(elems, pat.advance)
        for e in elems.tolist():
            byte_off, val = candidate_info[(a, e)]
            results.append((byte_off, recover_from_values(pat, val)))
    return results


class _MeshInFlight(NamedTuple):
    """A collective fused step kept in flight by the chunked mesh path:
    the sharded pending buffers plus the decoded chunk retained for the
    overflow host-extraction fallback."""

    pending: object  #: parallel.sharded.ShardedPending
    arr: object  #: decoded host chunk (fallback extraction input)
    count: int  #: valid element count of this chunk


def _accumulate_mesh_stats(stats, finfo, n_dev, tile_elems, width):
    """Fold one collective dispatch's structural metrics into the run
    stats: halo volume (each device ppermutes ONE tile to its left
    neighbor per dispatch) and per-shard exact-candidate balance."""
    stats.ici_halo_bytes += n_dev * tile_elems * width
    if finfo is not None and finfo.per_device is not None:
        if stats.per_device_candidates is None:
            stats.per_device_candidates = [0] * len(finfo.per_device)
        for i, c in enumerate(finfo.per_device):
            stats.per_device_candidates[i] += c


_HOST_FILE_CACHE: dict = {}  # most recent small file's bytes (host RAM)

_HOST_POOL = [None, 0]  # lazy persistent executor: [pool, max_workers]


def _host_pool(n_threads: int):
    """Process-wide thread pool for host-path slice scans — creating an
    executor per search cost ~1-2 ms, erasing the 2-thread win at the
    8-16 MiB sweep sizes."""
    import concurrent.futures

    if _HOST_POOL[0] is None or _HOST_POOL[1] < n_threads:
        if _HOST_POOL[0] is not None:
            _HOST_POOL[0].shutdown(wait=False)  # don't leak old workers
        _HOST_POOL[0] = concurrent.futures.ThreadPoolExecutor(
            max_workers=n_threads
        )
        _HOST_POOL[1] = n_threads
    return _HOST_POOL[0]


def _host_file_bytes(path: Path, file_size: int) -> np.ndarray:
    """Bytes of a small file, cached by (path, size, mtime) — the host-side
    analog of the resident device corpus for the host latency path."""
    try:
        st = path.stat()
    except OSError:
        return np.memmap(path, dtype=np.uint8, mode="r")
    key = (str(path), st.st_size, st.st_mtime_ns)
    hit = _HOST_FILE_CACHE.get(key)
    if hit is None:
        hit = np.fromfile(path, dtype=np.uint8)
        _HOST_FILE_CACHE.clear()
        _HOST_FILE_CACHE[key] = hit
    return hit


def _normalize_abort(abort_flag) -> Callable[[], bool]:
    if abort_flag is None:
        return lambda: False
    if hasattr(abort_flag, "is_set"):
        return abort_flag.is_set
    if callable(abort_flag):
        return abort_flag
    return lambda: bool(abort_flag)


class SearchEngine:
    """Headless search engine over a file on disk.

    Usage mirror of ``SearchEngine<T>(config).run(...)``
    (``include/mmoore/search_engine.hpp:47-58``)::

        engine = SearchEngine(config)
        results = engine.run(on_progress, abort_flag, generate_previews=True)
    """

    def __init__(self, config: SearchConfig):
        self.config = config
        #: :class:`~monkey_moore_tpu.profiling.SearchStats` of the last run.
        self.last_stats = None

    # ------------------------------------------------------------------
    def compile(self) -> CompiledPattern:
        cfg = self.config
        if cfg.is_relative_search:
            return compile_pattern(
                keyword=cfg.keyword,
                wildcard=cfg.wildcard,
                char_seq=cfg.custom_char_seq,
                dtype=cfg.dtype(),
            )
        return compile_pattern(
            reference_values=list(cfg.reference_values), dtype=cfg.dtype()
        )

    # ------------------------------------------------------------------
    def run(
        self,
        on_progress: Optional[ProgressCallback] = None,
        abort_flag=None,
        generate_previews: bool = False,
        distributed: bool = False,
    ) -> List[SearchResult]:
        cfg = self.config
        progress = on_progress or (lambda pct, step: None)
        aborted = _normalize_abort(abort_flag)

        path = Path(cfg.file_path) if cfg.file_path else None
        if path is None or not path.exists():
            raise FileNotFoundError("File not found")  # ``search_engine.cpp:43-45``

        from .profiling import SearchStats, StageTimer, device_trace

        timer = StageTimer(SearchStats())
        self.last_stats = timer.stats

        progress(0, SearchStep.INITIALIZING)
        file_size = path.stat().st_size
        with timer.stage("compile_pattern"):
            pat = self.compile()
        s = cfg.element_width

        blocks = compute_search_blocks(
            file_size, pat.length, s, cfg.preferred_search_block_size
        )
        log("blocks=", len(blocks), " file_size=", file_size)

        # Multi-host: this process scans only window starts inside its base
        # byte region; candidate lists are all-gathered over DCN before the
        # (deterministic) global finalize, so every host returns the
        # identical result list — the pod-scale analog of the reference's
        # future harvesting + merge (``search_engine.cpp:83-102,193-197``).
        # The file must be readable on every host (standard pod setup).
        own_bytes = None
        gather = None
        if distributed:
            from .parallel.multihost import (
                gather_results,
                process_count,
                process_index,
            )

            n_proc = process_count()
            if n_proc > 1:
                host_base = -(-file_size // n_proc)
                own_bytes = (
                    min(process_index() * host_base, file_size),
                    min((process_index() + 1) * host_base, file_size),
                )
                gather = gather_results
                log("distributed: host ", process_index(), "/", n_proc,
                    " owns bytes ", own_bytes)

        progress(0, SearchStep.SEARCHING)

        if file_size and file_size <= cfg.host_latency_threshold_bytes:
            # files small enough for the host route keep their bytes in a
            # process cache: repeat interactive searches skip even the
            # memmap setup (~0.1 ms — measurable against a 40 µs scan)
            data = _host_file_bytes(path, file_size)
        elif file_size:
            data = np.memmap(path, dtype=np.uint8, mode="r")
        else:
            data = np.zeros(0, dtype=np.uint8)

        from .dense import TILE_ELEMS as _TILE_ELEMS

        # patterns longer than one count tile cannot ride the dense device
        # paths (chunk arrays carry exactly one halo tile; a longer window
        # would silently read padding — no-false-negatives invariant), so
        # they always scan on the host, which handles any length exactly
        huge_pattern = pat.length > _TILE_ELEMS
        use_host = (
            cfg.semantics is not MatchSemantics.REFERENCE
            and file_size > 0
            and (
                huge_pattern
                or (
                    gather is None
                    and cfg.devices is None
                    and file_size <= cfg.host_latency_threshold_bytes
                )
            )
        )
        with device_trace():
            if cfg.semantics is MatchSemantics.REFERENCE:
                raw = self._scan_reference(
                    pat, data, file_size, blocks, progress, aborted, timer,
                    own_bytes=own_bytes, gather=gather,
                )
            elif use_host:
                raw = self._scan_host(
                    pat, data, file_size, blocks, progress, aborted, timer,
                    own_bytes=own_bytes, gather=gather,
                )
            else:
                raw = self._scan_dense(
                    pat, data, file_size, blocks, progress, aborted, timer,
                    own_bytes=own_bytes, gather=gather,
                )
        if raw is None:  # aborted
            return []

        # Global sort by byte offset (``search_engine.cpp:193-197``).
        raw.sort(key=lambda r: r[0])
        results = [SearchResult(offset=o, values_map=m) for o, m in raw]
        timer.stats.results = len(results)

        progress(100, SearchStep.GENERATING_PREVIEWS)

        if generate_previews and results:
            is_ascii = len(pat.char_seq) == 0
            with timer.stage("previews"):
                for r in results:
                    r.preview = generate_preview(
                        data,
                        file_size,
                        r.offset,
                        r.values_map,
                        len(_as_seq(cfg.keyword)),
                        cfg.preferred_preview_width,
                        s,
                        cfg.endianness,
                        cfg.is_relative_search,
                        is_ascii,
                    )
        log("stats: ", timer.stats.summary())
        return results

    # ------------------------------------------------------------------
    def run_distributed(
        self,
        on_progress: Optional[ProgressCallback] = None,
        abort_flag=None,
        generate_previews: bool = False,
    ) -> List[SearchResult]:
        """Multi-host :meth:`run`: each JAX process scans its own byte range
        on its local devices and the merged global result list is returned on
        every host.  Call :func:`~monkey_moore_tpu.parallel.multihost.
        initialize_distributed` first; degrades to a plain :meth:`run` when
        ``jax.process_count() == 1``.

        ``abort_flag`` must be raised on every host (the final gather is a
        collective).
        """
        return self.run(
            on_progress, abort_flag, generate_previews, distributed=True
        )

    # ------------------------------------------------------------------
    def _element_grid(self, file_size: int, align: int) -> int:
        """Valid element count of alignment grid *align* (mirrors the
        per-block ``data_count`` trim, ``search_engine.cpp:137-141``)."""
        s = self.config.element_width
        return max(0, (file_size - align) // s)

    def _decode_grid(
        self, data: np.ndarray, align: int, e_start: int, e_count: int
    ) -> np.ndarray:
        """Elements [e_start, e_start+e_count) of an alignment grid."""
        s = self.config.element_width
        b0 = align + e_start * s
        raw = data[b0 : b0 + e_count * s]
        return decode_elements(raw.tobytes(), s, self.config.endianness)

    # ------------------------------------------------------------------
    def _scan_dense(self, pat, data, file_size, blocks, progress, aborted,
                    timer, own_bytes=None, gather=None):
        """Two-phase dense scan (device tile counts + host hot-tile
        extraction) with per-(block, alignment) greedy suppression.

        ``own_bytes``: optional (lo, hi) byte interval — only window starts
        inside it are kept, and chunks with no owned starts are skipped
        (multi-host partitioning).  ``gather``: optional collective applied
        to the flat candidate arrays before the global finalize.
        """
        from .dense import MAX_DEVICE_ELEMS, TILE_ELEMS, extract_hot_tiles
        from .utils.jit_cache import enable_persistent_cache

        import jax.numpy as jnp

        enable_persistent_cache()

        cfg = self.config
        s = cfg.element_width
        L = pat.length
        base = cfg.preferred_search_block_size

        # Chunk span is a whole number of count tiles; each chunk array adds
        # one halo/padding tile so cross-chunk windows read real data.
        # Clamped by the file size — rounded up to a power of two so small
        # forced-device searches don't allocate a full chunk, while jit
        # shapes stay stable per size BUCKET (an exact-size clamp would
        # recompile for every distinct file size)
        size_bucket = 1 << (max(file_size, 1) - 1).bit_length()
        desired = max(L, min(cfg.device_chunk_bytes, size_bucket) // s)
        tile_elems = min(TILE_ELEMS, 1 << (desired - 1).bit_length())
        tiles_per_chunk = max(1, desired // tile_elems)
        chunk_elems = tiles_per_chunk * tile_elems

        # Multi-device: scan each chunk across a 1-D mesh (shard_map + halo
        # exchange); single-device otherwise.
        mesh = None
        if cfg.devices:
            from .parallel.mesh import make_mesh

            mesh = make_mesh(list(cfg.devices))

            # Sharded resident corpus: upload once (NamedSharding), derive
            # every grid on device, scan the WHOLE corpus in one collective
            # dispatch per alignment — repeat searches transfer zero corpus
            # bytes (the round-3 path host-decoded + re-uploaded every
            # chunk).  Multi-host (own_bytes) keeps the chunked path.
            if own_bytes is None and file_size and pat.length <= TILE_ELEMS:
                from .parallel.resident import get_sharded_corpus

                d = len(list(cfg.devices))
                per_dev = -(-file_size // d)
                # the fused body's gathered slot spans tile + ONE halo tile
                # and the scan's ppermute halo is one tile, so tile_elems
                # must cover the window: tile_elems >= pattern length
                # (otherwise shard/tile-boundary windows read shifted data
                # — wrong matches, found by review repro)
                tile_m = min(
                    TILE_ELEMS,
                    max(
                        64,
                        1 << (per_dev - 1).bit_length(),
                        1 << (pat.length - 1).bit_length(),
                    ),
                )
                with timer.stage("corpus_upload"):
                    corpus = get_sharded_corpus(
                        cfg.file_path, file_size, mesh, tile_m,
                        cfg.resident_bytes_limit, stats=timer.stats,
                    )
                # the fused body's int32 element indices wrap on shards of
                # 2^31 elements or more (silent false negatives); such
                # corpora take the chunked path below, whose per-chunk
                # element counts are small
                if corpus is not None and (
                    (corpus.t_loc(s) + 1) * corpus.tile_elems
                    < MAX_DEVICE_ELEMS
                ):
                    return self._scan_mesh_resident(
                        pat, data, file_size, blocks, progress,
                        aborted, timer, corpus, mesh,
                    )

        # Resident corpus: upload once, derive element grids on device;
        # chunks then cost no host→device transfer at all.  Multi-host
        # (own_bytes) streams instead — residency would upload the WHOLE
        # corpus to every host when each scans only ~1/N of it.
        resident = None
        if file_size and mesh is None and own_bytes is None:
            from .corpus import get_resident_corpus, resident_pad_bytes

            with timer.stage("corpus_upload"):
                resident = get_resident_corpus(
                    cfg.file_path,
                    file_size,
                    cfg.resident_bytes_limit,
                    pad_bytes=resident_pad_bytes(chunk_elems * s, tile_elems),
                    stats=timer.stats,
                )
            if resident is not None and getattr(resident, "fresh", False):
                timer.stats.h2d_bytes += len(resident)
                resident.fresh = False

        # (byte_offset, element_offset_in_grid, align, values) per candidate
        per_group: dict = {}
        candidate_info: dict = {}

        mesh_n_dev = len(mesh.devices.flat) if mesh is not None else 0
        pat_width = np.dtype(pat.dtype).itemsize

        n_chunks = max(1, -(-max(
            (self._element_grid(file_size, a) for a in range(s)), default=0
        ) // chunk_elems))

        tracker = _BlockProgress(len(blocks), base, progress, aborted)

        def record_step(a, e0, offs, vals, finfo, counts_hot):
            """Shared accounting + candidate recording for one finished
            (chunk, alignment) step."""
            if finfo is not None:
                hot_here = finfo.hot_tiles
                timer.stats.fused_steps += 1
                timer.stats.d2h_bytes += finfo.d2h_bytes
                if finfo.fallback:
                    timer.stats.fused_fallbacks += 1
                    log(
                        "fused step overflow (hot=", finfo.hot_tiles,
                        " cand=", finfo.candidates,
                        "): counts-fetch fallback",
                    )
            else:
                hot_here = counts_hot
            if not hot_here:
                return
            timer.stats.hot_tiles += hot_here
            # chunk scans only own starts within [0, chunk_elems)
            keep = offs < chunk_elems
            offs, vals = offs[keep], vals[keep]
            for off, val in zip(offs.tolist(), vals.tolist()):
                e_global = e0 + off
                byte_off = a + e_global * s
                if own_bytes is not None and not (
                    own_bytes[0] <= byte_off < own_bytes[1]
                ):
                    continue
                timer.stats.candidates += 1
                block_id = byte_off // base
                per_group.setdefault((block_id, a), []).append(e_global)
                candidate_info[(a, e_global)] = (byte_off, val)

        # Pipelined fused steps (resident AND streaming paths): up to
        # ``pipeline_depth`` dispatches stay in flight, so chunk k+1's
        # upload/dispatch + execution overlaps chunk k's result fetch, so
        # the fetch round trip hides behind the next chunk's compute.  The
        # deque holds (meta, FusedPending) plus progress markers
        # (meta, None) so callbacks fire in chunk order.
        from collections import deque

        from .dense import fused_count_extract_finish, fused_count_extract_start

        depth = max(1, cfg.pipeline_depth)
        pending: deque = deque()  # (meta, FusedPending) steps + (meta, None)
        in_flight = [0]  # unfetched steps in the deque (markers are free)

        def flush_one() -> bool:
            meta, pnd = pending.popleft()
            if pnd is not None:
                in_flight[0] -= 1
                a, e0 = meta
                if isinstance(pnd, _MeshInFlight):
                    # collective step: fetch the per-device result buffers
                    # one pipeline slot late, mirroring the single-device
                    # deferred fetch; overflow falls back to host
                    # extraction on the retained decoded chunk
                    from .parallel.sharded import sharded_fused_step_finish

                    with timer.stage("device_scan"):
                        offs, vals, finfo, over = sharded_fused_step_finish(
                            pnd.pending
                        )
                    _accumulate_mesh_stats(
                        timer.stats, finfo, mesh_n_dev, tile_elems,
                        pat_width,
                    )
                    if over is not None:
                        # extract_hot_tiles clamps per-tile slices to the
                        # buffer end, so the decoded chunk passes through
                        # unpadded
                        with timer.stage("host_extract"):
                            offs, vals = extract_hot_tiles(
                                pat, pnd.arr[: pnd.count], over, tile_elems
                            )
                    record_step(a, e0, offs, vals, finfo, None)
                    return True
                with timer.stage("device_scan"):
                    offs, vals, finfo = fused_count_extract_finish(pnd)
                record_step(a, e0, offs, vals, finfo, None)
                return True
            # progress marker: a chunk's steps always precede its marker in
            # the FIFO, so callbacks fire in chunk order
            bytes_done, final = meta
            return tracker.advance_to(bytes_done, final=final)

        def flush(max_steps: int) -> bool:
            while in_flight[0] > max_steps or (
                in_flight[0] == 0 and pending
            ):
                if not flush_one():
                    return False
            return True

        for k in range(n_chunks):
            if aborted():
                return None
            e0 = k * chunk_elems
            if own_bytes is not None:
                # starts owned by chunk k lie in bytes
                # [e0*s, (e0 + chunk_elems)*s + s); skip chunks that cannot
                # contain an owned start (other hosts cover them)
                if (e0 + chunk_elems) * s + s <= own_bytes[0] or (
                    e0 * s >= own_bytes[1]
                ):
                    bytes_done = min(file_size, (e0 + chunk_elems) * s)
                    pending.append(
                        ((bytes_done, k == n_chunks - 1), None)
                    )
                    if not flush(depth):
                        return None
                    continue
            timer.stats.chunks += 1
            for a in range(s):
                n_a = self._element_grid(file_size, a)
                if e0 >= n_a:
                    continue
                count_here = min(chunk_elems + L - 1, n_a - e0)
                if count_here < L:
                    continue
                want = (tiles_per_chunk + 1) * tile_elems
                if mesh is not None:
                    # The PRODUCTION fused step under shard_map: per-device
                    # prefilter + one-neighbor ppermute tile halo +
                    # on-device exact phase 2; one small per-device buffer
                    # crosses D2H.
                    # The fetch is deferred (pipelined) behind later
                    # collective dispatches, exactly like the single-device
                    # paths; overflow falls back to host extraction on the
                    # retained decoded chunk.
                    from .parallel.sharded import sharded_fused_step_start

                    with timer.stage("decode"):
                        arr = self._decode_grid(data, a, e0, count_here)
                    timer.stats.h2d_bytes += arr.nbytes  # per-chunk upload
                    with timer.stage("device_scan"):
                        spnd = sharded_fused_step_start(
                            pat, arr, mesh, count_here, tile_elems,
                        )
                    timer.stats.device_dispatches += 1
                    timer.stats.bytes_scanned += count_here * s
                    pending.append(
                        ((a, e0), _MeshInFlight(spnd, arr, count_here))
                    )
                    in_flight[0] += 1
                    if not flush(depth):
                        return None
                elif resident is not None:
                    with timer.stage("device_scan"):
                        dev_arr = resident.grid_chunk(
                            s, cfg.endianness, a, e0, want
                        )
                        # fused one-dispatch counts + hot-tile gather: a
                        # chunk with matches costs one dispatch instead of
                        # two (counts, then extraction gather), and only
                        # the hot-tile header crosses D2H; the fetch is
                        # deferred (pipelined) behind later dispatches
                        pnd = fused_count_extract_start(
                            pat, dev_arr, count_here, tile_elems=tile_elems
                        )
                    timer.stats.device_dispatches += 1
                    timer.stats.bytes_scanned += count_here * s
                    pending.append(((a, e0), pnd))
                    in_flight[0] += 1
                    if not flush(depth):
                        return None
                else:
                    # streaming path (file over the residency limit):
                    # upload the decoded chunk (async device_put) and run
                    # the same pipelined fused step as the resident path —
                    # chunk k+1's upload/dispatch overlaps chunk k's fetch
                    with timer.stage("decode"):
                        arr = self._decode_grid(data, a, e0, count_here)
                        if len(arr) < want:
                            arr = np.pad(arr, (0, want - len(arr)))
                    with timer.stage("device_scan"):
                        dev_arr = jnp.asarray(arr)
                        pnd = fused_count_extract_start(
                            pat, dev_arr, count_here, tile_elems=tile_elems
                        )
                    timer.stats.device_dispatches += 1
                    timer.stats.bytes_scanned += count_here * s
                    timer.stats.h2d_bytes += arr.nbytes
                    pending.append(((a, e0), pnd))
                    in_flight[0] += 1
                    if not flush(depth):
                        return None
            # progress: blocks fully covered by the chunks processed so far
            # (deferred behind any in-flight steps so callbacks stay in
            # chunk order)
            bytes_done = min(file_size, (e0 + chunk_elems) * s)
            if pending:
                pending.append(((bytes_done, k == n_chunks - 1), None))
                if not flush(depth):
                    return None
            else:
                if not tracker.advance_to(
                    bytes_done, final=(k == n_chunks - 1)
                ):
                    return None

        if not flush(0):
            return None
        if not tracker.finish():
            return None

        if gather is not None:
            # all-gather flat candidates, then rebuild the suppression groups
            # — finalize below is deterministic, so every host produces the
            # identical global result list
            per_group, candidate_info = _gathered_groups(
                gather, candidate_info, s, base, timer
            )

        return finalize_candidates(
            pat, cfg.semantics, s, base, file_size, per_group, candidate_info
        )

    # ------------------------------------------------------------------
    def _scan_mesh_resident(self, pat, data, file_size, blocks, progress,
                            aborted, timer, corpus, mesh):
        """Whole-corpus mesh scan against a sharded resident corpus: per
        alignment grid, ONE collective fused dispatch (per-device
        prefilter + ppermute tile halo + on-device exact phase 2), with the
        corpus words and all per-(pattern, geometry) operands resident on
        device (``parallel/resident.py``).  H2D per repeat search: zero.
        """
        from .dense import _prefilter_sel, auto_k_cap, extract_hot_tiles
        from .ops.scan_host import decode_grid_host
        from .ops.scan_jnp import pattern_device_args
        from .parallel.sharded import _sharded_fused_fn, parse_sharded_combos

        cfg = self.config
        s = cfg.element_width
        L = pat.length
        base = cfg.preferred_search_block_size
        tile_elems = corpus.tile_elems
        width = np.dtype(pat.dtype).itemsize
        d = corpus.n_devices
        t_loc = corpus.t_loc(s)

        if getattr(corpus, "fresh", False):
            timer.stats.h2d_bytes += corpus.uploaded_bytes
            corpus.fresh = False

        pairs, _, _ = _prefilter_sel(pat)
        pairs_exact = tuple(
            (int(c), int(p))
            for c, p in zip(pat.chk_shift_cur, pat.chk_shift_prev)
        )

        per_group: dict = {}
        candidate_info: dict = {}
        tracker = _BlockProgress(len(blocks), base, progress, aborted)

        # Dispatch phase: issue BOTH alignment grids' collective steps
        # back-to-back (JAX dispatch is async) before paying any result
        # fetch, mirroring the dual-alignment structure of
        # ``search_engine.cpp:129-159`` — a 16-bit search's second grid
        # rides behind the first's fetch.
        in_flight = []  # (a, valid_count, k_cap, p_cap, counts, combos)
        for a in range(s):
            if aborted():
                return None
            valid_count = self._element_grid(file_size, a)
            if valid_count < L:
                continue
            timer.stats.chunks += 1
            k_cap = auto_k_cap(pat, valid_count, tile_elems, len(pairs))
            p_cap = 1024
            with timer.stage("device_scan"):
                dev_in = corpus.grid(s, cfg.endianness, a)
                valid2_dev, vtvr2_dev, expected_in = corpus.step_operands(
                    pat, valid_count, s
                )
                _, _, exp_exact, recovery = pattern_device_args(pat)
                fn = _sharded_fused_fn(
                    mesh, pairs=pairs, length=L, tile_elems=tile_elems,
                    k_cap=k_cap, p_cap=p_cap,
                    signed_compare=pat.signed_compare,
                    pairs_exact=pairs_exact,
                )
                counts_dev, combos_dev = fn(
                    dev_in, valid2_dev, vtvr2_dev, expected_in, exp_exact,
                    recovery,
                )
            timer.stats.device_dispatches += 1
            timer.stats.bytes_scanned += valid_count * s
            in_flight.append(
                (a, valid_count, k_cap, p_cap, counts_dev, combos_dev)
            )

        # Fetch phase: decode each grid's per-device result buffers (the
        # blocking D2H transactions) only after every dispatch is in flight.
        for a, valid_count, k_cap, p_cap, counts_dev, combos_dev in in_flight:
            if aborted():
                return None
            t_total = max(1, -(-valid_count // tile_elems))
            with timer.stage("device_scan"):
                offs, vals, finfo, over = parse_sharded_combos(
                    counts_dev, combos_dev, d, t_loc, t_total, k_cap,
                    p_cap, tile_elems, 0,
                )
            timer.stats.fused_steps += 1
            timer.stats.d2h_bytes += finfo.d2h_bytes
            _accumulate_mesh_stats(timer.stats, finfo, d, tile_elems, width)
            if over is not None:
                timer.stats.fused_fallbacks += 1
                log(
                    "sharded fused step overflow (hot=", finfo.hot_tiles,
                    "): host extraction fallback",
                )
                with timer.stage("decode"):
                    arr = decode_grid_host(
                        data, file_size, s, cfg.endianness, a
                    )
                with timer.stage("host_extract"):
                    offs, vals = extract_hot_tiles(
                        pat, arr, over, tile_elems
                    )
            if finfo.hot_tiles:
                timer.stats.hot_tiles += finfo.hot_tiles
                timer.stats.candidates += len(offs)
            for off, val in zip(offs.tolist(), vals.tolist()):
                byte_off = a + off * s
                block_id = byte_off // base
                per_group.setdefault((block_id, a), []).append(off)
                candidate_info[(a, off)] = (byte_off, val)
        if not tracker.finish():
            return None
        return finalize_candidates(
            pat, cfg.semantics, s, base, file_size, per_group, candidate_info
        )

    # ------------------------------------------------------------------
    def _scan_host(self, pat, data, file_size, blocks, progress, aborted,
                   timer, own_bytes=None, gather=None):
        """Small-input latency path: dense scan on the HOST, no device.

        The reference's whole benchmark range is 128 KiB-16 MiB
        (``benchmarks/bench_search.cpp:70``) with a 512 KiB default block
        (``search_engine.hpp:36``); at those sizes a device dispatch's
        fixed cost exceeds the entire scan, so searches at or below
        ``host_latency_threshold_bytes`` run the C dense scanner
        (``native/mm_walker.cpp:mm_dense_scan_*``, ~host memory bandwidth)
        over each alignment grid and feed the identical per-(block,
        alignment) finalize as the device path.  Slice structure mirrors
        ``_scan_dense``'s chunk loop so progress/abort behave identically.

        Multi-MB files scan slices over a ≤``preferred_num_threads`` pool
        (default: hardware concurrency — the reference engine's own
        default, ``search_engine.hpp:35``); the C scanner releases the
        GIL, so per-core memory bandwidth adds up (measured 3.3 → 6.4 GB/s
        at 2 threads on the dev host).  Progress stays one callback per
        logical block (equal float increments commute across completion
        order) and the final candidate set is order-independent
        (``finalize_candidates`` sorts per group).
        """
        from .ops.scan_host import host_candidates_values, host_grid_view

        cfg = self.config
        s = cfg.element_width
        L = pat.length
        base = cfg.preferred_search_block_size
        timer.stats.host_routed = True

        per_group: dict = {}
        candidate_info: dict = {}
        n_threads = cfg.preferred_num_threads or (os.cpu_count() or 1)
        # persistent pool (module-level executor): threshold measured on
        # the dev host — per-search executor creation used to eat the
        # 2-thread win below ~24 MiB; with the shared pool the crossover
        # sits near 4 MiB
        use_pool = n_threads > 1 and file_size >= 4 * 1024 * 1024
        # responsive abort/progress on multi-MB files without hurting the
        # scanner's throughput (slices are >> its internal block); with a
        # pool, enough slices that every worker stays busy
        slice_bytes = 8 * 1024 * 1024
        if use_pool:
            slice_bytes = min(
                slice_bytes,
                max(1024 * 1024, file_size // (2 * n_threads)),
            )
        slice_elems = max(L, slice_bytes // s)
        grids = []
        for a in range(s):
            if self._element_grid(file_size, a) >= L:
                with timer.stage("decode"):
                    # zero-copy even for 16-bit big-endian: the C scanner
                    # byteswaps on load (host_grid_view), so no grid-sized
                    # decode copy exists on this path at all
                    arr, bswap = host_grid_view(
                        data, file_size, s, cfg.endianness, a
                    )
                    grids.append((a, arr, bswap))
        max_grid = max(
            (self._element_grid(file_size, a) for a in range(s)), default=0
        )
        n_slices = max(1, -(-max_grid // slice_elems))
        tracker = _BlockProgress(len(blocks), base, progress, aborted)

        def record(e0, a, offs, vals):
            # slices own starts within [0, slice_elems)
            keep = offs < slice_elems
            offs, vals = offs[keep], vals[keep]
            for off, val in zip(offs.tolist(), vals.tolist()):
                e_global = e0 + off
                byte_off = a + e_global * s
                if own_bytes is not None and not (
                    own_bytes[0] <= byte_off < own_bytes[1]
                ):
                    continue
                timer.stats.candidates += 1
                block_id = byte_off // base
                per_group.setdefault((block_id, a), []).append(e_global)
                candidate_info[(a, e_global)] = (byte_off, val)

        if use_pool:
            import concurrent.futures
            import time as _time

            jobs = []
            for k in range(n_slices):
                e0 = k * slice_elems
                for a, arr, bswap in grids:
                    if e0 >= len(arr):
                        continue
                    count_here = min(slice_elems + L - 1, len(arr) - e0)
                    if count_here < L:
                        continue
                    jobs.append((k, e0, a, arr, bswap, count_here))
            slice_jobs: dict = {}
            for k, *_ in jobs:
                slice_jobs[k] = slice_jobs.get(k, 0) + 1
            done_slices = 0
            t0 = _time.perf_counter()
            pool = _host_pool(n_threads)
            futs = {
                pool.submit(
                    host_candidates_values, pat,
                    arr[e0 : e0 + count_here], bswap,
                ): (k, e0, a, count_here)
                for k, e0, a, arr, bswap, count_here in jobs
            }
            try:
                for fut in concurrent.futures.as_completed(futs):
                    k, e0, a, count_here = futs[fut]
                    offs, vals = fut.result()
                    timer.stats.bytes_scanned += count_here * s
                    record(e0, a, offs, vals)
                    slice_jobs[k] -= 1
                    if slice_jobs[k] == 0:
                        done_slices += 1
                        # equal per-block increments commute, so
                        # advancing by COMPLETED slice count emits the
                        # exact sequential callback sequence
                        if not tracker.advance_to(
                            min(file_size,
                                done_slices * slice_elems * s),
                            final=(done_slices == n_slices),
                        ):
                            return None
            finally:
                for fut in futs:
                    fut.cancel()
                # stage timing must record on the abort path too
                timer.stats.stage_seconds["host_scan"] = (
                    timer.stats.stage_seconds.get("host_scan", 0.0)
                    + _time.perf_counter()
                    - t0
                )
            if not tracker.finish():
                return None
            if gather is not None:
                per_group, candidate_info = _gathered_groups(
                    gather, candidate_info, s, base, timer
                )
            return finalize_candidates(
                pat, cfg.semantics, s, base, file_size, per_group,
                candidate_info,
            )

        for k in range(n_slices):
            if aborted():
                return None
            e0 = k * slice_elems
            for a, arr, bswap in grids:
                n_a = len(arr)
                if e0 >= n_a:
                    continue
                count_here = min(slice_elems + L - 1, n_a - e0)
                if count_here < L:
                    continue
                with timer.stage("host_scan"):
                    offs, vals = host_candidates_values(
                        pat, arr[e0 : e0 + count_here], bswap
                    )
                timer.stats.bytes_scanned += count_here * s
                record(e0, a, offs, vals)
            bytes_done = min(file_size, (e0 + slice_elems) * s)
            if not tracker.advance_to(bytes_done, final=(k == n_slices - 1)):
                return None
        if not tracker.finish():
            return None
        if gather is not None:
            per_group, candidate_info = _gathered_groups(
                gather, candidate_info, s, base, timer
            )
        return finalize_candidates(
            pat, cfg.semantics, s, base, file_size, per_group, candidate_info
        )

    # ------------------------------------------------------------------
    def _scan_reference(self, pat, data, file_size, blocks, progress, aborted,
                        timer, own_bytes=None, gather=None):
        """Exact reference semantics: sequential walk per (block, alignment),
        run over a thread pool of ``preferred_num_threads`` workers — the
        mirror of the reference's ≤N concurrent ``std::async`` futures
        (``search_engine.cpp:82-175``; default = hardware concurrency,
        ``search_engine.hpp:35``).  The native walker is a ctypes call that
        releases the GIL, so block walks genuinely run in parallel; one
        progress callback fires per completed block (float accumulation of
        equal increments is completion-order independent, matching the
        reference's mutex-guarded accumulator, ``:161-165``).

        Multi-host: a block is walked by the host whose ``own_bytes`` region
        contains its start (blocks are the reference's independent work
        units); per-host (offset, recovery values) lists are all-gathered
        and every host rebuilds the identical equivalency maps.
        """
        import concurrent.futures
        import time as _time

        from .ops.recover import recovery_shifts

        cfg = self.config
        s = cfg.element_width
        results = []
        flat_offs: list = []
        flat_vals: list = []
        shifts = recovery_shifts(pat)
        tracker = _BlockProgress(len(blocks), cfg.preferred_search_block_size,
                                 progress, aborted)

        def walk_block(offset, size):
            """Worker lambda mirror (``search_engine.cpp:107-168``): decode
            both alignment grids of one block, walk them, return per-match
            (byte_off, vmap, v0, v1) plus the bytes walked."""
            from .ops.scan_host import decode_grid_host

            raw = data[offset : offset + size]
            out = []
            walked_bytes = 0
            for a in range(s):
                count = max(0, (size - a) // s)
                # zero-copy element views where the layout allows (8-bit and
                # 16-bit-LE walk the memmap bytes in place)
                arr = decode_grid_host(raw, size, s, cfg.endianness, a)
                for pos, vmap in reference_walk(pat, arr):
                    byte_off = offset + pos * s + a
                    v0 = int(arr[pos + shifts[0]])
                    v1 = (
                        int(arr[pos + shifts[1]])
                        if len(shifts) > 1
                        else v0
                    )
                    out.append((byte_off, vmap, v0, v1))
                walked_bytes += count * s
            return out, walked_bytes

        def consume(block_results):
            for byte_off, vmap, v0, v1 in block_results:
                if gather is not None:
                    # ship the numeric recovery values (the same ones the
                    # walker derived vmap from, ``oracle._emit``)
                    flat_offs.append(byte_off)
                    flat_vals.append((v0, v1))
                else:
                    results.append((byte_off, vmap))

        own = [
            b for b in blocks
            if own_bytes is None or own_bytes[0] <= b[0] < own_bytes[1]
        ]
        skipped = len(blocks) - len(own)
        n_threads = cfg.preferred_num_threads or (os.cpu_count() or 1)

        t_walk0 = _time.perf_counter()
        if n_threads <= 1 or len(own) <= 1:
            # single worker: walk inline (no pool overhead)
            for offset, size in own:
                if aborted():
                    return None
                with timer.stage("reference_walk"):
                    block_results, walked_bytes = walk_block(offset, size)
                consume(block_results)
                timer.stats.bytes_scanned += walked_bytes
                if not tracker.step():
                    return None
        else:
            # ≤ n_threads workers over the block queue, harvested in
            # completion order like the engine thread's future loop
            # (``:83-102``).  On abort, queued blocks are cancelled and
            # only the ≤ n_threads walks already running are awaited —
            # the reference likewise joins in-flight workers before
            # returning (``search_engine.cpp:177-187``).
            try:
                with concurrent.futures.ThreadPoolExecutor(
                    max_workers=n_threads
                ) as pool:
                    futures = {
                        pool.submit(walk_block, off, sz): (off, sz)
                        for off, sz in own
                    }
                    try:
                        for fut in concurrent.futures.as_completed(futures):
                            block_results, walked_bytes = fut.result()
                            consume(block_results)
                            timer.stats.bytes_scanned += walked_bytes
                            if not tracker.step():
                                return None
                    finally:
                        for fut in futures:
                            fut.cancel()
            finally:
                timer.stats.stage_seconds["reference_walk"] = (
                    timer.stats.stage_seconds.get("reference_walk", 0.0)
                    + _time.perf_counter()
                    - t_walk0
                )
        for _ in range(skipped):
            if not tracker.step():
                return None
        if gather is not None:
            offs = np.array(flat_offs, dtype=np.int64)
            vals = np.array(flat_vals, dtype=np.int64).reshape(-1, 2)
            with timer.stage("gather"):
                offs, vals = gather(offs, vals)
            results = [
                (int(o), recover_from_values(pat, v))
                for o, v in zip(offs.tolist(), vals.tolist())
            ]
        return results


def _gathered_groups(gather, candidate_info, s, base, timer):
    """Flatten local candidates → collective gather → rebuild the
    per-(block, alignment) suppression groups from global byte offsets."""
    items = sorted(candidate_info.items())
    offs = np.array([v[0] for _, v in items], dtype=np.int64)
    vals = np.array(
        [list(v[1]) for _, v in items], dtype=np.int64
    ).reshape(-1, 2)
    with timer.stage("gather"):
        offs, vals = gather(offs, vals)
    per_group: dict = {}
    info: dict = {}
    for byte_off, val in zip(offs.tolist(), vals.tolist()):
        a = byte_off % s
        e_global = (byte_off - a) // s
        per_group.setdefault((byte_off // base, a), []).append(e_global)
        info[(a, e_global)] = (byte_off, val)
    return per_group, info


class _BlockProgress:
    """Reference-parity progress accounting: ``float`` accumulation of
    ``100/num_blocks`` per completed block (``search_engine.cpp:75-80,
    161-165``), one callback per block, abort checked after each callback."""

    def __init__(self, num_blocks, base, progress, aborted):
        self.num_blocks = num_blocks
        self.base = base
        self.progress = progress
        self.aborted = aborted
        self.total = np.float32(0.0)
        self.inc = np.float32(100.0) / np.float32(max(1, num_blocks))
        self.done = 0

    def step(self) -> bool:
        """One block finished → callback; returns False on abort."""
        self.total = np.float32(self.total + self.inc)
        self.done += 1
        self.progress(int(self.total), SearchStep.SEARCHING)
        return not self.aborted()

    def advance_to(self, bytes_done: int, final: bool) -> bool:
        """Emit callbacks for blocks fully covered up to *bytes_done*."""
        target = self.num_blocks if final else min(
            self.num_blocks, bytes_done // self.base
        )
        while self.done < target:
            if not self.step():
                return False
        return True

    def finish(self) -> bool:
        return self.advance_to(0, final=True) if self.done < self.num_blocks else True


def _as_seq(keyword) -> Sequence:
    if keyword is None:
        return ()
    return keyword
