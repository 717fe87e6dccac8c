"""Multi-keyword search over one corpus (an addition beyond the reference).

Interactive ROM exploration usually tries *many* keywords against the same
file.  The reference re-runs its whole engine per keyword; here all patterns
scan the resident corpus in a **single device dispatch per chunk**
(``ops/scan_jnp.tile_counts_multi_xla``), amortizing both the corpus
residency and the per-dispatch overhead across keywords.

Example::

    ms = MultiSearcher("game.sfc", element_width=2)
    hits = ms.search(["MONKEY", "BANANA", {"keyword": "b*tter",
                                           "wildcard": "*"}])

Engine-parity semantics (block grouping, suppression, block-fit filter) are
applied per pattern via :func:`engine.finalize_candidates`; REFERENCE
semantics fall back to per-keyword engine runs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

from .config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
    SearchResult,
)
from .dense import TILE_ELEMS, extract_hot_tiles
from .engine import SearchEngine, compute_search_blocks, finalize_candidates
from .pattern import CompiledPattern, compile_pattern
from .preview import decode_elements, generate_preview

__all__ = ["MultiSearcher"]

Spec = Union[str, dict]


class MultiSearcher:
    def __init__(
        self,
        file_path,
        element_width: int = 1,
        endianness: Endianness = Endianness.LITTLE,
        preferred_search_block_size: int = 524288,
        device_chunk_bytes: int = 512 * 1024 * 1024,
        preferred_preview_width: int = 50,
        semantics: MatchSemantics = MatchSemantics.GREEDY,
        resident_bytes_limit: int = 12 * 1024 * 1024 * 1024,
        devices=None,
    ):
        self.file_path = Path(file_path)
        self.element_width = element_width
        self.endianness = endianness
        self.block_size = preferred_search_block_size
        self.chunk_bytes = device_chunk_bytes
        self.preview_width = preferred_preview_width
        self.semantics = semantics
        self.resident_bytes_limit = resident_bytes_limit
        #: optional JAX device list — each keyword runs the engine's
        #: sharded resident-corpus path across this mesh (one collective
        #: dispatch per keyword and alignment, no corpus re-upload)
        self.devices = list(devices) if devices else None

    def _config(self, spec: Spec) -> SearchConfig:
        kw = {"keyword": spec} if isinstance(spec, str) else dict(spec)
        return SearchConfig(
            file_path=self.file_path,
            is_relative_search="reference_values" not in kw,
            keyword=kw.get("keyword", ""),
            wildcard=kw.get("wildcard", "*"),
            custom_char_seq=kw.get("char_seq", ()),
            reference_values=kw.get("reference_values", ()),
            element_width=self.element_width,
            endianness=self.endianness,
            preferred_search_block_size=self.block_size,
            device_chunk_bytes=self.chunk_bytes,
            preferred_preview_width=self.preview_width,
            semantics=self.semantics,
            resident_bytes_limit=self.resident_bytes_limit,
        )

    def _compile(self, spec: Spec) -> CompiledPattern:
        return SearchEngine(self._config(spec)).compile()

    # ------------------------------------------------------------------
    def search(
        self,
        specs: Sequence[Spec],
        generate_previews: bool = False,
    ) -> List[List[SearchResult]]:
        """Search every spec; returns one result list per spec, each sorted
        by byte offset (identical to running the engine per keyword)."""
        if not specs:
            return []
        if self.semantics is MatchSemantics.REFERENCE:
            return [
                SearchEngine(self._config(s)).run(
                    generate_previews=generate_previews
                )
                for s in specs
            ]
        if self.devices:
            return self._search_mesh(specs, generate_previews)

        import jax.numpy as jnp

        from .corpus import get_resident_corpus, resident_pad_bytes
        from .dense import extract_hot_tiles_device
        from .ops.scan_jnp import canonical_check_tables, tile_counts_multi_xla
        from .utils.jit_cache import enable_persistent_cache

        enable_persistent_cache()

        pats = [self._compile(s) for s in specs]
        if not self.file_path.exists():
            raise FileNotFoundError("File not found")
        file_size = self.file_path.stat().st_size
        s = self.element_width
        l_max = max(p.length for p in pats)

        # power-of-two size bucket: stable jit shapes per bucket (see the
        # engine's chunk sizing note)
        size_bucket = 1 << (max(file_size, 1) - 1).bit_length()
        desired = max(l_max, min(self.chunk_bytes, size_bucket) // s)
        tile_elems = min(TILE_ELEMS, 1 << (desired - 1).bit_length())
        tiles_per_chunk = max(1, desired // tile_elems)
        chunk_elems = tiles_per_chunk * tile_elems
        want = (tiles_per_chunk + 1) * tile_elems

        data = (
            np.memmap(self.file_path, dtype=np.uint8, mode="r")
            if file_size
            else np.zeros(0, dtype=np.uint8)
        )
        resident = get_resident_corpus(
            self.file_path,
            file_size,
            self.resident_bytes_limit,
            pad_bytes=resident_pad_bytes(chunk_elems * s, tile_elems),
        )

        # Check tables via the shared canonical builder (simple-mode
        # patterns padded so batches of plain keywords share executables).
        pair_sets, raw_exp, raw_active = canonical_check_tables(pats)
        lengths_arr = jnp.asarray(
            [pat.length for pat in pats], dtype=jnp.int32
        )
        expected = tuple(jnp.asarray(e) for e in raw_exp)
        active = tuple(jnp.asarray(a) for a in raw_active)

        per_group = [dict() for _ in pats]
        candidate_info = [dict() for _ in pats]

        def grid_count(a):
            return max(0, (file_size - a) // s)

        n_max = max((grid_count(a) for a in range(s)), default=0)
        n_chunks = max(1, -(-n_max // chunk_elems))

        for k in range(n_chunks):
            e0 = k * chunk_elems
            for a in range(s):
                n_a = grid_count(a)
                if e0 >= n_a:
                    continue
                count_here = min(chunk_elems + l_max - 1, n_a - e0)
                if count_here < min(p.length for p in pats):
                    continue
                if resident is not None:
                    dev_arr = resident.grid_chunk(
                        s, self.endianness, a, e0, want
                    )
                    arr_host = None
                else:
                    arr_host = self._decode_grid(data, a, e0, count_here)
                    if len(arr_host) < want:
                        arr_host = np.pad(
                            arr_host, (0, want - len(arr_host))
                        )
                    dev_arr = jnp.asarray(arr_host)

                def emit(pi, offs, vals):
                    keep = offs < chunk_elems
                    offs, vals = offs[keep], vals[keep]
                    for off, val in zip(offs.tolist(), vals.tolist()):
                        e_global = e0 + off
                        byte_off = a + e_global * s
                        block_id = byte_off // self.block_size
                        per_group[pi].setdefault(
                            (block_id, a), []
                        ).append(e_global)
                        candidate_info[pi][(a, e_global)] = (byte_off, val)

                counts_all = tile_counts_multi_xla(
                    dev_arr,
                    jnp.int32(count_here),
                    expected,
                    active,
                    lengths_arr,
                    pair_sets=pair_sets,
                    tile_elems=tile_elems,
                )
                counts_np = [np.asarray(c) for c in counts_all]
                for pi, counts in enumerate(counts_np):
                    if not counts.any():
                        continue
                    if resident is not None:
                        # extract from the device-resident grid (no
                        # whole-chunk host re-decode)
                        offs, vals = extract_hot_tiles_device(
                            pats[pi], dev_arr, counts, count_here,
                            tile_elems,
                        )
                    else:
                        offs, vals = extract_hot_tiles(
                            pats[pi], arr_host[:count_here], counts,
                            tile_elems,
                        )
                    emit(pi, offs, vals)

        return self._finalize_all(
            specs, pats, per_group, candidate_info, data, file_size,
            generate_previews,
        )

    # ------------------------------------------------------------------
    def _search_mesh(
        self, specs: Sequence[Spec], generate_previews: bool
    ) -> List[List[SearchResult]]:
        """Multi-keyword batch across a device mesh: each keyword runs the
        engine's resident mesh path (``parallel/resident.py``) — one
        collective dispatch per keyword and alignment, with the sharded
        corpus uploaded once for the whole batch."""
        out = []
        for sp in specs:
            cfg = self._config(sp)
            cfg.devices = self.devices
            out.append(
                SearchEngine(cfg).run(generate_previews=generate_previews)
            )
        return out

    def _finalize_all(
        self, specs, pats, per_group, candidate_info, data, file_size,
        generate_previews,
    ) -> List[List[SearchResult]]:
        """Per-pattern finalize + sort + optional previews (shared by the
        single-device and mesh batch paths)."""
        s = self.element_width
        out: List[List[SearchResult]] = []
        for pi, pat in enumerate(pats):
            raw = finalize_candidates(
                pat, self.semantics, s, self.block_size, file_size,
                per_group[pi], candidate_info[pi],
            )
            raw.sort(key=lambda r: r[0])
            results = [SearchResult(offset=o, values_map=m) for o, m in raw]
            if generate_previews and results:
                cfg = self._config(specs[pi])
                is_ascii = len(pat.char_seq) == 0
                kw_len = len(
                    cfg.keyword if isinstance(cfg.keyword, (list, tuple))
                    else str(cfg.keyword)
                )
                for r in results:
                    r.preview = generate_preview(
                        data, file_size, r.offset, r.values_map, kw_len,
                        self.preview_width, s, self.endianness,
                        cfg.is_relative_search, is_ascii,
                    )
            out.append(results)
        return out

    # ------------------------------------------------------------------
    def _decode_grid(self, data, align, e_start, e_count):
        s = self.element_width
        b0 = align + e_start * s
        raw = data[b0 : b0 + e_count * s]
        return decode_elements(raw.tobytes(), s, self.endianness)
