"""Multi-device sharding tests (layer L4), on an 8-virtual-CPU-device mesh.

The device analog of the reference's partitioning-invariance sweep
(``tests/test_search_engine.cpp:62-69``): shard-count × data-size sweeps must
produce results identical to the single-device scan, including matches
straddling shard boundaries.
"""

from pathlib import Path

import numpy as np
import pytest
import jax

from monkey_moore_tpu.dense import dense_candidates
from monkey_moore_tpu.parallel import (
    host_byte_range,
    make_mesh,
    sharded_candidates,
)
from monkey_moore_tpu.pattern import compile_pattern


@pytest.fixture(scope="module")
def devices():
    return jax.devices()


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
class TestShardingInvariance:
    def test_matches_single_device(self, devices, n_dev, rng):
        mesh = make_mesh(devices, n=n_dev)
        data = rng.integers(0, 256, 4096).astype(np.uint8)
        pat = compile_pattern("abcde")
        kw = np.array(pat.keyword, dtype=np.int64)
        shard = 4096 // n_dev
        # plant matches: start, mid-shard, exactly straddling each boundary
        plants = [0, 100]
        plants += [shard * i - 2 for i in range(1, n_dev)]
        plants += [4096 - 5]
        for i, pos in enumerate(plants):
            data[pos : pos + 5] = ((kw + i) % 256).astype(np.uint8)
        offs_sharded, vals_sharded = sharded_candidates(pat, data, mesh)
        offs_single, vals_single = dense_candidates(pat, data)
        assert offs_sharded.tolist() == offs_single.tolist()
        assert vals_sharded.tolist() == vals_single.tolist()

    def test_wildcard_16bit(self, devices, n_dev, rng):
        mesh = make_mesh(devices, n=n_dev)
        data = rng.integers(0, 65536, 2048).astype(np.uint16)
        pat = compile_pattern("ab*de", "*", dtype=np.uint16)
        kw = [97, 98, 0, 100, 101]
        shard = 2048 // n_dev
        plants = [7] + [shard * i - 3 for i in range(1, n_dev)]
        for pos in plants:
            enc = [(c + 1000) % 65536 if c else 31337 for c in kw]
            data[pos : pos + 5] = np.array(enc, dtype=np.uint16)
        offs_sharded, _ = sharded_candidates(pat, data, mesh)
        offs_single, _ = dense_candidates(pat, data)
        assert offs_sharded.tolist() == offs_single.tolist()


class TestShardEdges:
    def test_non_divisible_length_padding(self, devices, rng):
        mesh = make_mesh(devices, n=4)
        data = rng.integers(0, 256, 1003).astype(np.uint8)  # not divisible
        pat = compile_pattern("catch")
        kw = np.array(pat.keyword, dtype=np.int64)
        data[998:1003] = ((kw + 3) % 256).astype(np.uint8)  # at the very end
        offs, _ = sharded_candidates(pat, data, mesh)
        offs_single, _ = dense_candidates(pat, data)
        assert offs.tolist() == offs_single.tolist()
        assert 998 in offs.tolist()

    def test_capacity_overflow_retries(self, devices):
        mesh = make_mesh(devices, n=2)
        data = np.tile(np.array([97, 98], dtype=np.uint8), 600)  # 599 matches
        pat = compile_pattern("abab")
        offs, _ = sharded_candidates(pat, data, mesh, capacity_per_shard=8)
        offs_single, _ = dense_candidates(pat, data)
        assert offs.tolist() == offs_single.tolist()


class TestShardedTileCounts:
    """Two-phase phase 1 under shard_map: per-tile prefilter counts across
    the mesh must equal the single-device prefilter counts tile-for-tile."""

    @pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
    def test_counts_match_single_device(self, devices, n_dev, rng):
        import jax.numpy as jnp

        from monkey_moore_tpu.dense import tile_counts
        from monkey_moore_tpu.parallel.sharded import sharded_tile_counts

        tile_elems = 256
        mesh = make_mesh(devices, n=n_dev)
        n = 8 * 1024 + 123  # ragged tail
        data = rng.integers(0, 256, n).astype(np.uint8)
        pat = compile_pattern("abcde")
        kw = np.array(pat.keyword, dtype=np.int64)
        shard_elems = -(-(-(-n // tile_elems)) // n_dev) * tile_elems
        # plant matches mid-tile, straddling each shard boundary, at EOF
        plants = [3, n - 5]
        plants += [shard_elems * i - 2 for i in range(1, n_dev)]
        for i, pos in enumerate(plants):
            if 0 <= pos <= n - 5:
                data[pos : pos + 5] = ((kw + i) % 256).astype(np.uint8)
        counts_mesh = sharded_tile_counts(pat, data, mesh, n, tile_elems)

        t = -(-n // tile_elems)
        arr = np.zeros((t + 1) * tile_elems, dtype=np.uint8)
        arr[:n] = data
        counts_single = tile_counts(
            pat, jnp.asarray(arr), n, tile_elems=tile_elems
        )
        assert counts_mesh.tolist() == counts_single.tolist()
        assert counts_mesh.sum() >= len([p for p in plants if 0 <= p <= n - 5])

    def test_counts_16bit_wildcard(self, devices, rng):
        import jax.numpy as jnp

        from monkey_moore_tpu.dense import tile_counts
        from monkey_moore_tpu.parallel.sharded import sharded_tile_counts

        tile_elems = 128
        mesh = make_mesh(devices, n=4)
        n = 3000
        data = rng.integers(0, 65536, n).astype(np.uint16)
        pat = compile_pattern("ab*de", "*", dtype=np.uint16)
        counts_mesh = sharded_tile_counts(pat, data, mesh, n, tile_elems)
        t = -(-n // tile_elems)
        arr = np.zeros((t + 1) * tile_elems, dtype=np.uint16)
        arr[:n] = data
        counts_single = tile_counts(
            pat, jnp.asarray(arr), n, tile_elems=tile_elems
        )
        assert counts_mesh.tolist() == counts_single.tolist()


class TestShardedFusedStep:
    """The PRODUCTION fused step (device prefilter + on-device exact
    phase 2) under shard_map must equal the single-device scan exactly —
    the multi-device twin of ``dense.fused_count_extract``."""

    @pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
    def test_xla_body_matches_single(self, devices, n_dev, rng):
        from monkey_moore_tpu.dense import two_phase_candidates
        from monkey_moore_tpu.parallel.sharded import sharded_fused_step

        tile_elems = 256
        mesh = make_mesh(devices, n=n_dev)
        n = 8 * 1024 + 123
        data = rng.integers(0, 256, n).astype(np.uint8)
        pat = compile_pattern("abcde")
        kw = np.array(pat.keyword, dtype=np.int64)
        t_loc = -(-(-(-n // tile_elems)) // n_dev)
        e_loc = t_loc * tile_elems
        plants = [3, n - 5] + [e_loc * i - 2 for i in range(1, n_dev)]
        for i, pos in enumerate(plants):
            if 0 <= pos <= n - 5:
                data[pos : pos + 5] = ((kw + i) % 256).astype(np.uint8)
        offs, vals, info, over = sharded_fused_step(
            pat, data, mesh, n, tile_elems
        )
        assert over is None and not info.fallback
        offs_s, vals_s = two_phase_candidates(pat, data)
        order = np.argsort(offs)
        assert offs[order].tolist() == offs_s.tolist()
        assert vals[order].tolist() == vals_s.tolist()
        assert info.candidates == len(offs_s)

    def test_long_keyword_shift_over_row_takes_xla(self, devices, rng):
        """Regression: a keyword whose selected prefilter shifts reach past
        1024 elements must still be found by the mesh step (a match planted
        mid-corpus once vanished)."""
        from monkey_moore_tpu.dense import _prefilter_sel
        from monkey_moore_tpu.parallel.sharded import sharded_fused_step

        kw = "a" * 1030 + "bcd"
        pat = compile_pattern(kw)
        assert _prefilter_sel(pat)[2] >= 1024  # the long-shift shape
        tile_elems = 8 * 1024
        mesh = make_mesh(devices, n=4)
        n = 8 * tile_elems
        data = rng.integers(0, 256, n).astype(np.uint8)
        enc = (np.array(pat.keyword, dtype=np.int64) + 7) % 256
        data[10 : 10 + len(enc)] = enc.astype(np.uint8)
        offs, _, info, over = sharded_fused_step(
            pat, data, mesh, n, tile_elems
        )
        assert over is None
        assert 10 in offs.tolist()

    def test_wildcard_16bit_xla(self, devices, rng):
        from monkey_moore_tpu.dense import two_phase_candidates
        from monkey_moore_tpu.parallel.sharded import sharded_fused_step

        tile_elems = 128
        mesh = make_mesh(devices, n=4)
        n = 3000
        data = rng.integers(0, 65536, n).astype(np.uint16)
        pat = compile_pattern("ab*de", "*", dtype=np.uint16)
        kw = [97, 98, 0, 100, 101]
        for pos in (7, 1499, n - 5):
            enc = [(c + 1000) % 65536 if c else 31337 for c in kw]
            data[pos : pos + 5] = np.array(enc, dtype=np.uint16)
        offs, vals, info, over = sharded_fused_step(
            pat, data, mesh, n, tile_elems
        )
        assert over is None
        offs_s, vals_s = two_phase_candidates(pat, data)
        order = np.argsort(offs)
        assert offs[order].tolist() == offs_s.tolist()
        assert vals[order].tolist() == vals_s.tolist()

    def test_overflow_returns_global_counts(self, devices):
        from monkey_moore_tpu.dense import tile_counts
        from monkey_moore_tpu.parallel.sharded import sharded_fused_step
        import jax.numpy as jnp

        mesh = make_mesh(devices, n=2)
        tile_elems = 256
        data = np.tile(np.array([97, 98], dtype=np.uint8), 2048)
        pat = compile_pattern("abab")
        offs, vals, info, over = sharded_fused_step(
            pat, data, mesh, len(data), tile_elems, p_cap=8,
        )
        assert info.fallback and over is not None
        assert len(offs) == 0
        t = -(-len(data) // tile_elems)
        arr = np.zeros((t + 1) * tile_elems, dtype=np.uint8)
        arr[: len(data)] = data
        counts_single = tile_counts(
            pat, jnp.asarray(arr), len(data), tile_elems=tile_elems
        )
        assert over.tolist() == counts_single.tolist()


class TestHostRanges:
    def test_ranges_cover_file_with_halo(self):
        fs, L, s = 1000, 5, 2
        ranges = [host_byte_range(fs, L, s, index=i, count=4) for i in range(4)]
        halo = L * s - 1  # lossless: covers both alignment grids
        base = 250
        for i, (start, stop) in enumerate(ranges):
            assert start == min(i * base, fs)
            assert stop == min(start + base + halo, fs)
        # every possible match window is inside some host's range
        for b in range(0, fs - L * s + 1):
            assert any(
                start <= b and b + L * s <= stop for start, stop in ranges
            )

    def test_single_host_covers_all(self):
        assert host_byte_range(123, 4, 1, index=0, count=1) == (0, 123)


class TestEngineMultiDevice:
    """Engine configured with a device list shards each chunk across the
    mesh; results must match the single-device engine exactly."""

    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_engine_devices_parity(self, tmp_path, devices, n_dev, rng):
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine

        data = rng.integers(0, 256, 50_000).astype(np.uint8)
        enc = np.array([ord(c) + 2 for c in "parallel"], dtype=np.uint8)
        for pos in (17, 25_000, 49_990):
            data[pos : pos + 8] = enc
        path = tmp_path / "mesh.bin"
        path.write_bytes(data.tobytes())

        base = dict(file_path=path, keyword="parallel",
                    device_chunk_bytes=16_384)
        single = SearchEngine(SearchConfig(**base)).run()
        multi = SearchEngine(
            SearchConfig(**base, devices=devices[:n_dev])
        ).run()
        assert [r.offset for r in multi] == [r.offset for r in single]
        assert len(single) == 3
        assert [r.values_map for r in multi] == [r.values_map for r in single]


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert int(out[0]) >= 0

    def test_dryrun_multichip(self):
        import sys
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


class TestShardedResidentCorpus:
    """parallel/resident.py: the corpus uploads ONCE (NamedSharding over
    the data axis); every grid view is derived on device; repeat searches
    transfer zero corpus bytes; results match the host path on every mesh
    size."""

    def _make_file(self, tmp_path, rng, n=300_000):
        data = rng.integers(0, 256, n).astype(np.uint8)
        enc = np.array([ord(c) + 3 for c in "monkey"], dtype=np.uint8)
        for pos in (0, n // 3, n // 2 + 1, n - 6):
            data[pos : pos + 6] = enc
        p = tmp_path / "corpus.bin"
        p.write_bytes(data.tobytes())
        return p, data

    def test_grid_derivation_matches_host_decode(self, devices, rng):
        from monkey_moore_tpu.config import Endianness
        from monkey_moore_tpu.parallel.resident import ShardedResidentCorpus

        mesh = make_mesh(devices, n=4)
        nb = 3 * 4096 + 123
        data = rng.integers(0, 256, nb).astype(np.uint8)
        c = ShardedResidentCorpus(data, mesh, tile_elems=1024)
        pad = np.zeros(c.uploaded_bytes + 8, dtype=np.uint8)
        pad[:nb] = data
        for s, big, a in [(1, False, 0), (2, False, 0), (2, False, 1),
                          (2, True, 0), (2, True, 1)]:
            endian = Endianness.BIG if big else Endianness.LITTLE
            cnt = (c.uploaded_bytes - a) // s
            raw = pad[a : a + cnt * s]
            want = (
                raw if s == 1
                else raw.view(">u2" if big else "<u2").astype(np.uint16)
            )
            valid = (nb - a) // s
            flat = np.asarray(c.grid(s, endian, a))
            assert np.array_equal(flat[:valid], want[:valid]), (s, big, a)

    @pytest.mark.parametrize("n_dev", [1, 2, 8])
    def test_mesh_results_and_zero_reupload(
        self, devices, n_dev, tmp_path, rng
    ):
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.parallel import resident

        resident.clear_sharded_corpus_cache()
        p, _ = self._make_file(tmp_path, rng)
        want = [
            r.offset
            for r in SearchEngine(
                SearchConfig(file_path=p, keyword="monkey")
            ).run()
        ]
        assert len(want) == 4
        cfg = SearchConfig(
            file_path=p, keyword="monkey", devices=devices[:n_dev]
        )
        e1 = SearchEngine(cfg)
        assert [r.offset for r in e1.run()] == want
        assert e1.last_stats.h2d_bytes > 0  # first search uploads once
        assert e1.last_stats.device_dispatches == 1

        # repeat search: the corpus and the per-pattern operands are
        # resident — no corpus bytes cross host->device again
        e2 = SearchEngine(cfg)
        assert [r.offset for r in e2.run()] == want
        assert e2.last_stats.h2d_bytes == 0
        assert e2.last_stats.device_dispatches == 1

        # a different keyword still reuses the resident corpus
        e3 = SearchEngine(
            SearchConfig(file_path=p, keyword="onkey", devices=devices[:n_dev])
        )
        e3.run()
        assert e3.last_stats.h2d_bytes == 0

    def test_wildcard_and_value_scan_on_mesh(self, devices, tmp_path, rng):
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.parallel import resident

        resident.clear_sharded_corpus_cache()
        n = 120_000
        data = rng.integers(0, 256, n).astype(np.uint8)
        enc = np.array([ord(c) + 9 for c in "mon"], dtype=np.uint8)
        data[777 : 777 + 3] = enc
        data[60_000 : 60_003] = enc
        vals = np.array([40, 30, 20, 10], dtype=np.uint8)
        data[90_000:90_004] = vals
        p = tmp_path / "wc.bin"
        p.write_bytes(data.tobytes())
        for kw_cfg in (
            dict(keyword="m*n", wildcard="*"),
            dict(is_relative_search=False,
                 reference_values=[140, 130, 120, 110]),
        ):
            base = dict(file_path=p, **kw_cfg)
            want = [
                r.offset
                for r in SearchEngine(SearchConfig(**base)).run()
            ]
            got = [
                r.offset
                for r in SearchEngine(
                    SearchConfig(**base, devices=devices[:8])
                ).run()
            ]
            assert got == want and len(want) >= 1

    def test_overflow_falls_back_to_host_extraction(
        self, devices, tmp_path
    ):
        """A byte ramp matches everywhere -> p_cap overflow on every
        device -> counts fetch + host extraction, results still exact."""
        from monkey_moore_tpu.config import MatchSemantics, SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.parallel import resident

        resident.clear_sharded_corpus_cache()
        n = 64 * 1024
        data = (np.arange(n) & 0xFF).astype(np.uint8)
        p = tmp_path / "ramp.bin"
        p.write_bytes(data.tobytes())
        base = dict(
            file_path=p, keyword="abcde", semantics=MatchSemantics.ALL
        )
        want = [
            r.offset
            for r in SearchEngine(SearchConfig(**base)).run()
        ]
        e = SearchEngine(SearchConfig(**base, devices=devices[:4]))
        got = [r.offset for r in e.run()]
        assert got == want
        assert e.last_stats.fused_fallbacks >= 1

    def test_scaling_overhead_gate(self, devices, tmp_path, rng):
        """Structure regression gate (absolute CPU scaling is
        meaningless on virtual devices): per-search dispatch count and
        H2D bytes must be FLAT in mesh size — the collective dispatch
        per alignment grid does not multiply with devices, and the
        resident corpus keeps repeat-search H2D at zero on every mesh."""
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.parallel import resident

        p, _ = self._make_file(tmp_path, rng, n=200_000)
        per_mesh = {}
        for n_dev in (1, 2, 4, 8):
            resident.clear_sharded_corpus_cache()
            cfg = SearchConfig(
                file_path=p, keyword="monkey", devices=devices[:n_dev]
            )
            e1 = SearchEngine(cfg)
            e1.run()
            e2 = SearchEngine(cfg)
            e2.run()
            per_mesh[n_dev] = (
                e1.last_stats.device_dispatches,
                e2.last_stats.device_dispatches,
                e2.last_stats.h2d_bytes,
            )
        first = per_mesh[1]
        assert all(v == first for v in per_mesh.values()), per_mesh
        assert first[0] == first[1] == 1  # one collective dispatch/search
        assert first[2] == 0  # repeat searches: zero H2D


class TestLongPatternSmallShards:
    """Review regression: a pattern LONGER than the per-device byte count
    must not shrink tile_elems below the window length (shard/tile halos
    are exactly one tile — an undersized tile made boundary windows read
    shifted data: false positives AND misses)."""

    def test_mesh_resident_long_keyword(self, devices, tmp_path, rng):
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.parallel import resident

        resident.clear_sharded_corpus_cache()
        kw = "abcdefghijklmnopqrstuvwxyz" * 3  # 78 chars > 512/8 bytes
        data = rng.integers(0, 256, 512).astype(np.uint8)
        enc = np.array([ord(c) + 3 for c in kw], dtype=np.uint8)
        for pos in (0, 100, 200, 300, 512 - len(kw)):
            data[pos : pos + len(kw)] = enc
        p = tmp_path / "long.bin"
        p.write_bytes(data.tobytes())
        base = dict(file_path=p, keyword=kw)
        want = [
            r.offset for r in SearchEngine(SearchConfig(**base)).run()
        ]
        e = SearchEngine(SearchConfig(**base, devices=devices[:8]))
        got = [r.offset for r in e.run()]
        assert got == want
        assert 300 in got and (512 - len(kw)) in got

    def test_mesh_multi_long_keyword(self, devices, tmp_path, rng):
        from monkey_moore_tpu.multi import MultiSearcher
        from monkey_moore_tpu.parallel import resident

        resident.clear_sharded_corpus_cache()
        kw = "abcdefghijklmnopqrstuvwxyz" * 3
        data = rng.integers(0, 256, 512).astype(np.uint8)
        enc = np.array([ord(c) + 5 for c in kw], dtype=np.uint8)
        data[77 : 77 + len(kw)] = enc
        p = tmp_path / "longm.bin"
        p.write_bytes(data.tobytes())
        want = [
            [r.offset for r in g]
            for g in MultiSearcher(p).search([kw, "zzzzz"])
        ]
        got = [
            [r.offset for r in g]
            for g in MultiSearcher(p, devices=devices[:8]).search(
                [kw, "zzzzz"]
            )
        ]
        assert got == want
        assert got[0] == [77]


class TestMeshPipelining:
    """Round-5 regression: the mesh paths defer their result fetches
    behind later dispatches, like the single-device pipelined paths.

    Ordering is observed by monkeypatching the sharded-module seams the
    engine resolves at call time (``_sharded_fused_fn`` /
    ``parse_sharded_combos`` for the resident path,
    ``sharded_fused_step_start``/``_finish`` for the streaming chunk
    path)."""

    def test_resident_dual_alignment_back_to_back(
        self, devices, tmp_path, rng, monkeypatch
    ):
        """A 16-bit mesh search issues BOTH alignment grids' collective
        dispatches before paying either result fetch (mirrors the dual
        alignment structure of ``search_engine.cpp:129-159`` without 2x
        serialized transactions)."""
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.parallel import resident, sharded

        resident.clear_sharded_corpus_cache()
        nb = 120_000
        raw = rng.integers(0, 256, nb).astype(np.uint8)
        enc = np.array(
            [(ord(c) + 5) % 65536 for c in "monkey"], dtype="<u2"
        ).view(np.uint8)
        raw[2000 : 2000 + 12] = enc  # even byte alignment
        raw[3001 : 3001 + 12] = enc  # odd byte alignment
        p = tmp_path / "dual.bin"
        p.write_bytes(raw.tobytes())

        events = []
        real_factory = sharded._sharded_fused_fn
        real_parse = sharded.parse_sharded_combos

        def logged_factory(*a, **k):
            fn = real_factory(*a, **k)

            def call(*args):
                events.append("dispatch")
                return fn(*args)

            return call

        def logged_parse(*a, **k):
            events.append("parse")
            return real_parse(*a, **k)

        monkeypatch.setattr(sharded, "_sharded_fused_fn", logged_factory)
        monkeypatch.setattr(sharded, "parse_sharded_combos", logged_parse)

        cfg = SearchConfig(
            file_path=p, keyword="monkey", element_width=2,
            devices=devices[:4],
        )
        e = SearchEngine(cfg)
        offs = [r.offset for r in e.run()]
        assert 2000 in offs and 3001 in offs
        # both alignment dispatches are in flight before the first fetch
        assert events == ["dispatch", "dispatch", "parse", "parse"]
        assert e.last_stats.device_dispatches == 2
        # structural metrics recorded: one tile ppermuted per device per
        # dispatch; per-shard candidate balance present
        assert e.last_stats.ici_halo_bytes > 0
        assert e.last_stats.per_device_candidates is not None
        assert len(e.last_stats.per_device_candidates) == 4
        assert sum(e.last_stats.per_device_candidates) >= 2

    def test_streaming_mesh_chunks_pipeline(
        self, devices, tmp_path, rng, monkeypatch
    ):
        """With residency disabled, the chunked mesh path keeps
        ``pipeline_depth`` collective steps in flight (starts run ahead
        of finishes) and still produces exact results."""
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.parallel import resident, sharded

        resident.clear_sharded_corpus_cache()
        n = 256 * 1024
        data = rng.integers(0, 256, n).astype(np.uint8)
        enc = np.array([ord(c) + 3 for c in "monkey"], dtype=np.uint8)
        plants = [5, 70_000, 131_071, n - 6]  # one straddles chunk bound
        for pos in plants:
            data[pos : pos + 6] = enc
        p = tmp_path / "stream.bin"
        p.write_bytes(data.tobytes())

        events = []
        real_start = sharded.sharded_fused_step_start
        real_finish = sharded.sharded_fused_step_finish

        def logged_start(*a, **k):
            events.append("start")
            return real_start(*a, **k)

        def logged_finish(*a, **k):
            events.append("finish")
            return real_finish(*a, **k)

        monkeypatch.setattr(
            sharded, "sharded_fused_step_start", logged_start
        )
        monkeypatch.setattr(
            sharded, "sharded_fused_step_finish", logged_finish
        )

        want = [
            r.offset
            for r in SearchEngine(
                SearchConfig(file_path=p, keyword="monkey")
            ).run()
        ]
        assert sorted(plants) == want
        cfg = SearchConfig(
            file_path=p, keyword="monkey", devices=devices[:4],
            resident_bytes_limit=0,  # force the streaming chunk path
            device_chunk_bytes=64 * 1024, pipeline_depth=3,
        )
        e = SearchEngine(cfg)
        got = [r.offset for r in e.run()]
        assert got == want
        n_start = events.count("start")
        n_finish = events.count("finish")
        assert n_start == n_finish and n_start >= 4
        # pipelining: depth=3 steps stay in flight — the first fetch is
        # deferred until the 4th dispatch has been issued
        assert events[:5] == ["start"] * 4 + ["finish"]
