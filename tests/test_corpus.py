"""Resident device-corpus tests: result parity with the streaming path,
cache reuse, and invalidation."""

import numpy as np
import pytest

from monkey_moore_tpu.config import Endianness, SearchConfig
from monkey_moore_tpu.corpus import clear_corpus_cache, get_resident_corpus
from monkey_moore_tpu.engine import SearchEngine


def make_rom(tmp_path, n=200_000, seed=1, width=1, plant=b"resident"):
    rng = np.random.default_rng(seed)
    mod = 256 if width == 1 else 65536
    dtype = np.uint8 if width == 1 else np.uint16
    data = rng.integers(0, mod, n).astype(dtype)
    enc = (np.frombuffer(plant, dtype=np.uint8).astype(np.int64) + 9) % mod
    data[n // 2 : n // 2 + len(enc)] = enc.astype(dtype)
    p = tmp_path / "rom.bin"
    p.write_bytes(data.astype("<u2").tobytes() if width == 2 else data.tobytes())
    return p


class TestResidency:
    def setup_method(self):
        clear_corpus_cache()

    @pytest.mark.parametrize("width", [1, 2])
    def test_resident_matches_streaming(self, tmp_path, width):
        path = make_rom(tmp_path, width=width)
        base = dict(
            file_path=path,
            keyword="resident",
            element_width=width,
            device_chunk_bytes=65536,
        )
        res_resident = SearchEngine(SearchConfig(**base)).run()
        res_streaming = SearchEngine(
            SearchConfig(**base, resident_bytes_limit=0)
        ).run()
        assert [r.offset for r in res_resident] == [
            r.offset for r in res_streaming
        ]
        assert len(res_resident) >= 1

    def test_big_endian_resident(self, tmp_path):
        rng = np.random.default_rng(5)
        data = rng.integers(0, 65536, 50_000).astype(np.uint16)
        enc = np.array([ord(c) + 30 for c in "bigend"], dtype=np.uint16)
        data[10_001 : 10_001 + 6] = enc
        p = tmp_path / "be.bin"
        p.write_bytes(data.astype(">u2").tobytes())
        cfg = SearchConfig(
            file_path=p,
            keyword="bigend",
            element_width=2,
            endianness=Endianness.BIG,
        )
        res = SearchEngine(cfg).run()
        assert [r.offset for r in res] == [20_002]

    def test_cache_reused_across_searches(self, tmp_path):
        path = make_rom(tmp_path)
        cfg = SearchConfig(file_path=path, keyword="resident")
        e1 = SearchEngine(cfg)
        e1.run()
        first_upload = e1.last_stats.stage_seconds.get("corpus_upload", 0)
        c1 = get_resident_corpus(path, path.stat().st_size, 1 << 30, 1024)
        c2 = get_resident_corpus(path, path.stat().st_size, 1 << 30, 1024)
        assert c1 is c2  # cache hit returns the same resident object

    def test_mtime_invalidation(self, tmp_path):
        path = make_rom(tmp_path)
        size = path.stat().st_size
        c1 = get_resident_corpus(path, size, 1 << 30, 1024)
        import os

        os.utime(path, ns=(123456789, 987654321))
        c2 = get_resident_corpus(path, size, 1 << 30, 1024)
        assert c1 is not c2

    def test_over_limit_returns_none(self, tmp_path):
        path = make_rom(tmp_path)
        assert get_resident_corpus(path, path.stat().st_size, 1000, 64) is None


GRID_CASES = [
    (s, big, align, e_start)
    for s in (1, 2)
    for big in ((False,) if s == 1 else (False, True))
    for align in range(s)
    # e_start 0 plus values putting b0 at every byte shift within a word
    for e_start in (0, 1, 2, 3, 5, 101)
]


class TestGridDerivation:
    """corpus._grid_fn: every (width, endianness, alignment, word-shift)
    combination of the word-arithmetic grid derivation must equal the host
    decode — including e_start offsets that land mid-word (byte_shift
    1/2/3)."""

    @pytest.mark.parametrize("s,big,align,e_start", GRID_CASES)
    def test_all_grid_shapes_vs_host(self, rng, s, big, align, e_start):
        from monkey_moore_tpu.corpus import ResidentCorpus

        nb = 4096 + 37
        data = rng.integers(0, 256, nb).astype(np.uint8)
        c = ResidentCorpus(data, pad_bytes=256)
        pad = np.zeros(nb + 512, dtype=np.uint8)
        pad[:nb] = data

        endian = Endianness.BIG if big else Endianness.LITTLE
        b0 = align + e_start * s
        want = 512
        got = np.asarray(c.grid_chunk(s, endian, align, e_start, want))
        assert got.dtype == (np.uint8 if s == 1 else np.uint16)
        assert len(got) == want
        raw = pad[b0 : b0 + want * s]
        expect = (
            raw if s == 1
            else raw.view(">u2" if big else "<u2").astype(np.uint16)
        )
        assert np.array_equal(got, expect)


class TestUploadFailure:
    """A device that refuses the resident upload must not turn silently
    into streaming: the failure is counted in SearchStats and the search
    still returns the exact result through the streaming path."""

    def setup_method(self):
        clear_corpus_cache()

    def test_refused_upload_counted(self, tmp_path, monkeypatch):
        import jax

        from monkey_moore_tpu import corpus

        def refuse(self, data_bytes, pad_bytes):
            raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: test")

        monkeypatch.setattr(corpus.ResidentCorpus, "__init__", refuse)
        path = make_rom(tmp_path)
        base = dict(file_path=path, keyword="resident",
                    host_latency_threshold_bytes=0)
        e = SearchEngine(SearchConfig(**base))
        got = [r.offset for r in e.run()]
        assert e.last_stats.resident_upload_failures == 1
        assert e.last_stats.h2d_bytes > 0  # streamed chunks instead
        monkeypatch.undo()
        clear_corpus_cache()
        want = [
            r.offset for r in SearchEngine(
                SearchConfig(**base, resident_bytes_limit=0)
            ).run()
        ]
        assert got == want and len(want) >= 1

    def test_unreadable_file_is_not_an_upload_failure(self, tmp_path):
        stats_path = make_rom(tmp_path)
        from monkey_moore_tpu.profiling import SearchStats

        stats = SearchStats()
        assert get_resident_corpus(
            stats_path, stats_path.stat().st_size, 1000, 64, stats=stats
        ) is None  # over the limit: not eligible, not a failure
        assert stats.resident_upload_failures == 0
