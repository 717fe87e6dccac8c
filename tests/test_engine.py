"""Engine-level integration tests (layer L3).

Port of ``tests/test_search_engine.cpp`` with the device twist: the reference's
threads × block-size partitioning-invariance sweep becomes a
match-semantics × block-size × device-chunk-size sweep — results must be
identical under every partitioning.
"""

import threading

import numpy as np
import pytest

from monkey_moore_tpu.config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
    SearchStep,
)
from monkey_moore_tpu.engine import SearchEngine, compute_search_blocks


def write_file(tmp_path, data: np.ndarray, name="blob.bin"):
    p = tmp_path / name
    p.write_bytes(np.ascontiguousarray(data).tobytes())
    return p


def text_u8(text: str, shift: int = 0) -> np.ndarray:
    return (np.array([ord(c) for c in text], dtype=np.int64) + shift).astype(
        np.uint8
    )


def text_u16(text: str, shift: int = 0) -> np.ndarray:
    return (np.array([ord(c) for c in text], dtype=np.int64) + shift).astype(
        np.uint16
    )


FILE_DATA_8 = np.array(
    # "text" encoded at offsets 0, 9, 27, 50, 60 (``test_search_engine.cpp:27-44``)
    [0x94, 0x85, 0x98, 0x94, 0x10, 0x10, 0x11, 0x11,
     0x00, 0x94, 0x85, 0x98, 0x94, 0x00, 0xFF, 0xFF,
     0x00, 0x00, 0x01, 0x0A, 0xFF, 0xFF, 0x00, 0x00,
     0x00, 0x94, 0x85, 0x94, 0x85, 0x98, 0x94, 0x00,
     0xFF, 0x00, 0x0A, 0xFF, 0xFF, 0x01, 0x00, 0x00,
     0xFF, 0x00, 0x0A, 0xFF, 0xFF, 0x01, 0x00, 0x00,
     0x00, 0xFF, 0x94, 0x85, 0x98, 0x94, 0x00, 0xFF,
     0x00, 0x01, 0xA5, 0xA1, 0x94, 0x85, 0x98, 0x94],
    dtype=np.uint8,
)

FILE_DATA_16 = np.array(
    # byte offsets 0, 18, 54, 100, 120 (``test_search_engine.cpp:84-101``)
    [0x1094, 0x1085, 0x1098, 0x1094, 0x0010, 0x0010, 0x0011, 0x0011,
     0x0000, 0x1094, 0x1085, 0x1098, 0x1094, 0x0000, 0xFFFF, 0xFFFF,
     0x0000, 0x0000, 0x0001, 0x000A, 0xFFFF, 0xFFFF, 0x0000, 0x0000,
     0x0000, 0x1094, 0x1085, 0x1094, 0x1085, 0x1098, 0x1094, 0x0000,
     0xFFFF, 0x0000, 0x000A, 0xFFFF, 0xFFFF, 0x0001, 0x0000, 0x0000,
     0xFFFF, 0x0000, 0x000A, 0xFFFF, 0xFFFF, 0x0001, 0x0000, 0x0000,
     0x0000, 0xFFFF, 0x1094, 0x1085, 0x1098, 0x1094, 0x0000, 0x00FF,
     0x0000, 0x0110, 0xA510, 0x01A1, 0x1094, 0x1085, 0x1098, 0x1094],
    dtype=np.uint16,
)


class TestCorrectness8Bit:
    # ``test_search_engine.cpp:26-81``; host_thr 0 forces the device scan,
    # the default routes these small files to the host latency path — both
    # must produce the identical list
    @pytest.mark.parametrize("semantics", [MatchSemantics.GREEDY, MatchSemantics.REFERENCE])
    # 128: larger than file; 8: divisible; 23: misaligned; 29: splits keyword
    @pytest.mark.parametrize("block_size", [128, 8, 23, 29])
    @pytest.mark.parametrize("chunk_bytes", [37, 4096])
    @pytest.mark.parametrize("host_thr", [0, None])
    def test_all_partitionings(self, tmp_path, semantics, block_size,
                               chunk_bytes, host_thr):
        path = write_file(tmp_path, FILE_DATA_8)
        cfg = SearchConfig(
            file_path=path,
            keyword="text",
            preferred_search_block_size=block_size,
            preferred_preview_width=4,
            device_chunk_bytes=chunk_bytes,
            semantics=semantics,
        )
        if host_thr is not None:
            cfg.host_latency_threshold_bytes = host_thr
        results = SearchEngine(cfg).run()
        assert [r.offset for r in results] == [0, 9, 27, 50, 60]


class TestCorrectness16Bit:
    # ``test_search_engine.cpp:83-159``
    @pytest.mark.parametrize("semantics", [MatchSemantics.GREEDY, MatchSemantics.REFERENCE])
    @pytest.mark.parametrize("block_size", [256, 16, 47, 58])
    @pytest.mark.parametrize("host_thr", [0, None])
    def test_little_endian(self, tmp_path, semantics, block_size, host_thr):
        path = write_file(tmp_path, FILE_DATA_16.astype("<u2"))
        cfg = SearchConfig(
            file_path=path,
            keyword="text",
            element_width=2,
            preferred_search_block_size=block_size,
            device_chunk_bytes=64,
            semantics=semantics,
        )
        if host_thr is not None:
            cfg.host_latency_threshold_bytes = host_thr
        results = SearchEngine(cfg).run()
        assert [r.offset for r in results] == [0, 18, 54, 100, 120]

    @pytest.mark.parametrize("semantics", [MatchSemantics.GREEDY, MatchSemantics.REFERENCE])
    @pytest.mark.parametrize("block_size", [512, 24, 47, 58])
    @pytest.mark.parametrize("host_thr", [0, None])
    def test_big_endian(self, tmp_path, semantics, block_size, host_thr):
        path = write_file(tmp_path, FILE_DATA_16.astype(">u2").view(np.uint8))
        cfg = SearchConfig(
            file_path=path,
            keyword="text",
            element_width=2,
            endianness=Endianness.BIG,
            preferred_search_block_size=block_size,
            device_chunk_bytes=64,
            semantics=semantics,
        )
        if host_thr is not None:
            cfg.host_latency_threshold_bytes = host_thr
        results = SearchEngine(cfg).run()
        assert [r.offset for r in results] == [0, 18, 54, 100, 120]


class TestPreview8Bit:
    # ``test_search_engine.cpp:161-236``
    def make_cfg(self, path, keyword, width):
        return SearchConfig(
            file_path=path,
            keyword=keyword,
            preferred_search_block_size=16,
            preferred_preview_width=width,
        )

    def test_preview_text(self, tmp_path):
        text = "#####the theater's theatrical theatergoer thanked the theatrical theater's theatrics####"
        path = write_file(tmp_path, text_u8(text, 0x10))
        results = SearchEngine(self.make_cfg(path, "theater", 25)).run(
            generate_previews=True
        )
        assert [(r.offset, r.preview) for r in results] == [
            (9, "#####the#theater#s#theatr"),
            (30, "eatrical#theatergoer#than"),
            (65, "eatrical#theater#s#theatr"),
        ]

    def test_match_at_start(self, tmp_path):
        path = write_file(tmp_path, text_u8("match me please# \0", 0x0A))
        results = SearchEngine(self.make_cfg(path, "match", 8)).run(
            generate_previews=True
        )
        assert len(results) == 1
        assert results[0].offset == 0
        assert results[0].preview == "match#me"

    def test_match_at_end(self, tmp_path):
        path = write_file(tmp_path, text_u8("###reach the final", 0x2A))
        results = SearchEngine(self.make_cfg(path, "final", 9)).run(
            generate_previews=True
        )
        assert len(results) == 1
        assert results[0].offset == 13
        assert results[0].preview == "the#final"

    def test_match_larger_than_window(self, tmp_path):
        path = write_file(
            tmp_path, text_u8("community#understanding#information", -0x1F)
        )
        results = SearchEngine(self.make_cfg(path, "understanding", 11)).run(
            generate_previews=True
        )
        assert len(results) == 1
        assert results[0].offset == 10
        assert results[0].preview == "nderstandin"


class TestPreview16Bit:
    # ``test_search_engine.cpp:238-296``
    def make_cfg(self, path, keyword, width):
        return SearchConfig(
            file_path=path,
            keyword=keyword,
            element_width=2,
            preferred_search_block_size=32,
            preferred_preview_width=width,
        )

    def test_preview_text(self, tmp_path):
        text = "#####the theater's theatrical theatergoer thanked the theatrical theater's theatrics####"
        path = write_file(tmp_path, text_u16(text, 0x20).astype("<u2"))
        results = SearchEngine(self.make_cfg(path, "theater", 25)).run(
            generate_previews=True
        )
        assert [(r.offset, r.preview) for r in results] == [
            (18, "#####the#theater#s#theatr"),
            (60, "eatrical#theatergoer#than"),
            (130, "eatrical#theater#s#theatr"),
        ]

    def test_match_at_start(self, tmp_path):
        path = write_file(tmp_path, text_u16("catch me please# \0").astype("<u2"))
        results = SearchEngine(self.make_cfg(path, "catch", 8)).run(
            generate_previews=True
        )
        assert len(results) == 1
        assert results[0].offset == 0
        assert results[0].preview == "catch#me"

    def test_match_at_end(self, tmp_path):
        path = write_file(tmp_path, text_u16("###the final step").astype("<u2"))
        results = SearchEngine(self.make_cfg(path, "step", 9)).run(
            generate_previews=True
        )
        assert len(results) == 1
        assert results[0].offset == 26
        assert results[0].preview == "inal#step"


class TestPreviewCustomSeq:
    # ``test_search_engine.cpp:298-348``
    UNICODE_HIRAGANA = "".join(chr(c) for c in range(0x3041, 0x30A0))

    def test_8bit_mode(self, tmp_path):
        content = "あした、わたしたちは、にわに、はなを、まきます"
        data = np.array(
            [(ord(c) - 0x3000) & 0xFF for c in content], dtype=np.uint8
        )
        path = write_file(tmp_path, data)
        cfg = SearchConfig(
            file_path=path,
            keyword="わたしたちは",
            custom_char_seq=self.UNICODE_HIRAGANA,
            preferred_search_block_size=64,
            preferred_preview_width=14,
        )
        results = SearchEngine(cfg).run(generate_previews=True)
        assert len(results) == 1
        assert results[0].offset == 4
        assert results[0].preview == "あした#わたしたちは#にわに"

    def test_16bit_mode(self, tmp_path):
        content = "あした、わたしたちは、にわに、はなを、まきます"
        data = np.array([ord(c) for c in content], dtype=np.uint16)
        path = write_file(tmp_path, data.astype("<u2"))
        cfg = SearchConfig(
            file_path=path,
            keyword="わたしたちは",
            custom_char_seq=self.UNICODE_HIRAGANA,
            element_width=2,
            preferred_search_block_size=64,
            preferred_preview_width=14,
        )
        results = SearchEngine(cfg).run(generate_previews=True)
        assert len(results) == 1
        assert results[0].offset == 8
        assert results[0].preview == "あした#わたしたちは#にわに"


class TestErrorHandling:
    # ``test_search_engine.cpp:350-360``
    def test_missing_file_raises(self):
        cfg = SearchConfig(file_path="path/to/inexistent/file", keyword="abc")
        with pytest.raises(FileNotFoundError):
            SearchEngine(cfg).run()


class TestProgress:
    # ``test_search_engine.cpp:362-397``
    def test_monotonic_with_exact_count(self, tmp_path):
        path = write_file(tmp_path, np.zeros(128, dtype=np.uint8))
        cfg = SearchConfig(
            file_path=path,
            keyword="text",
            preferred_search_block_size=16,
        )
        history = []
        SearchEngine(cfg).run(lambda pct, step: history.append(pct))
        # 8 block callbacks + init + search-start + previews-start
        assert len(history) == 11
        assert history[-1] == 100
        assert all(b >= a for a, b in zip(history, history[1:]))

    def test_reference_semantics_same_count(self, tmp_path):
        path = write_file(tmp_path, np.zeros(128, dtype=np.uint8))
        cfg = SearchConfig(
            file_path=path,
            keyword="text",
            preferred_search_block_size=16,
            semantics=MatchSemantics.REFERENCE,
        )
        history = []
        SearchEngine(cfg).run(lambda pct, step: history.append(pct))
        assert len(history) == 11
        assert history[-1] == 100


class TestAbort:
    # ``test_search_engine.cpp:399-427``
    def test_saboteur_abort(self, tmp_path):
        path = write_file(
            tmp_path, text_u8("match#catch#batch#match#patch#hatch#match", 0x30)
        )
        cfg = SearchConfig(
            file_path=path,
            keyword="match",
            preferred_search_block_size=5,
        )
        abort = threading.Event()
        count = [0]

        def saboteur(pct, step):
            count[0] += 1
            if count[0] >= 5:
                abort.set()

        results = SearchEngine(cfg).run(saboteur, abort)
        assert results == []
        assert count[0] <= 5


class TestCustomWildcard:
    # ``test_search_engine.cpp:429-447``
    def test_dollar_wildcard(self, tmp_path):
        path = write_file(
            tmp_path, text_u8("match#catch#batch#match#patch#hatch#match", -0x15)
        )
        cfg = SearchConfig(
            file_path=path,
            keyword="$atch",
            wildcard="$",
            preferred_search_block_size=20,
        )
        results = SearchEngine(cfg).run()
        assert len(results) == 7


class TestShortHaloQuirk:
    """The reference's block halo is ``(L-1)*element_size`` bytes
    (``search_engine.cpp:227``) — one element short for the odd alignment
    grid, so an odd-aligned 16-bit match just before a block boundary is
    missed.  GREEDY and REFERENCE semantics replicate the miss; ALL reports
    the match."""

    def make_file(self, tmp_path):
        # base=16, L=4 ("text"): block 0 reads 22 bytes; odd grid count =
        # floor(21/2) = 10 → last fitting start j=6 (byte 13). A match at
        # byte 15 (j=7) pokes past the trimmed count and is unreachable from
        # block 1 (whose odd grid starts at byte 17).
        raw = np.zeros(40, dtype=np.uint8)
        enc = np.array([0x94, 0x85, 0x98, 0x94], dtype=np.uint16)
        raw[15:23] = enc.astype("<u2").view(np.uint8)
        p = tmp_path / "quirk.bin"
        p.write_bytes(raw.tobytes())
        return p

    @pytest.mark.parametrize(
        "semantics,expected",
        [
            (MatchSemantics.GREEDY, []),
            (MatchSemantics.REFERENCE, []),
            (MatchSemantics.ALL, [15]),
        ],
    )
    def test_semantics(self, tmp_path, semantics, expected):
        cfg = SearchConfig(
            file_path=self.make_file(tmp_path),
            keyword="text",
            element_width=2,
            preferred_search_block_size=16,
            semantics=semantics,
        )
        results = SearchEngine(cfg).run()
        assert [r.offset for r in results] == expected

    def test_found_with_larger_blocks(self, tmp_path):
        # With the block boundary elsewhere, all semantics agree.
        cfg = SearchConfig(
            file_path=self.make_file(tmp_path),
            keyword="text",
            element_width=2,
            preferred_search_block_size=512,
        )
        results = SearchEngine(cfg).run()
        assert [r.offset for r in results] == [15]


class TestDenseMatchFallback:
    """Engine-level coverage of the fused step's capacity-overflow path: a
    byte ramp matches ``abcde`` at EVERY window (all diffs are 1), blowing
    past ``p_cap`` so every chunk takes the counts-fetch + batched-gather
    fallback — results must still be exact and the degradation must be
    surfaced in ``SearchStats.fused_fallbacks``."""

    @pytest.mark.parametrize(
        "semantics", [MatchSemantics.ALL, MatchSemantics.GREEDY]
    )
    def test_ramp_overflow_exact_and_counted(self, tmp_path, semantics):
        n = 8192
        data = (np.arange(n) & 0xFF).astype(np.uint8)
        path = write_file(tmp_path, data)
        cfg = SearchConfig(
            file_path=path,
            keyword="abcde",
            device_chunk_bytes=4096,
            semantics=semantics,
            host_latency_threshold_bytes=0,  # force the device path under test
        )
        engine = SearchEngine(cfg)
        results = engine.run()
        offsets = [r.offset for r in results]
        # windows crossing the 255->0 ramp wrap fail the EXACT signed
        # compare (diff -255, not +1) — they are precisely the mod-256
        # prefilter false positives phase 2 must reject
        exact = [p for p in range(n - 4) if p % 256 <= 251]
        if semantics is MatchSemantics.ALL:
            assert offsets == exact
        else:
            # greedy advance = L-1 = 4 over the exact candidate list
            assert offsets == [p for p in exact if p % 4 == 0]
        stats = engine.last_stats
        assert stats.fused_fallbacks >= 1
        assert "DEGRADED" in stats.summary()
        # recovered map decodes 'a' to the window's base data value
        for r in results[:3]:
            assert r.values_map[ord("a")] == (r.offset & 0xFF)


class TestReferenceThreadPool:
    """``_scan_reference`` walks blocks over a ≤N-worker pool (the mirror
    of the reference's ``std::async`` block pool,
    ``search_engine.cpp:82-175``).  Results and the progress callback
    sequence must be invariant in the thread count."""

    @pytest.mark.parametrize("width", [1, 2])
    def test_thread_count_invariance(self, tmp_path, width):
        rng = np.random.default_rng(13)
        dtype = np.uint8 if width == 1 else np.uint16
        mod = 1 << (8 * width)
        data = rng.integers(0, mod, 60_000).astype(dtype)
        enc = (text_u8 if width == 1 else text_u16)("monkey", 5)
        for pos in (7, 20_003, 40_000, len(data) - 6):
            data[pos : pos + 6] = enc.astype(dtype)
        kind = ">u2" if width == 2 else "<u1"
        path = write_file(
            tmp_path,
            data.astype(kind).view(np.uint8) if width == 2 else data,
        )

        def run(threads):
            cfg = SearchConfig(
                file_path=path,
                keyword="monkey",
                element_width=width,
                endianness=Endianness.BIG if width == 2 else
                Endianness.LITTLE,
                semantics=MatchSemantics.REFERENCE,
                preferred_search_block_size=4096,  # many blocks
                preferred_num_threads=threads,
            )
            seen = []
            res = SearchEngine(cfg).run(
                on_progress=lambda pct, step: seen.append((pct, step))
            )
            return [r.offset for r in res], [r.values_map for r in res], seen

        offs1, maps1, prog1 = run(1)
        assert offs1 == [
            7 * width, 20_003 * width, 40_000 * width,
            (len(data) - 6) * width,
        ]
        for threads in (2, 4, 0):  # 0 = auto (hardware concurrency)
            offs, maps, prog = run(threads)
            assert offs == offs1
            assert maps == maps1
            # equal float increments: the pct sequence is completion-order
            # independent (``search_engine.cpp:161-165``)
            assert prog == prog1

    def test_abort_with_pool(self, tmp_path):
        data = np.zeros(80_000, dtype=np.uint8)
        path = write_file(tmp_path, data)
        flag = threading.Event()

        def saboteur(pct, step):
            if step is SearchStep.SEARCHING and pct >= 30:
                flag.set()

        cfg = SearchConfig(
            file_path=path, keyword="never",
            semantics=MatchSemantics.REFERENCE,
            preferred_search_block_size=2048,
            preferred_num_threads=4,
        )
        assert SearchEngine(cfg).run(
            on_progress=saboteur, abort_flag=flag
        ) == []


class TestPipelinedFusedSteps:
    """The resident path keeps ``pipeline_depth`` fused dispatches in
    flight (chunk k+1 dispatched before chunk k's result fetch).  Results
    and the per-block progress callback sequence must be identical at
    every depth, including with abort mid-pipeline."""

    @pytest.mark.parametrize("width", [1, 2])
    def test_depth_invariance(self, tmp_path, width):
        rng = np.random.default_rng(11)
        dtype = np.uint8 if width == 1 else np.uint16
        mod = 1 << (8 * width)
        data = rng.integers(0, mod, 120_000).astype(dtype)
        enc = (text_u8 if width == 1 else text_u16)("monkey", 3)
        for pos in (0, 30_001, 59_999, 90_000, len(data) - 6):
            data[pos : pos + 6] = enc.astype(dtype)
        path = write_file(tmp_path, data.astype(f"<u{width}"))

        def run(depth):
            cfg = SearchConfig(
                file_path=path,
                keyword="monkey",
                element_width=width,
                device_chunk_bytes=16_384,  # many chunks: real pipelining
                host_latency_threshold_bytes=0,  # force the resident path
                pipeline_depth=depth,
            )
            seen = []
            eng = SearchEngine(cfg)
            res = eng.run(
                on_progress=lambda pct, step: seen.append((pct, step))
            )
            assert eng.last_stats.fused_steps >= 4
            return [r.offset for r in res], seen

        offs1, prog1 = run(1)
        assert offs1 == [
            0, 30_001 * width, 59_999 * width, 90_000 * width,
            (len(data) - 6) * width,
        ]
        for depth in (2, 4):
            offs, prog = run(depth)
            assert offs == offs1
            assert prog == prog1

    def test_abort_mid_pipeline(self, tmp_path):
        data = np.zeros(200_000, dtype=np.uint8)
        path = write_file(tmp_path, data)
        flag = threading.Event()

        def saboteur(pct, step):
            if step is SearchStep.SEARCHING and pct >= 40:
                flag.set()

        cfg = SearchConfig(
            file_path=path, keyword="never",
            device_chunk_bytes=16_384,
            host_latency_threshold_bytes=0,
            pipeline_depth=3,
        )
        eng = SearchEngine(cfg)
        assert eng.run(on_progress=saboteur, abort_flag=flag) == []


class TestHostRoute:
    """Small-input latency path (``engine._scan_host``): searches at or
    below ``host_latency_threshold_bytes`` must bypass the device entirely
    (the reference's whole benchmark range, 128 KiB-16 MiB, is
    dispatch-bound on a device) and return results identical to the device
    path."""

    def _offsets(self, cfg):
        eng = SearchEngine(cfg)
        res = eng.run()
        return [r.offset for r in res], [r.values_map for r in res], eng

    @pytest.mark.parametrize(
        "semantics", [MatchSemantics.GREEDY, MatchSemantics.ALL]
    )
    def test_routing_and_equivalence(self, tmp_path, semantics):
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, 300_000).astype(np.uint8)
        enc = text_u8("monkey", 3)
        for pos in (0, 131_071, 150_000, len(data) - 6):
            data[pos : pos + 6] = enc
        path = write_file(tmp_path, data)
        base = dict(file_path=path, keyword="monkey", semantics=semantics)
        offs_h, maps_h, eng_h = self._offsets(SearchConfig(**base))
        offs_d, maps_d, eng_d = self._offsets(
            SearchConfig(**base, host_latency_threshold_bytes=0)
        )
        assert eng_h.last_stats.host_routed
        assert eng_h.last_stats.device_dispatches == 0
        assert not eng_d.last_stats.host_routed
        assert eng_d.last_stats.device_dispatches > 0
        assert offs_h == offs_d
        assert maps_h == maps_d
        assert 0 in offs_h and (len(data) - 6) in offs_h

    def test_equivalence_16bit_wildcard_be(self, tmp_path):
        rng = np.random.default_rng(6)
        data = rng.integers(0, 65536, 80_000).astype(np.uint16)
        enc = text_u16("dra?on", -16)
        enc[3] = 12345  # wildcard position: arbitrary value
        for pos in (17, 40_000, len(data) - 6):
            data[pos : pos + 6] = enc
        path = write_file(tmp_path, data.astype(">u2").view(np.uint8))
        base = dict(
            file_path=path, keyword="dra?on", wildcard="?",
            element_width=2, endianness=Endianness.BIG,
        )
        offs_h, maps_h, eng_h = self._offsets(SearchConfig(**base))
        offs_d, maps_d, _ = self._offsets(
            SearchConfig(**base, host_latency_threshold_bytes=0)
        )
        assert eng_h.last_stats.host_routed
        assert offs_h == offs_d and maps_h == maps_d
        assert 34 in offs_h  # byte offset of the element-17 plant

    def test_threshold_boundary(self, tmp_path):
        data = np.zeros(4096, dtype=np.uint8)
        data[100:105] = text_u8("texts", 7)
        path = write_file(tmp_path, data)
        base = dict(file_path=path, keyword="texts")
        _, _, at = self._offsets(
            SearchConfig(**base, host_latency_threshold_bytes=4096)
        )
        assert at.last_stats.host_routed  # at the threshold: host
        _, _, below = self._offsets(
            SearchConfig(**base, host_latency_threshold_bytes=4095)
        )
        assert not below.last_stats.host_routed  # just below: device

    def test_progress_parity_and_abort(self, tmp_path):
        """The host path emits the identical per-block callback sequence
        (float-accumulated percentages) as the device path, and honors
        abort mid-scan."""
        data = np.zeros(100_000, dtype=np.uint8)
        path = write_file(tmp_path, data)
        base = dict(
            file_path=path, keyword="never", preferred_search_block_size=7000
        )

        def collect(cfg):
            seen = []
            SearchEngine(cfg).run(
                on_progress=lambda pct, step: seen.append((pct, step))
            )
            return seen

        host_seen = collect(SearchConfig(**base))
        dev_seen = collect(
            SearchConfig(**base, host_latency_threshold_bytes=0)
        )
        assert host_seen == dev_seen

        flag = threading.Event()

        def saboteur(pct, step):
            if step is SearchStep.SEARCHING and pct >= 50:
                flag.set()

        eng = SearchEngine(SearchConfig(**base))
        res = eng.run(on_progress=saboteur, abort_flag=flag)
        assert res == []
        assert eng.last_stats.host_routed

    def test_devices_config_still_uses_mesh(self, tmp_path):
        """An explicit ``devices=`` list must keep the mesh path even for
        small files (the user asked for the mesh)."""
        import jax

        data = np.zeros(8192, dtype=np.uint8)
        data[50:54] = text_u8("text", 9)
        path = write_file(tmp_path, data)
        cfg = SearchConfig(
            file_path=path, keyword="text", devices=jax.devices()[:2]
        )
        eng = SearchEngine(cfg)
        results = eng.run()
        assert [r.offset for r in results] == [50]
        assert not eng.last_stats.host_routed


class TestBlockMath:
    def test_compute_search_blocks_parity(self):
        # overlap = (len-1)*s; starts advance by base; clipped at EOF
        blocks = compute_search_blocks(64, 4, 1, 29)
        assert blocks == [(0, 32), (29, 32), (58, 6)]
        blocks = compute_search_blocks(128, 4, 2, 16)
        assert blocks == [(i * 16, min(22, 128 - i * 16)) for i in range(8)]


class TestStreamingFusedPath:
    """Files over the residency limit stream chunks through the same
    pipelined fused step as the resident path (upload + dispatch of chunk
    k+1 overlaps chunk k's fetch)."""

    @pytest.mark.parametrize("width", [1, 2])
    def test_streamed_equals_resident(self, tmp_path, width):
        rng = np.random.default_rng(17)
        dtype = np.uint8 if width == 1 else np.uint16
        mod = 1 << (8 * width)
        data = rng.integers(0, mod, 90_000).astype(dtype)
        enc = (text_u8 if width == 1 else text_u16)("monkey", 4)
        for pos in (1, 30_000, 60_001, len(data) - 6):
            data[pos : pos + 6] = enc.astype(dtype)
        path = write_file(tmp_path, data.astype(f"<u{width}"))
        base = dict(
            file_path=path, keyword="monkey", element_width=width,
            device_chunk_bytes=16_384, host_latency_threshold_bytes=0,
        )
        res_eng = SearchEngine(SearchConfig(**base))
        want = [r.offset for r in res_eng.run()]
        assert want == [1 * width, 30_000 * width, 60_001 * width,
                        (len(data) - 6) * width]
        stream_eng = SearchEngine(
            SearchConfig(**base, resident_bytes_limit=0)
        )
        got = [r.offset for r in stream_eng.run()]
        assert got == want
        st = stream_eng.last_stats
        assert st.fused_steps >= 4  # the fused pipeline ran
        assert st.h2d_bytes > 0  # streamed chunks were uploaded


class TestHugePattern:
    """Patterns longer than one count tile (> dense.TILE_ELEMS elements)
    cannot ride the dense device paths (chunk arrays carry exactly one
    halo tile); the engine must route them to the host scanner, which is
    exact at any length."""

    def test_value_scan_longer_than_tile(self, tmp_path):
        from monkey_moore_tpu.dense import TILE_ELEMS

        L = TILE_ELEMS + 7
        # sawtooth with no uint8 wrap after the +11 shift, so the planted
        # copy has identical SIGNED adjacent diffs (value-scan semantics)
        vals = (np.arange(L) % 200).astype(np.int64)
        data = np.zeros(L + 500, dtype=np.uint8)
        data[100 : 100 + L] = (vals + 11).astype(np.uint8)
        path = write_file(tmp_path, data)
        cfg = SearchConfig(
            file_path=path,
            is_relative_search=False,
            reference_values=vals.tolist(),
            host_latency_threshold_bytes=0,  # would force device — the
            # huge-pattern guard must override and stay on the host
        )
        eng = SearchEngine(cfg)
        results = eng.run()
        assert [r.offset for r in results] == [100]
        assert eng.last_stats.host_routed
        assert eng.last_stats.device_dispatches == 0
