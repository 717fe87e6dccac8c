"""MultiSearcher tests: per-keyword parity with the engine, mixed modes,
previews."""

import numpy as np
import pytest

from monkey_moore_tpu.config import Endianness, MatchSemantics, SearchConfig
from monkey_moore_tpu.engine import SearchEngine
from monkey_moore_tpu.multi import MultiSearcher


@pytest.fixture
def rom8(tmp_path, rng):
    data = rng.integers(0, 256, 100_000).astype(np.uint8)
    plants = {
        "sword": 1000,
        "shield": 50_000,
        "potion": 99_000,
    }
    for word, pos in plants.items():
        enc = np.array([ord(c) + 7 for c in word], dtype=np.uint8)
        data[pos : pos + len(enc)] = enc
    p = tmp_path / "rom8.bin"
    p.write_bytes(data.tobytes())
    return p, plants


class TestMultiSearcher:
    def test_parity_with_engine(self, rom8):
        path, plants = rom8
        specs = list(plants.keys()) + ["missing"]
        ms = MultiSearcher(path, device_chunk_bytes=32768)
        multi = ms.search(specs)
        for spec, got in zip(specs, multi):
            cfg = SearchConfig(
                file_path=path, keyword=spec, device_chunk_bytes=32768
            )
            single = SearchEngine(cfg).run()
            assert [r.offset for r in got] == [r.offset for r in single], spec
            assert [r.values_map for r in got] == [
                r.values_map for r in single
            ], spec
        assert [r.offset for r in multi[0]] == [plants["sword"]]
        assert multi[3] == []

    def test_mixed_specs_and_previews(self, rom8):
        path, plants = rom8
        ms = MultiSearcher(path)
        got = ms.search(
            ["sword", {"keyword": "shi*ld", "wildcard": "*"}],
            generate_previews=True,
        )
        assert [r.offset for r in got[0]] == [plants["sword"]]
        assert [r.offset for r in got[1]] == [plants["shield"]]
        assert "shield" in got[1][0].preview

    def test_value_scan_spec(self, tmp_path):
        data = np.zeros(500, dtype=np.uint8)
        data[100:105] = [10, 20, 21, 22, 30]
        p = tmp_path / "v.bin"
        p.write_bytes(data.tobytes())
        ms = MultiSearcher(p)
        got = ms.search([{"reference_values": [10, 20, 21, 22, 30]}])
        assert [r.offset for r in got[0]] == [100]
        assert got[0][0].values_map == {}

    def test_different_lengths_one_dispatch(self, rom8):
        path, plants = rom8
        ms = MultiSearcher(path)
        got = ms.search(["sword", "potion", "swordfish"])
        assert [r.offset for r in got[0]] == [plants["sword"]]
        assert [r.offset for r in got[1]] == [plants["potion"]]
        assert got[2] == []

    def test_16bit_big_endian(self, tmp_path, rng):
        data = rng.integers(0, 65536, 30_000).astype(np.uint16)
        enc = np.array([ord(c) + 200 for c in "zelda"], dtype=np.uint16)
        data[12_345 : 12_350] = enc
        p = tmp_path / "rom16.bin"
        p.write_bytes(data.astype(">u2").tobytes())
        ms = MultiSearcher(p, element_width=2, endianness=Endianness.BIG)
        got = ms.search(["zelda", "ganon"])
        assert [r.offset for r in got[0]] == [12_345 * 2]
        assert got[1] == []

    def test_reference_semantics_fallback(self, rom8):
        path, plants = rom8
        ms = MultiSearcher(path, semantics=MatchSemantics.REFERENCE)
        got = ms.search(["sword"])
        assert [r.offset for r in got[0]] == [plants["sword"]]

    def test_leading_wildcard_at_last_window(self, tmp_path, rng):
        """Regression: a leading-wildcard keyword compiles to adjacent
        checks starting at (2, 1) — remapping it onto the canonical
        dense-from-zero table tested windows shifted by the leading
        wildcard count, dropping matches at the last valid window."""
        data = rng.integers(0, 256, 40_000).astype(np.uint8)
        enc = np.array([ord(c) + 3 for c in "?bcde"], dtype=np.uint8)
        data[-5:] = enc  # match at the very last valid window
        mid = 17_000
        data[mid : mid + 5] = enc
        p = tmp_path / "lead.bin"
        p.write_bytes(data.tobytes())
        spec = {"keyword": "?bcde", "wildcard": "?"}
        ms = MultiSearcher(p)
        got = ms.search([spec])
        cfg = SearchConfig(file_path=p, keyword="?bcde", wildcard="?")
        single = SearchEngine(cfg).run()
        assert [r.offset for r in got[0]] == [r.offset for r in single]
        assert len(data) - 5 in [r.offset for r in got[0]]


class TestMeshMultiSearcher:
    """MultiSearcher(devices=...): the keyword batch scans a sharded
    resident corpus across the mesh — results identical at every mesh
    size."""

    @pytest.mark.parametrize("n_dev", [1, 2, 8])
    def test_results_invariant_in_mesh_size(self, rom8, n_dev):
        import jax

        from monkey_moore_tpu.parallel import resident

        path, plants = rom8
        specs = ["sword", "shield", {"keyword": "pot*on", "wildcard": "*"}]
        want = [
            [r.offset for r in g] for g in MultiSearcher(path).search(specs)
        ]
        assert want == [[plants["sword"]], [plants["shield"]],
                        [plants["potion"]]]
        resident.clear_sharded_corpus_cache()
        ms = MultiSearcher(path, devices=jax.devices()[:n_dev])
        got = [[r.offset for r in g] for g in ms.search(specs)]
        assert got == want

    def test_16bit_be_mesh(self, tmp_path, rng):
        import jax

        from monkey_moore_tpu.parallel import resident

        data = rng.integers(0, 65536, 60_000).astype(np.uint16)
        enc = np.array([ord(c) + 0x2000 for c in "zelda"], dtype=np.uint16)
        data[12_345 : 12_350] = enc
        p = tmp_path / "rom16.bin"
        p.write_bytes(data.astype(">u2").tobytes())
        specs = ["zelda", "ganon"]
        want = [
            [r.offset for r in g]
            for g in MultiSearcher(
                p, element_width=2, endianness=Endianness.BIG
            ).search(specs)
        ]
        resident.clear_sharded_corpus_cache()
        ms = MultiSearcher(
            p, element_width=2, endianness=Endianness.BIG,
            devices=jax.devices()[:4],
        )
        got = [[r.offset for r in g] for g in ms.search(specs)]
        assert got == want == [[12_345 * 2], []]
