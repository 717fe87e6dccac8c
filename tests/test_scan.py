"""Dense scan kernel conformance tests (layer L2).

Strategy: the dense kernels must (a) reproduce every reference-corpus result
under GREEDY semantics, (b) agree with an independently-written brute-force
window matcher under ALL semantics, and (c) always emit a superset of the
sequential oracle's offsets.
"""

import numpy as np
import pytest

from monkey_moore_tpu.config import MatchSemantics
from monkey_moore_tpu.dense import TILE_ELEMS, dense_candidates, dense_search
from monkey_moore_tpu.oracle import oracle_search
from monkey_moore_tpu.pattern import SearchMode, compile_pattern
from common import HIRAGANA_SEQ, shift_alpha


def brute_force_all(pat, data):
    """Independent window matcher built from the *walker* tables (bridge /
    mask / expected_diff), not the kernel's check tables."""
    data = np.asarray(data, dtype=pat.dtype)
    N, L = len(data), pat.length
    out = []
    for p in range(N - L + 1):
        ok = True
        if pat.mode in (SearchMode.SIMPLE, SearchMode.VALUE_SCAN):
            for i in range(1, L):
                if int(data[p + i]) - int(data[p + i - 1]) != pat.expected_diff[i]:
                    ok = False
                    break
        else:
            for i in range(L):
                d = (int(data[p + i]) - int(data[p + i + pat.bridge_offset[i]])) & pat.tmax
                if (d & int(pat.wc_mask[i])) != int(pat.wc_expected[i]):
                    ok = False
                    break
        if ok:
            out.append(p)
    return out


CORPORA = []


def corpus(name):
    def deco(fn):
        CORPORA.append((name, fn))
        return fn
    return deco


@corpus("ascii-8")
def _c1():
    data = shift_alpha([ord(c) for c in "dddccacatchaat"], 3, 3)
    return compile_pattern("catch"), data


@corpus("custom-seq-8")
def _c2():
    seq = "aiueobcdfghjklmnpqrstvwxyz"
    data = np.array([ord(c) for c in "auqqtkcaoaugka"], dtype=np.uint8)
    return compile_pattern("match", 0, seq), data


@corpus("ascii-16")
def _c3():
    text = "question of price\0the last wish\0"
    data = shift_alpha([ord(c) for c in text], -16, -16, dtype=np.uint16)
    return compile_pattern("price", dtype=np.uint16), data


@corpus("hiragana-16")
def _c4():
    data = np.array(
        [1, 12, 16, 110, 44, 16, 12, 16, 17, 26, 110, 22, 44, 22, 110, 26,
         21, 45, 110, 31, 7, 31, 13],
        dtype=np.uint16,
    )
    return (
        compile_pattern("わたしたちは", 0, HIRAGANA_SEQ, dtype=np.uint16),
        data,
    )


@corpus("wildcard-8")
def _c5():
    data = shift_alpha([ord(c) for c in "thebittertasteoflemonwithbutter,"], 8, 8)
    return compile_pattern("b*tter", "*"), data


@corpus("mixed-case-8")
def _c6():
    data = shift_alpha([ord(c) for c in "TheBitterTruthAboutBetterButter."], -32, 24)
    return compile_pattern("B*tter", "*"), data


@corpus("wildcard-16")
def _c7():
    text = "They muttered: Butter, BETTER, Butcher, matter"
    data = shift_alpha([ord(c) for c in text], 15, -9, dtype=np.uint16)
    return compile_pattern("But**er", "*", dtype=np.uint16), data


@corpus("kanji-seq-16")
def _c8():
    seq = HIRAGANA_SEQ + "学校行"
    data = np.array(
        [1, 12, 16, 26, 111, 50, 51, 22, 111, 52, 7, 31, 13, 6, 112, 111,
         44, 16, 12, 35, 111, 52, 7, 16, 2, 113],
        dtype=np.uint16,
    )
    return compile_pattern("**に*行きますか", "*", seq, dtype=np.uint16), data


@corpus("value-scan-8")
def _c9():
    data = np.array(
        [0x00, 0x00, 0x25, 0x26, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x20,
         0x20, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00, 0x89, 0x00, 0x76,
         0x77, 0x78, 0x79, 0x7A, 0x81, 0x00, 0x00, 0x01, 0x00, 0x00],
        dtype=np.uint8,
    )
    return compile_pattern(reference_values=[60, 61, 62, 63, 64, 71]), data


@corpus("value-scan-16")
def _c10():
    data = np.array(
        [0x0000, 0x0100, 0x0135, 0x0136, 0x0135, 0x0136, 0x0137, 0x0138,
         0x0139, 0x0140, 0x0120, 0x0120, 0x0000, 0x0100, 0x0101, 0x0000,
         0x0101, 0x0089, 0x0000, 0x0045, 0x0046, 0x0047, 0x0048, 0x0049,
         0x0050, 0x0000, 0x0100, 0x0000, 0x0100, 0x0001, 0x0100, 0x0000],
        dtype=np.uint16,
    )
    return (
        compile_pattern(
            reference_values=[105, 106, 107, 108, 109, 116], dtype=np.uint16
        ),
        data,
    )


@corpus("skip-regression-8")
def _c11():
    data = np.array(
        [0x98, 0x94, 0x00, 0xFF, 0xFF, 0x00, 0x01, 0xA5, 0xA1, 0x94, 0x85,
         0x98, 0x94],
        dtype=np.uint8,
    )
    return compile_pattern("text"), data


#: count-tile sizes the XLA sweep is checked at: the production tile, a
#: mid-size tile, and one small enough that every corpus spans many tiles
TILE_GEOMETRIES = [TILE_ELEMS, 1024, 16]


@pytest.mark.parametrize("name,make", CORPORA, ids=[n for n, _ in CORPORA])
class TestKernelVsOracle:
    def test_greedy_equals_oracle(self, name, make):
        pat, data = make()
        dense = dense_search(pat, data, MatchSemantics.GREEDY)
        expect = oracle_search(pat, data)
        assert dense == expect

    def test_all_equals_brute_force(self, name, make):
        pat, data = make()
        offsets, _ = dense_candidates(pat, data)
        assert offsets.tolist() == brute_force_all(pat, data)

    def test_all_superset_of_oracle(self, name, make):
        pat, data = make()
        offsets, _ = dense_candidates(pat, data)
        oracle_offs = {o for o, _ in oracle_search(pat, data)}
        assert oracle_offs <= set(offsets.tolist())


class TestFuzzKernelVsBruteForce:
    @pytest.mark.parametrize("width", [1, 2])
    def test_random_planted(self, rng, width):
        dtype = np.uint8 if width == 1 else np.uint16
        mod = 256 if width == 1 else 65536
        letters = np.arange(97, 123)
        for _ in range(25):
            n = int(rng.integers(20, 3000))
            data = rng.integers(0, mod, n)
            kw_len = int(rng.integers(2, 8))
            kw = rng.choice(letters, kw_len).tolist()
            use_wc = rng.random() < 0.5
            if use_wc:
                for i in range(1, kw_len):  # keep position 0 literal
                    if rng.random() < 0.25:
                        kw[i] = ord("*")
            for _ in range(int(rng.integers(0, 5))):
                pos = int(rng.integers(0, max(1, n - kw_len)))
                shift = int(rng.integers(-40, 40))
                data[pos : pos + kw_len] = (np.array(kw) + shift) % mod
            pat = compile_pattern(kw, ord("*") if use_wc else 0, dtype=dtype)
            arr = data.astype(dtype)
            offsets, _ = dense_candidates(pat, arr)
            assert offsets.tolist() == brute_force_all(pat, arr), (
                f"kw={kw} n={n}"
            )
            # oracle offsets are always a subset of dense candidates
            oracle_offs = [o for o, _ in oracle_search(pat, arr)]
            assert set(oracle_offs) <= set(offsets.tolist())


class TestEdges:
    def test_many_matches(self):
        # dense matches at every even position — hot-tile extraction must
        # return them all.
        data = shift_alpha([ord("a"), ord("b")] * 301, 5, 5)
        pat = compile_pattern("abab")
        res = dense_search(pat, data, MatchSemantics.ALL)
        assert len(res) == len(brute_force_all(pat, data))

    def test_data_shorter_than_pattern(self):
        pat = compile_pattern("catch")
        assert dense_search(pat, np.zeros(3, dtype=np.uint8)) == []

    def test_greedy_suppression_periodic(self):
        data = shift_alpha([ord("a")] * 9, 5, 5)
        pat = compile_pattern("aaaa")
        res = dense_search(pat, data, MatchSemantics.GREEDY)
        assert [r[0] for r in res] == [0, 3]
        res_all = dense_search(pat, data, MatchSemantics.ALL)
        assert [r[0] for r in res_all] == [0, 1, 2, 3, 4, 5]

    def test_reference_semantics_delegates_to_oracle(self):
        data = np.array([10, 6, 7, 8, 9, 10, 0, 0, 0, 0], dtype=np.uint8)
        pat = compile_pattern("abcde")
        # dense finds the match the reference misses; REFERENCE mode hides it
        assert dense_search(pat, data, MatchSemantics.ALL)[0][0] == 1
        assert dense_search(pat, data, MatchSemantics.REFERENCE) == []


class TestDeviceResidentExtraction:
    @pytest.mark.parametrize("width", [1, 2])
    def test_matches_host_extraction(self, width):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import (
            TILE_ELEMS,
            extract_hot_tiles,
            extract_hot_tiles_device,
            tile_counts,
        )

        dtype = np.uint8 if width == 1 else np.uint16
        pat = compile_pattern("abcde", dtype=dtype)
        n = 2 * TILE_ELEMS + 77
        arr = np.zeros(4 * TILE_ELEMS, dtype=dtype)
        kw = (np.array(pat.keyword) + 3).astype(dtype)
        arr[10 : 15] = kw
        arr[TILE_ELEMS - 2 : TILE_ELEMS + 3] = kw  # straddles tiles 0/1
        arr[n - 5 : n] = kw  # last valid window
        arr[n + 8 : n + 13] = kw  # past valid: must be dropped
        dev = jnp.asarray(arr)
        counts = tile_counts(pat, dev, n)
        off_host, val_host = extract_hot_tiles(pat, arr[:n], counts)
        off_dev, val_dev = extract_hot_tiles_device(pat, dev, counts, n)
        assert off_dev.tolist() == off_host.tolist() == [
            10,
            TILE_ELEMS - 2,
            n - 5,
        ]
        assert val_dev.tolist() == val_host.tolist()


class TestFusedCountExtract:
    """dense.fused_count_extract: ONE dispatch computes tile counts AND
    gathers hot tiles; must be offset/value-identical to the two-dispatch
    composition (tile_counts + extract_hot_tiles_device)."""

    def _planted(self, pat, n_tiles, plants, dtype=np.uint8):
        from monkey_moore_tpu.dense import TILE_ELEMS

        n = n_tiles * TILE_ELEMS + 77
        arr = np.zeros((n_tiles + 2) * TILE_ELEMS, dtype=dtype)
        kw = (np.array(pat.keyword) + 3).astype(dtype)
        for pos in plants:
            arr[pos : pos + len(kw)] = kw
        return arr, n

    @pytest.mark.parametrize("width", [1, 2])
    def test_matches_two_dispatch_path(self, width):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import (
            TILE_ELEMS,
            extract_hot_tiles_device,
            fused_count_extract,
            tile_counts,
        )

        dtype = np.uint8 if width == 1 else np.uint16
        pat = compile_pattern("abcde", dtype=dtype)
        arr, n = self._planted(
            pat,
            2,
            [10, TILE_ELEMS - 2, 2 * TILE_ELEMS + 50, n_plus(2) - 5],
            dtype=dtype,
        )
        arr[n + 8 : n + 13] = (np.array(pat.keyword) + 3).astype(dtype)
        dev = jnp.asarray(arr)
        offs, vals, info = fused_count_extract(pat, dev, n)
        ref_counts = tile_counts(pat, dev, n)
        ref_offs, ref_vals = extract_hot_tiles_device(
            pat, dev, ref_counts, n
        )
        assert info.hot_tiles == int((ref_counts > 0).sum())
        assert info.prefilter_total == int(ref_counts.sum())
        assert offs.tolist() == ref_offs.tolist() == [
            10, TILE_ELEMS - 2, 2 * TILE_ELEMS + 50, n - 5
        ]
        assert vals.tolist() == ref_vals.tolist()

    def test_no_hot_tiles(self):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import fused_count_extract

        pat = compile_pattern("abcde")
        arr, n = self._planted(pat, 2, [])
        offs, vals, info = fused_count_extract(pat, jnp.asarray(arr), n)
        assert info.hot_tiles == 0 and len(offs) == 0 and len(vals) == 0

    def test_overflow_falls_back_to_batched_gather(self):
        # more hot tiles than k_cap → the batched-gather fallback must
        # still return every match
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import TILE_ELEMS, fused_count_extract

        pat = compile_pattern("abcde")
        plants = [t * TILE_ELEMS + 13 for t in range(6)]
        arr, n = self._planted(pat, 6, plants)
        offs, vals, info = fused_count_extract(
            pat, jnp.asarray(arr), n, k_cap=2
        )
        assert offs.tolist() == plants
        assert info.hot_tiles == 6

    @pytest.mark.parametrize("tile_elems", [TILE_GEOMETRIES[0], 1024])
    def test_device_exact_filters_prefilter_false_positives(
        self, tile_elems
    ):
        # windows that pass the capped mod-2^width prefilter but fail the
        # full exact checks must die ON DEVICE (n_cand excludes them), not
        # just in a host pass
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import fused_count_extract

        pat = compile_pattern("abcdefgh")  # 7 checks, 4 on the prefilter
        arr = np.zeros(3 * tile_elems, dtype=np.uint8)
        # ramp of 5: passes the first-4-diffs prefilter, breaks at check 5
        arr[100:106] = [10, 11, 12, 13, 14, 99]
        # a real match
        kw = (np.array(pat.keyword) + 3).astype(np.uint8)
        arr[500:508] = kw
        n = 2 * tile_elems
        offs, vals, info = fused_count_extract(
            pat, jnp.asarray(arr), n, tile_elems=tile_elems
        )
        assert info.hot_tiles == 1  # both plants share tile 0
        # phase 1 counts the ramp FP, the match, and the match's interior
        # windows (first-4-diffs all pass)...
        assert info.prefilter_total == 5
        assert offs.tolist() == [500]  # ...exact phase 2 keeps only the match

    def test_many_false_positive_tiles_few_exact_matches(self):
        # the wildcard-suite regime: prefilter false positives scattered
        # over many tiles, almost no exact matches — k_cap auto-sizing must
        # keep the fused path (no fallback) and return exactly the true set
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import TILE_ELEMS, fused_count_extract

        pat = compile_pattern("abcdefgh")
        n_tiles = 12
        arr = np.zeros((n_tiles + 2) * TILE_ELEMS, dtype=np.uint8)
        for t in range(n_tiles):  # a broken ramp in every tile
            p = t * TILE_ELEMS + 37
            arr[p : p + 6] = [10, 11, 12, 13, 14, 99]
        kw = (np.array(pat.keyword) + 3).astype(np.uint8)
        real = [3 * TILE_ELEMS + 11, 9 * TILE_ELEMS + 200]
        for p in real:
            arr[p : p + 8] = kw
        n = n_tiles * TILE_ELEMS
        offs, vals, info = fused_count_extract(pat, jnp.asarray(arr), n)
        assert info.hot_tiles == n_tiles
        assert offs.tolist() == real

    def test_16bit_and_grid_offset(self):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import TILE_ELEMS, fused_count_extract

        pat = compile_pattern("abcde", dtype=np.uint16)
        arr, n = self._planted(pat, 2, [TILE_ELEMS + 9], dtype=np.uint16)
        offs, vals, info = fused_count_extract(
            pat, jnp.asarray(arr), n, grid_offset=1000
        )
        assert offs.tolist() == [TILE_ELEMS + 9 + 1000]


def n_plus(n_tiles):
    from monkey_moore_tpu.dense import TILE_ELEMS

    return n_tiles * TILE_ELEMS + 77


def brute_force_prefilter(pat, data):
    """The device phase's mod-2^width prefilter semantics over the SELECTED
    check subset (prefilter_checks): a superset of brute_force_all (host
    extraction applies exact semantics over every check afterwards)."""
    from monkey_moore_tpu.ops.scan_jnp import prefilter_checks

    data = np.asarray(data, dtype=pat.dtype)
    N, L = len(data), pat.length
    pairs, exp_ty = prefilter_checks(pat)
    out = []
    for p in range(N - L + 1):
        ok = True
        for (cur, prev), e in zip(pairs, exp_ty):
            if (int(data[p + cur]) - int(data[p + prev])) & pat.tmax != e:
                ok = False
                break
        if ok:
            out.append(p)
    return out


class TestPrefilterCapping:
    """The device prefilter evaluates at most prefilter_cap(dtype) checks
    (4 for u8, 2 for u16) — any subset is a valid prefilter since host
    extraction re-applies every check exactly."""

    def test_selection_caps_and_prefers_nonzero_diffs(self):
        from monkey_moore_tpu.ops.scan_jnp import (
            prefilter_check_indices,
            prefilter_checks,
        )

        pat = compile_pattern("aabcdefgh")  # check 0 expects diff 0
        pairs, exp = prefilter_checks(pat)
        assert len(pairs) == 4
        assert all(int(e) != 0 for e in exp)
        assert 0 not in prefilter_check_indices(pat).tolist()
        # short keywords keep every check
        assert len(prefilter_checks(compile_pattern("abcde"))[0]) == 4
        # 16-bit cap is 2
        assert (
            len(prefilter_checks(compile_pattern("abcde", dtype=np.uint16))[0])
            == 2
        )

    def test_long_keyword_exact_through_capped_prefilter(self):
        text = "zzzz...abcdefghijkl...zzzz"
        data = shift_alpha([ord(c) for c in text], 5, 5)
        pat = compile_pattern("abcdefghijkl")
        res = dense_search(pat, data, MatchSemantics.ALL)
        assert [r[0] for r in res] == brute_force_all(pat, data) == [7]

    def test_prefilter_false_positives_filtered_exactly(self):
        # ramp passes the 4 selected checks (diffs 1,1,1,1) but breaks at
        # check 5 — the prefilter overcounts, exact extraction filters it
        data = np.array(
            [10, 11, 12, 13, 14, 99, 0, 0, 0, 0], dtype=np.uint8
        )
        pat = compile_pattern("abcdefgh")
        assert 0 in brute_force_prefilter(pat, data)
        offsets, _ = dense_candidates(pat, data)
        assert offsets.tolist() == brute_force_all(pat, data) == []

    def test_capped_counts_interpret_match_brute_force(self):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import TILE_ELEMS, tile_counts

        text = "..abcdefghij..xxabcdefghij.."
        data = shift_alpha([ord(c) for c in text], 9, 9)
        pat = compile_pattern("abcdefghij")
        arr = np.zeros(2 * TILE_ELEMS, dtype=np.uint8)
        arr[: len(data)] = data
        counts = tile_counts(
            pat, jnp.asarray(arr), len(data), tile_elems=TILE_ELEMS
        )
        # interior windows of each planted ramp also pass the capped
        # (first-4-diffs) prefilter — compare against the brute-force
        # prefilter, and sanity-check it strictly overcounts the exact set
        want = brute_force_prefilter(pat, data)
        assert int(counts[0]) == len(want)
        assert len(want) > len(brute_force_all(pat, data)) == 2


def _padded(pat, data, tile_elems):
    """``data`` in the device contract: whole tiles + one halo tile."""
    n = len(data)
    arr = np.zeros((-(-n // tile_elems) + 1) * tile_elems, dtype=pat.dtype)
    arr[:n] = data
    return arr


class TestTileCountsXla:
    """The XLA count sweep (``dense.tile_counts``) per tile against the
    brute-force prefilter, at every tile geometry."""

    @pytest.mark.parametrize("tile_elems", TILE_GEOMETRIES)
    @pytest.mark.parametrize("name,make", CORPORA, ids=[n for n, _ in CORPORA])
    def test_counts_match_brute_force(self, name, make, tile_elems):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import tile_counts

        pat, data = make()
        n = len(data)
        counts = tile_counts(
            pat, jnp.asarray(_padded(pat, data, tile_elems)), n,
            tile_elems=tile_elems,
        )
        want = np.zeros(-(-n // tile_elems), dtype=np.int64)
        for p in brute_force_prefilter(pat, data):
            want[p // tile_elems] += 1
        assert counts.tolist() == want.tolist()
        # and the prefilter never undercounts the exact match set
        assert int(counts.sum()) >= len(brute_force_all(pat, data))

    def test_prefilter_false_positive_filtered_by_extraction(self):
        # 0-255 = -255 ≡ +1 mod 256 passes the device prefilter but host
        # extraction applies exact signed semantics and drops it.
        data = np.array([10, 255, 0, 1, 2, 3, 0, 0], dtype=np.uint8)
        pat = compile_pattern("abcd")
        assert 1 in brute_force_prefilter(pat, data)
        offsets, _ = dense_candidates(pat, data)
        assert offsets.tolist() == brute_force_all(pat, data)
        assert 1 not in offsets.tolist()

    @pytest.mark.parametrize("tile_elems", TILE_GEOMETRIES[:2] + [64])
    def test_cross_tile_window_counted(self, tile_elems):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import tile_counts

        pat = compile_pattern("abcde")
        n = 2 * tile_elems + 20  # 2 counted tiles + partial
        arr = np.zeros(4 * tile_elems, dtype=np.uint8)
        kw = (np.array(pat.keyword) + 3).astype(np.uint8)
        # straddles the tile-0/tile-1 boundary
        arr[tile_elems - 2 : tile_elems + 3] = kw
        # inside tile 1
        arr[tile_elems + 10 : tile_elems + 15] = kw
        # beyond valid → must not count
        arr[n - 2 : n + 3] = kw
        counts = tile_counts(pat, jnp.asarray(arr), n, tile_elems=tile_elems)
        assert counts.tolist() == [1, 1, 0]

    @pytest.mark.parametrize("entry", ["tile_counts", "fused_start"])
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    def test_refuses_2_pow_31_elements(self, entry, dtype):
        """Arrays of 2**31 elements would wrap the body's int32 indices
        (silent false negatives); both device entry points refuse them.
        Shapes only — nothing of that size is allocated."""
        import jax
        from monkey_moore_tpu.dense import (
            fused_count_extract_start,
            tile_counts,
        )

        pat = compile_pattern("abcde", dtype=dtype)
        big = jax.ShapeDtypeStruct((2**31 + TILE_ELEMS,), dtype)
        fn = tile_counts if entry == "tile_counts" else (
            fused_count_extract_start
        )
        with pytest.raises(ValueError, match="2\\*\\*31"):
            fn(pat, big, 2**31)
        # one element under the bound with a small valid count is also an
        # oversize ARRAY, refused before anything is traced
        with pytest.raises(ValueError):
            fn(pat, jax.ShapeDtypeStruct((2**31,), dtype), 1000)


@pytest.mark.parametrize("name,make", CORPORA, ids=[n for n, _ in CORPORA])
class TestFusedVsOracle:
    """The production fused step (``dense.fused_count_extract``) on every
    reference corpus: exact offsets equal the brute-force matcher, values
    equal the two-dispatch path, and the sequential oracle is a subset."""

    @pytest.mark.parametrize("tile_elems", [TILE_ELEMS, 16])
    def test_fused_matches_oracle(self, name, make, tile_elems):
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import fused_count_extract

        pat, data = make()
        offs, vals, info = fused_count_extract(
            pat, jnp.asarray(_padded(pat, data, tile_elems)), len(data),
            tile_elems=tile_elems,
        )
        ref_offs, ref_vals = dense_candidates(pat, data)
        assert offs.tolist() == brute_force_all(pat, data)
        assert vals.tolist() == ref_vals.tolist()
        oracle_offs = {o for o, _ in oracle_search(pat, data)}
        assert oracle_offs <= set(offs.tolist())

    @pytest.mark.parametrize("cap", ["k_cap", "p_cap"])
    def test_overflow_fallback_exact(self, name, make, cap):
        """A one-slot hot-tile (``k_cap``) or candidate (``p_cap``) buffer
        overflows on any corpus with two hot tiles or two candidates; the
        counts-fetch fallback must still return the exact set."""
        import jax.numpy as jnp
        from monkey_moore_tpu.dense import fused_count_extract

        pat, data = make()
        tile_elems = 16
        offs, vals, info = fused_count_extract(
            pat, jnp.asarray(_padded(pat, data, tile_elems)), len(data),
            tile_elems=tile_elems, **{cap: 1},
        )
        want = brute_force_all(pat, data)
        assert offs.tolist() == want
        if cap == "p_cap" and len(want) > 1:
            assert info.fallback
        _, ref_vals = dense_candidates(pat, data)
        assert vals.tolist() == ref_vals.tolist()


class TestNonzeroCapped:
    """Two-level capped compaction must reproduce jnp.nonzero's first
    count_nonzero entries exactly (ascending) whenever that count fits the
    cap — including hot block 0 (whose duplicated fill rows must not
    corrupt the leading entries)."""

    @pytest.mark.parametrize(
        "positions",
        [
            [],
            [0],  # block 0 hot + sparse
            [0, 1, 2, 127, 128, 129],  # block boundary straddle
            [5000],
            [0, 5000, 19999],
            list(range(0, 2000, 7)),  # many blocks
            list(range(300, 428)),  # one dense block run
        ],
    )
    @pytest.mark.parametrize("cap", [4, 64, 512])
    def test_matches_nonzero(self, positions, cap):
        import jax.numpy as jnp
        from monkey_moore_tpu.ops.scan_jnp import nonzero_capped

        n = 20000  # > cap * blk for cap=4 and 64 (two-level); 512 = plain
        flat = np.zeros(n, dtype=bool)
        flat[positions] = True
        got = np.asarray(nonzero_capped(jnp.asarray(flat), cap))
        k = min(len(positions), cap)
        assert got[:k].tolist() == positions[:k]

    def test_int_input(self, rng):
        import jax.numpy as jnp
        from monkey_moore_tpu.ops.scan_jnp import nonzero_capped

        counts = np.zeros(3000, dtype=np.int32)
        hot = np.sort(rng.choice(3000, size=37, replace=False))
        counts[hot] = rng.integers(1, 100, size=37)
        got = np.asarray(nonzero_capped(jnp.asarray(counts), 64, blk=16))
        assert got[:37].tolist() == hot.tolist()

    def test_ragged_length_padding(self):
        import jax.numpy as jnp
        from monkey_moore_tpu.ops.scan_jnp import nonzero_capped

        flat = np.zeros(1000, dtype=bool)  # not a multiple of blk
        flat[[3, 998, 999]] = True
        got = np.asarray(nonzero_capped(jnp.asarray(flat), 8, blk=16))
        assert got[:3].tolist() == [3, 998, 999]
