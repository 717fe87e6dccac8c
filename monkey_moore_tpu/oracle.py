"""Sequential reference oracle (layer L1).

A faithful scalar replica of the reference's two hot scan loops, used as (a)
the conformance source of truth for the dense device scan, and (b) the
engine's ``MatchSemantics.REFERENCE`` execution path (optionally accelerated
by the C++ walker in ``native/``).

Replicates, step for step:

- the simple/value-scan loop ``monkey_moore`` (``src/core/monkey_moore.cpp:316-410``):
  right-to-left signed adjacent-diff comparison, wrap-around pair check,
  post-match advance of ``L-1``, bad-character jump ``max(skip[v+tmax], 1)``;
- the wildcard loop ``monkey_moore_wc`` (``src/core/monkey_moore.cpp:425-546``):
  branchless masked unsigned bridged-diff comparison, post-match advance of
  ``L-1-leading_wildcards``, jump ``min(wildcard_skip, max(skip, 1))``.

Note this includes the reference's *unsafe* skip behavior: a mismatch jump can
overshoot a true match (see :class:`monkey_moore_tpu.config.MatchSemantics`).
The oracle intentionally reproduces it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .ops.recover import recover_from_values, recovery_shifts
from .pattern import CompiledPattern, SearchMode, compile_pattern

__all__ = ["oracle_search", "reference_walk", "OracleSearcher"]

Result = Tuple[int, Dict[int, int]]


def _as_elements(data, dtype) -> np.ndarray:
    arr = np.asarray(data)
    if arr.dtype != dtype:
        arr = arr.astype(dtype)
    return arr


def oracle_search(pat: CompiledPattern, data) -> List[Result]:
    """Run the exact sequential walk over *data* (1-D array of elements).

    Returns [(element_offset, equivalency_map), ...] exactly as the
    reference's ``MonkeyMoore<Ty>::search`` (``monkey_moore.cpp:41-49``).
    """
    if pat.length < 2:
        # The reference's post-match advance is L-1(=0) for L=1, which loops
        # forever; there is no finite reference behavior to conform to.
        raise ValueError("pattern length must be >= 2")
    if pat.advance <= 0:
        # Wildcard keywords whose literals all sit in the leading-wildcard
        # prefix complement (e.g. "**x") give advance = L-1-leading = 0: the
        # reference infinite-loops on the first match
        # (``monkey_moore.cpp:526-527``).  No finite behavior to conform to;
        # the GUI validation layer rejects such keywords
        # (``src/gui/monkey_frame.cpp:1100-1104`` needs >=3 non-wildcards).
        raise ValueError(
            "pattern advance is 0 (all literals inside the leading-wildcard "
            "span); the reference implementation does not terminate on these"
        )
    data = _as_elements(data, pat.dtype)
    if pat.mode in (SearchMode.SIMPLE, SearchMode.VALUE_SCAN):
        return _walk_simple(pat, data)
    return _walk_wildcard(pat, data)


def _emit(pat: CompiledPattern, data: np.ndarray, p: int) -> Result:
    shifts = recovery_shifts(pat)
    values = [int(data[p + s]) for s in shifts]
    return (p, recover_from_values(pat, values))


def _walk_simple(pat: CompiledPattern, data: np.ndarray) -> List[Result]:
    """Parity: ``monkey_moore`` (``monkey_moore.cpp:316-410``)."""
    L = pat.length
    N = len(data)
    expected = pat.expected_diff
    skip = pat.skip_table
    tmax = pat.tmax
    d = data.astype(np.int64)  # widened once; all compares are signed ints

    results: List[Result] = []
    p = 0
    while p + L <= N:
        mismatch_v = None
        # Part 1: contiguous backwards comparison (``:354-362``).
        for k in range(L - 1, 0, -1):
            diff = int(d[p + k] - d[p + k - 1])
            if diff != expected[k]:
                mismatch_v = diff
                break
        else:
            # Part 2: wrap-around pair (``:367-371``) — telescopes to truth
            # when part 1 passed, but kept for bit-exact structure.
            diff = int(d[p] - d[p + L - 1])
            if diff != expected[0]:
                mismatch_v = diff

        if mismatch_v is None:
            results.append(_emit(pat, data, p))
            p += L - 1  # ``:398``
        else:
            p += max(int(skip[mismatch_v + tmax]), 1)  # ``:402-405``
    return results


def _walk_wildcard(pat: CompiledPattern, data: np.ndarray) -> List[Result]:
    """Parity: ``monkey_moore_wc`` (``monkey_moore.cpp:425-546``)."""
    L = pat.length
    N = len(data)
    bridge = pat.bridge_offset
    wc_expected = pat.wc_expected
    wc_mask = pat.wc_mask
    skip = pat.skip_table
    wskip = pat.wildcard_skip_table
    tmax = pat.tmax
    advance = pat.advance

    results: List[Result] = []
    p = 0
    while p + L <= N:
        matches = 0
        mismatch_v = 0
        while matches < L:
            i = L - matches - 1
            cur = data[p + i]
            prev = data[p + i + bridge[i]]
            # unsigned Ty wraparound diff (``:461``); & tmax == mod 2^width
            cur_diff = (int(cur) - int(prev)) & tmax
            if (cur_diff & wc_mask[i]) != wc_expected[i]:
                mismatch_v = int(cur) - int(prev)  # signed (``:467``)
                break
            matches += 1

        if matches == L:
            results.append(_emit(pat, data, p))
            p += advance  # ``:526-527``
        else:
            i = L - matches - 1
            jump = min(
                int(wskip[i]), max(int(skip[mismatch_v + tmax]), 1)
            )  # ``:531-538``
            p += jump
    return results


def reference_walk(pat: CompiledPattern, data) -> List[Result]:
    """Exact reference-semantics walk, preferring the native C++ walker
    (``native/mm_walker.cpp``) and falling back to the Python oracle.

    Both replay identical dynamics; the native path exists because the
    sequential walk is inherently scalar work where C is ~100x Python."""
    data = _as_elements(data, pat.dtype)
    if pat.length < 2 or pat.advance <= 0:
        # Degenerate patterns (L=1, or all literals inside the leading-
        # wildcard span) make the reference walk non-terminating; route them
        # to the oracle's guards BEFORE touching the native walker, which
        # would otherwise spin forever in C (its `p += advance` never
        # progresses past a match).
        return oracle_search(pat, data)
    try:
        from .native import native_walk

        offsets = native_walk(pat, data)
    except Exception:
        offsets = None
    if offsets is None:
        return oracle_search(pat, data)
    return [_emit(pat, data, int(p)) for p in offsets]


class OracleSearcher:
    """Convenience wrapper mirroring the ``MonkeyMoore<Ty>`` class surface
    (``include/mmoore/monkey_moore.hpp:18-51``)."""

    def __init__(
        self,
        keyword=None,
        wildcard=0,
        char_seq=(),
        reference_values=None,
        dtype=np.uint8,
    ):
        self.pattern = compile_pattern(
            keyword=keyword,
            wildcard=wildcard,
            char_seq=char_seq,
            reference_values=reference_values,
            dtype=dtype,
        )

    def search(self, data) -> List[Result]:
        return oracle_search(self.pattern, data)
