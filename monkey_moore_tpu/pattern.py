"""Pattern compiler (layer L0).

Compiles a search keyword into the numeric tables that drive both the dense
device scan and the exact sequential walker.  This is the counterpart of
the reference's preprocessing stage:

- mode selection / state init   — ``src/core/monkey_moore.cpp:54-78``
- no-wildcard tables            — ``src/core/monkey_moore.cpp:106-142``
- wildcard tables               — ``src/core/monkey_moore.cpp:144-304``
- circular diff computation     — ``src/core/monkey_moore.cpp:551-585``

The compiled artifact additionally carries *dense check tables*
(``chk_shift_cur`` / ``chk_shift_prev`` / ``chk_expected``): the list of
(window-relative) element pairs whose difference must equal an expected value
for a window to match.  A dense kernel evaluates every window position
branchlessly against these tables; the Boyer-Moore skip tables are only needed
by the sequential walker (``MatchSemantics.REFERENCE``) and are therefore also
kept here.

Semantics notes (each verified against the reference sources):

- In SIMPLE/VALUE_SCAN mode the scan compares **signed integer** differences
  (``monkey_moore.cpp:337-339`` uses int arithmetic), while WILDCARD mode
  compares **unsigned element-width wraparound** differences under a bitmask
  (``monkey_moore.cpp:461-464``).  The two are *not* equivalent (e.g. a data
  diff of -200 equals an expected diff of +56 mod 256), so the compiled
  pattern records ``signed_compare`` and kernels honor it.
- The wrap-around check (window position 0 in SIMPLE mode; the first literal
  in WILDCARD mode) is mathematically implied by the other checks (the
  differences telescope), so dense check tables omit it; the walker performs
  it anyway for bit-exact parity of its mismatch bookkeeping.
- Custom-sequence lookups use C++ ``std::map::operator[]`` semantics: a
  keyword character missing from the sequence maps to index 0
  (``monkey_moore.cpp:239-240`` default-inserts).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .utils.text import (
    count_prefix_length,
    find_last_index,
    is_ascii_lower,
    is_ascii_upper,
    to_codepoints,
)

__all__ = ["SearchMode", "CompiledPattern", "PatternError", "compile_pattern"]


class PatternError(ValueError):
    """Raised for invalid pattern inputs (mirrors the reference's
    ``std::runtime_error`` throws, e.g. ``monkey_moore.cpp:139``)."""


class SearchMode(enum.Enum):
    """Mirror of the reference's ``search_mode`` enum
    (``include/mmoore/monkey_moore.hpp:54``; ``none`` is unrepresentable here —
    compilation always resolves to a concrete mode)."""

    SIMPLE = "simple_relative"
    WILDCARD = "wildcard_relative"
    VALUE_SCAN = "value_scan"


def _circular_diffs(values: Sequence[int]) -> np.ndarray:
    """Circular successive differences.

    ``target[0] = v[0] - v[-1]``; ``target[i] = v[i] - v[i-1]`` for i >= 1.
    Parity: ``compute_relative_values`` (``monkey_moore.cpp:551-567``).
    """
    v = np.asarray(values, dtype=np.int64)
    out = np.empty(len(v), dtype=np.int64)
    out[0] = v[0] - v[-1]
    out[1:] = v[1:] - v[:-1]
    return out


@dataclasses.dataclass(frozen=True)
class CompiledPattern:
    """All tables derived from one keyword, ready for kernels and walkers."""

    mode: SearchMode
    dtype: np.dtype  # np.uint8 or np.uint16
    tmax: int  # numeric_limits<Ty>::max()

    keyword: Tuple[int, ...]  # original code points / value-scan values
    wildcard: int
    char_seq: Tuple[int, ...]
    char_index: Dict[int, int]  # sequence char -> 0-based index

    length: int
    #: Signed circular diff table (index 0 = wrap pair), int32.
    #: SIMPLE: raw/seq-index diffs (``monkey_moore.cpp:111-116``).
    #: WILDCARD: bridged diffs, 0 at wildcard positions (``:243``).
    expected_diff: np.ndarray
    #: Bad-character skip table, size 2*(tmax+1), indexed by diff + tmax
    #: (``monkey_moore.cpp:63-64,118-141,249-276``).
    skip_table: np.ndarray

    # ---- wildcard-mode tables (trivial/neutral in SIMPLE mode) ---------
    case_normalized: Tuple[int, ...]
    is_literal: np.ndarray  # bool[L]
    bridge_offset: np.ndarray  # int32[L]; prev_literal_index - i
    wc_expected: np.ndarray  # Ty[L] wrapped expected diffs
    wc_mask: np.ndarray  # Ty[L]; ~0 at literals, 0 at wildcards
    wildcard_skip_table: np.ndarray  # int32[L] (``monkey_moore.cpp:278-303``)
    leading_wildcards: int
    wildcards_count: int
    first_literal: int  # -1 if the keyword has no literals
    has_case_change: bool
    mostly_lowercase: bool
    first_opposing: int  # index of first opposite-case char in keyword; -1 n/a

    #: Post-match head advance: L-1 (``monkey_moore.cpp:398``) or
    #: L-1-leading_wildcards (``:526-527``).
    advance: int

    # ---- dense check tables (kernel-facing) ----------------------------
    #: Window-relative element index pairs: window matches iff for every c,
    #: diff(data[p+chk_shift_cur[c]], data[p+chk_shift_prev[c]]) equals
    #: chk_expected[c] under the mode's comparison semantics.
    chk_shift_cur: np.ndarray  # int32[C]
    chk_shift_prev: np.ndarray  # int32[C]
    chk_expected: np.ndarray  # int32[C] (signed) or Ty[C] (unsigned)
    signed_compare: bool

    def kernel_key(self) -> tuple:
        """Static signature for jit caching: everything that changes traced
        shapes/branches but not table *values*."""
        return (
            self.mode is SearchMode.WILDCARD,
            np.dtype(self.dtype).str,
            self.length,
            len(self.chk_shift_cur),
            self.signed_compare,
        )


def _seq_index_lookup(char_index: Dict[int, int], c: int) -> int:
    """C++ ``std::map::operator[]`` semantics: missing chars insert index 0."""
    if c not in char_index:
        char_index[c] = 0
    return char_index[c]


def compile_pattern(
    keyword: Union[str, Sequence[int], None] = None,
    wildcard: Union[str, int] = 0,
    char_seq: Union[str, Sequence[int], None] = (),
    reference_values: Optional[Sequence[int]] = None,
    dtype=np.uint8,
) -> CompiledPattern:
    """Memoizing front of :func:`_compile_pattern`: repeat searches of the
    same keyword (the interactive workflow) get the SAME CompiledPattern
    object back, so its per-pattern device-operand cache
    (``scan_jnp.pattern_operand_cache``) persists across engine runs and a
    repeat search re-uploads nothing.  Tables are treated as immutable by
    every consumer."""
    try:
        memo_key = (
            keyword if isinstance(keyword, (str, type(None)))
            else tuple(int(c) for c in keyword),
            wildcard,
            char_seq if isinstance(char_seq, (str, type(None)))
            else tuple(int(c) for c in char_seq),
            None if reference_values is None
            else tuple(int(v) for v in reference_values),
            np.dtype(dtype).str,
        )
    except (TypeError, ValueError):
        return _compile_pattern(
            keyword, wildcard, char_seq, reference_values, dtype
        )
    hit = _PATTERN_MEMO.get(memo_key)
    if hit is None:
        # lock the size-clear + insert: concurrent AsyncSearch /
        # MultiSearcher threads must not clear while another inserts
        # (compile is re-entrant, so double-compute on a miss is fine)
        with _memo_lock:
            if len(_PATTERN_MEMO) >= 256:
                _PATTERN_MEMO.clear()
            hit = _PATTERN_MEMO.setdefault(
                memo_key,
                _compile_pattern(
                    keyword, wildcard, char_seq, reference_values, dtype
                ),
            )
    return hit


_PATTERN_MEMO: Dict[tuple, CompiledPattern] = {}
_memo_lock = threading.Lock()


def _compile_pattern(
    keyword: Union[str, Sequence[int], None] = None,
    wildcard: Union[str, int] = 0,
    char_seq: Union[str, Sequence[int], None] = (),
    reference_values: Optional[Sequence[int]] = None,
    dtype=np.uint8,
) -> CompiledPattern:
    """Compile a keyword (or value-scan sequence) into search tables.

    Mirrors the two ``MonkeyMoore<Ty>`` constructors
    (``monkey_moore.cpp:12-39``): pass ``reference_values`` for value-scan
    mode (wildcard forced to 0), otherwise ``keyword`` [+ ``wildcard`` /
    ``char_seq``] for relative mode.
    """
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.uint8), np.dtype(np.uint16)):
        raise PatternError(f"unsupported element dtype {dtype}")
    tmax = int(np.iinfo(dtype).max)

    if reference_values is not None:
        if len(reference_values) == 0:
            raise PatternError("reference_values must not be empty")
        key = tuple(int(v) for v in reference_values)
        wc = 0
        seq = ()
        mode = SearchMode.VALUE_SCAN
        has_case_change = False
    else:
        key = to_codepoints(keyword)
        if len(key) == 0:
            raise PatternError("keyword must not be empty")
        wc = ord(wildcard) if isinstance(wildcard, str) else int(wildcard)
        seq = to_codepoints(char_seq)
        # Mode selection parity: ``initialize`` (``monkey_moore.cpp:54-78``).
        has_wildcards = key.count(wc) > 0
        has_case_change = False
        if len(seq) == 0:
            n_upper = sum(1 for c in key if is_ascii_upper(c))
            n_lower = sum(1 for c in key if is_ascii_lower(c))
            has_case_change = n_upper > 0 and n_lower > 0
        mode = (
            SearchMode.WILDCARD
            if (has_wildcards or has_case_change)
            else SearchMode.SIMPLE
        )

    L = len(key)
    char_index: Dict[int, int] = {c: i for i, c in enumerate(seq)}

    if mode in (SearchMode.SIMPLE, SearchMode.VALUE_SCAN):
        return _compile_no_wildcards(
            mode, dtype, tmax, key, wc, seq, char_index, L
        )
    return _compile_with_wildcards(
        mode, dtype, tmax, key, wc, seq, char_index, L, has_case_change
    )


def _build_skip_index(diff: int, tmax: int, table_len: int) -> int:
    """Map a signed diff onto the skip table (negative → [0, tmax], positive →
    [tmax+1, 2*tmax+1]); out-of-range raises like ``monkey_moore.cpp:137-140``."""
    index = diff + tmax
    if index < 0 or index >= table_len:
        raise PatternError("Skip table index out of bounds")
    return index


def _compile_no_wildcards(mode, dtype, tmax, key, wc, seq, char_index, L):
    """Parity: ``preprocess_no_wildcards`` (``monkey_moore.cpp:106-142``)."""
    if len(seq) == 0:
        diffs = _circular_diffs(key)
    else:
        idx = [_seq_index_lookup(char_index, c) for c in key]
        diffs = _circular_diffs(idx)

    table_len = 2 * (tmax + 1)
    skip = np.full(table_len, L - 1, dtype=np.int32)
    # Descending i, first write wins ⇒ rightmost occurrence of each diff value
    # (``monkey_moore.cpp:127-141``; i = 0's write equals the default so the
    # wrap diff never changes the table, but its bounds check still applies).
    for i in range(L - 1, -1, -1):
        index = _build_skip_index(int(diffs[i]), tmax, table_len)
        if skip[index] == L - 1:
            skip[index] = L - i - 1

    ty = np.dtype(dtype).type
    neutral_ty = np.zeros(L, dtype=dtype)
    # Dense checks: signed adjacent diffs for i in [1, L); the wrap pair
    # (i = 0) telescopes to truth whenever the others hold.
    chk_cur = np.arange(1, L, dtype=np.int32)
    chk_prev = np.arange(0, L - 1, dtype=np.int32)
    chk_exp = diffs[1:].astype(np.int32)

    return CompiledPattern(
        mode=mode,
        dtype=dtype,
        tmax=tmax,
        keyword=key,
        wildcard=wc,
        char_seq=seq,
        char_index=char_index,
        length=L,
        expected_diff=diffs.astype(np.int32),
        skip_table=skip,
        case_normalized=key,
        is_literal=np.ones(L, dtype=bool),
        bridge_offset=np.concatenate(
            ([np.int32(L - 1)], np.full(L - 1, -1, dtype=np.int32))
        )
        if L > 1
        else np.zeros(1, dtype=np.int32),
        wc_expected=diffs.astype(np.int64).astype(dtype),
        wc_mask=np.full(L, tmax, dtype=dtype),
        wildcard_skip_table=np.ones(L, dtype=np.int32),
        leading_wildcards=0,
        wildcards_count=0,
        first_literal=0,
        has_case_change=False,
        mostly_lowercase=False,
        first_opposing=-1,
        advance=L - 1,
        chk_shift_cur=chk_cur,
        chk_shift_prev=chk_prev,
        chk_expected=chk_exp,
        signed_compare=True,
    )


def _compile_with_wildcards(
    mode, dtype, tmax, key, wc, seq, char_index, L, has_case_change
):
    """Parity: ``preprocess_with_wildcards`` (``monkey_moore.cpp:144-304``)."""
    normalized = list(key)

    # Step 1: mixed-case auto-wildcarding (``monkey_moore.cpp:150-181``).
    mostly_lowercase = False
    if len(seq) == 0:
        n_upper = sum(1 for c in key if is_ascii_upper(c))
        n_lower = sum(1 for c in key if is_ascii_lower(c))
        mostly_lowercase = n_lower > n_upper
        if n_upper > 0 and n_lower > 0:
            if n_upper > n_lower:
                normalized = [wc if is_ascii_lower(c) else c for c in normalized]
            else:
                normalized = [wc if is_ascii_upper(c) else c for c in normalized]

    # Step 2: literal map (``monkey_moore.cpp:183-199``).
    is_literal = np.array([c != wc for c in normalized], dtype=bool)
    valid = [i for i in range(L) if is_literal[i]]
    wildcards_count = L - len(valid)

    # Step 3: bridging + expected diffs (``monkey_moore.cpp:201-247``).
    expected = np.zeros(L, dtype=np.int64)
    bridge = np.zeros(L, dtype=np.int32)
    wc_expected = np.zeros(L, dtype=dtype)
    wc_mask = np.zeros(L, dtype=dtype)
    for k, cur in enumerate(valid):
        prev = valid[-1] if k == 0 else valid[k - 1]
        bridge[cur] = prev - cur
        if len(seq) == 0:
            rel = normalized[cur] - normalized[prev]
        else:
            rel = _seq_index_lookup(
                char_index, normalized[cur]
            ) - _seq_index_lookup(char_index, normalized[prev])
        expected[cur] = rel
        wc_expected[cur] = np.int64(rel).astype(dtype)
        wc_mask[cur] = tmax  # all-ones in Ty

    # Step 4: bad-character skip table (``monkey_moore.cpp:249-276``).
    # Unlike the no-wildcard build this (a) skips i = 0, (b) has no
    # "first write wins" guard (descending loop ⇒ the *leftmost* i >= 1 wins),
    # and (c) stores values through a (signed) char cast.
    table_len = 2 * (tmax + 1)
    fill = np.int8(L - 1)  # static_cast<char>(keyword_len - 1)
    skip = np.full(table_len, int(fill), dtype=np.int32)
    for i in range(L - 1, 0, -1):
        index = _build_skip_index(int(expected[i]), tmax, table_len)
        remaining_wc = sum(1 for c in normalized[i + 1 :] if c == wc)
        skip[index] = int(np.int8(L - remaining_wc - i - 1))

    # Step 5: wildcard skip table (``monkey_moore.cpp:278-303``).
    wskip = np.zeros(L, dtype=np.int32)
    for i in range(L - 1, -1, -1):
        if normalized[i] == wc:
            wskip[i] = 1
        else:
            last_wc = find_last_index(normalized[:i], wc)
            if last_wc == -1:
                last_wc = 0
            wskip[i] = int(np.uint8(max(i - last_wc - 1, 1)))

    leading = count_prefix_length(normalized, wc)
    first_literal = valid[0] if valid else -1

    # Opposite-case recovery info (``monkey_moore.cpp:483-512``): first char of
    # the *original* keyword in the minority case.
    first_opposing = -1
    if has_case_change:
        want_upper = mostly_lowercase
        for i, c in enumerate(key):
            if (is_ascii_upper(c) if want_upper else is_ascii_lower(c)):
                first_opposing = i
                break
        if first_opposing == -1:
            raise PatternError(
                "Unexpected end of keyword when finding characters of opposing case"
            )

    # Dense checks: masked unsigned diffs at every literal except the first
    # (the first literal's wrap-bridge telescopes to truth mod 2^w).
    chk_cur = np.array(valid[1:], dtype=np.int32)
    chk_prev = np.array(
        [v + bridge[v] for v in valid[1:]], dtype=np.int32
    )
    chk_exp = wc_expected[np.array(valid[1:], dtype=np.intp)] if valid[1:] else np.zeros(
        0, dtype=dtype
    )

    return CompiledPattern(
        mode=mode,
        dtype=dtype,
        tmax=tmax,
        keyword=key,
        wildcard=wc,
        char_seq=seq,
        char_index=char_index,
        length=L,
        expected_diff=expected.astype(np.int32),
        skip_table=skip,
        case_normalized=tuple(normalized),
        is_literal=is_literal,
        bridge_offset=bridge,
        wc_expected=wc_expected,
        wc_mask=wc_mask,
        wildcard_skip_table=wskip,
        leading_wildcards=leading,
        wildcards_count=wildcards_count,
        first_literal=first_literal,
        has_case_change=has_case_change,
        mostly_lowercase=mostly_lowercase,
        first_opposing=first_opposing,
        advance=L - 1 - leading,
        chk_shift_cur=chk_cur,
        chk_shift_prev=chk_prev,
        chk_expected=np.asarray(chk_exp, dtype=dtype),
        signed_compare=False,
    )
