"""Equivalency-map recovery.

Once a window matches, the encoding table is recovered from a *single* data
value (plus one more for mixed-case keywords): the distance between the data
value under the first literal and that literal's reference value.  Mirrors:

- simple/value-scan recovery — ``src/core/monkey_moore.cpp:374-393``
- wildcard recovery (incl. independent mixed-case shifts)
  — ``src/core/monkey_moore.cpp:472-521``

The dense device path gathers only the needed data values per match on device
(O(matches) work), then calls :func:`recover_from_values` on host; the
sequential oracle shares the same code path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..pattern import CompiledPattern, SearchMode

__all__ = ["recovery_shifts", "recover_from_values"]

_ORD_A_UP = ord("A")
_ORD_A_LO = ord("a")


def recovery_shifts(pat: CompiledPattern) -> List[int]:
    """Window-relative element offsets whose data values recovery needs.

    SIMPLE/VALUE_SCAN read the window head (``monkey_moore.cpp:381,387``);
    WILDCARD reads the first literal (``:477,515``) and, for mixed-case
    keywords, the first opposite-case position (``:502``).
    """
    if pat.mode in (SearchMode.SIMPLE, SearchMode.VALUE_SCAN):
        return [0]
    shifts = [pat.first_literal if pat.first_literal >= 0 else 0]
    if pat.has_case_change:
        shifts.append(pat.first_opposing)
    return shifts


def recover_from_values(
    pat: CompiledPattern, values: Sequence[int]
) -> Dict[int, int]:
    """Build the equivalency map from the data values at
    :func:`recovery_shifts` offsets.  Keys are Unicode code points; values are
    element values wrapped to the element dtype.
    """
    ty = pat.dtype.type

    def wrap(x: int) -> int:
        return int(np.int64(x).astype(pat.dtype))

    if pat.mode is SearchMode.VALUE_SCAN:
        # Value scan reports offsets only (``monkey_moore.cpp:377``).
        return {}

    if pat.mode is SearchMode.SIMPLE:
        head = int(values[0])
        if len(pat.char_seq) == 0:
            distance = head - pat.keyword[0]
            return {
                _ORD_A_UP: wrap(_ORD_A_UP + distance),
                _ORD_A_LO: wrap(_ORD_A_LO + distance),
            }
        distance = head - pat.char_index.get(pat.keyword[0], 0)
        return {c: wrap(pat.char_index[c] + distance) for c in pat.char_seq}

    # WILDCARD mode.
    first_val = int(values[0])
    if len(pat.char_seq) == 0:
        distance = first_val - pat.case_normalized[pat.first_literal]
        if not pat.has_case_change:
            return {
                _ORD_A_UP: wrap(_ORD_A_UP + distance),
                _ORD_A_LO: wrap(_ORD_A_LO + distance),
            }
        opposing_distance = int(values[1]) - pat.keyword[pat.first_opposing]
        if pat.mostly_lowercase:
            return {
                _ORD_A_UP: wrap(_ORD_A_UP + opposing_distance),
                _ORD_A_LO: wrap(_ORD_A_LO + distance),
            }
        return {
            _ORD_A_UP: wrap(_ORD_A_UP + distance),
            _ORD_A_LO: wrap(_ORD_A_LO + opposing_distance),
        }

    distance = first_val - pat.char_index.get(pat.keyword[pat.first_literal], 0)
    return {c: wrap(pat.char_index[c] + distance) for c in pat.char_seq}
