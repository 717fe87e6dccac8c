"""monkey_moore_tpu — a relative-search framework on JAX accelerators.

A from-scratch JAX/XLA re-design of the capabilities of
rjricken/monkey-moore (a relative-search utility for ROM hacking): find text
in binaries with unknown encodings by matching the pattern of successive
differences between element values, with wildcard support, 8/16-bit elements,
big/little endianness, value-scan mode, custom character sequences,
equivalency-map recovery, previews, and Thingy-table export.

Architecture (device-first, see SURVEY.md §7):

- ``pattern``    — pattern compiler: keyword → numeric check/skip tables (L0)
- ``oracle``     — exact sequential reference walker (conformance truth, L1)
- ``ops``        — dense scan (XLA), host scanner, suppression, recovery (L2)
- ``engine``     — chunked file search engine with progress/abort/previews (L3)
- ``parallel``   — mesh sharding, halo exchange, multi-host orchestration (L4)
- ``tables``/``sequences``/``prefs``/``cli`` — UX parity layer (L5)
"""

from .config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
    SearchResult,
    SearchStep,
)
from .pattern import CompiledPattern, PatternError, SearchMode, compile_pattern
from .oracle import OracleSearcher, oracle_search
from .async_search import AsyncSearch, SearchEvent

__version__ = "0.5.0"

__all__ = [
    "Endianness",
    "MatchSemantics",
    "SearchConfig",
    "SearchResult",
    "SearchStep",
    "CompiledPattern",
    "PatternError",
    "SearchMode",
    "compile_pattern",
    "OracleSearcher",
    "oracle_search",
    "AsyncSearch",
    "SearchEvent",
    "__version__",
]
