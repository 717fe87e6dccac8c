"""Multi-host orchestration (layer L4).

Scales the search across hosts.  Design (mirrors the reference's
overlapping block reads rather than exchanging halos over DCN,
``src/core/search_engine.cpp:120-127``):

- each host reads its own byte range of the file **plus**
  ``(pattern_len-1)*element_size`` halo bytes past the end (overlapping host
  reads make cross-host halo exchange unnecessary — the same trick the
  reference uses per block);
- each host scans its range on its local device mesh (``sharded.py``);
- per-host result lists are exchanged with
  ``jax.experimental.multihost_utils.process_allgather`` and merged/sorted
  globally (the DCN analog of the engine's future harvesting,
  ``search_engine.cpp:83-102,193-197``).

Single-host processes degrade gracefully: ``host_byte_range`` covers the
whole file and the gather is the identity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "initialize_distributed",
    "host_byte_range",
    "gather_results",
    "process_count",
    "process_index",
]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Wrapper over ``jax.distributed.initialize`` (no-op when single-host
    and no coordinator is configured)."""
    import jax

    if coordinator_address is None and num_processes is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_count() -> int:
    import jax

    return jax.process_count()


def process_index() -> int:
    import jax

    return jax.process_index()


def host_byte_range(
    file_size: int,
    pattern_len: int,
    element_size: int,
    index: Optional[int] = None,
    count: Optional[int] = None,
) -> Tuple[int, int]:
    """This host's (start, stop) byte range including trailing halo.

    Ranges advance by ``ceil(file_size / hosts)`` and read
    ``pattern_len*element_size - 1`` extra bytes so matches straddling host
    boundaries are found by exactly one host — the host whose base region
    contains the match start.  (Note: this halo is ``element_size - 1`` bytes
    *longer* than the reference's block halo, ``search_engine.cpp:227``, which
    is one element short for odd-aligned 16-bit matches near a block end and
    silently misses them; host ranges are a new layer with no reference
    behavior to mirror, so they are lossless.)
    """
    if count is None:
        count = process_count()
    if index is None:
        index = process_index()
    base = -(-file_size // count)
    halo = pattern_len * element_size - 1
    start = min(index * base, file_size)
    stop = min(start + base + halo, file_size)
    return start, stop


def gather_results(offsets: np.ndarray, values: np.ndarray):
    """All-gather per-host candidate lists across processes and merge-sort
    by offset.  Uses fixed-size padding (max count across hosts) since
    collectives need static shapes."""
    import jax

    if jax.process_count() == 1:
        return offsets, values

    from jax.experimental import multihost_utils

    local_n = np.array([len(offsets)], dtype=np.int64)
    counts = multihost_utils.process_allgather(local_n).reshape(-1)
    cap = int(counts.max())
    pad_offs = np.full(cap, -1, dtype=np.int64)
    pad_offs[: len(offsets)] = offsets
    pad_vals = np.zeros((cap, 2), dtype=np.int64)
    pad_vals[: len(values)] = values
    all_offs = multihost_utils.process_allgather(pad_offs)
    all_vals = multihost_utils.process_allgather(pad_vals)
    offs = all_offs.reshape(-1)
    vals = all_vals.reshape(-1, 2)
    keep = offs >= 0
    offs, vals = offs[keep], vals[keep]
    order = np.argsort(offs, kind="stable")
    return offs[order], vals[order]
