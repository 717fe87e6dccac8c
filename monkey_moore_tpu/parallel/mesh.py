"""Device mesh helpers.

The reference's only parallelism is data-parallel file blocks on a CPU thread
pool (``src/core/search_engine.cpp:67-175``).  The device analog is a 1-D
``jax.sharding.Mesh`` over the corpus ("data" axis = the sequence dimension),
with halo exchange between neighbor devices at shard boundaries
(``sharded.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["DATA_AXIS", "make_mesh"]

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence] = None, n: Optional[int] = None) -> Mesh:
    """1-D mesh over *devices* (default: all local devices, optionally the
    first *n*)."""
    if devices is None:
        devices = jax.devices()
    if n is not None:
        devices = devices[:n]
    return Mesh(np.array(devices), (DATA_AXIS,))
