"""Device mesh helpers.

The reference's only parallelism is three pthreads + a mutex
(SURVEY.md §2 parallelism inventory). Here the scaling dimension is a
jax.sharding Mesh: landmark blocks shard over the `lm` axis (Schur
assembly is a sum of per-landmark outer products -> psum across
devices), and multi-sequence batch runs shard over an optional `seq`
axis. The mesh is a flat 1-D list of devices. Multi-host initialization
is jax.distributed (XLA's collectives are the backend)."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "lm") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Multi-host runtime init (call once per host before make_mesh).
    No-op when single-process."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
