"""Multi-host initialization and mesh construction.

The reference is strictly single-GPU/single-process (SURVEY.md §2.2). The
multi-process scaling path spans hosts: ``jax.distributed`` brings up the
process group, and the pixel-row mesh then spans every device in the job.
Scene tables stay replicated; the only cross-host traffic is the inverse
renderer's gradient ``psum``.

On a single host (or under the CPU device-count simulation used in CI) these
helpers degrade to the local device list.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from .sharding import AXIS


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Initialize ``jax.distributed`` when running multi-process.

    All arguments default from the standard environment
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``);
    a single-process run is a no-op.
    """
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num_processes,
        process_id=process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0")),
    )


def global_pixel_mesh() -> Mesh:
    """1-D mesh over every device in the job (all hosts), for pixel-row
    sharding. Device order follows ``jax.devices()``, so each process's
    devices are contiguous."""
    return Mesh(np.asarray(jax.devices()), (AXIS,))


def _row_span(height: int, device_process_ids, pid: int):
    """Pure core of ``host_local_rows``: (start_row, n_rows) for the process
    ``pid`` given the mesh's flat device->process assignment. Requires the
    process's devices to be contiguous in mesh order (true for
    ``jax.devices()``, which sorts by process); raises otherwise rather than
    silently returning a wrong span."""
    ids = np.flatnonzero(np.asarray(device_process_ids) == pid)
    if ids.size == 0:
        return 0, 0
    if ids[-1] - ids[0] != ids.size - 1:
        raise ValueError(
            f"process {pid}'s devices are not contiguous in mesh order: "
            f"positions {ids.tolist()}"
        )
    n_dev = len(device_process_ids)
    rows_per_dev = -(-height // n_dev)
    start = int(ids[0]) * rows_per_dev
    n_rows = int(ids.size) * rows_per_dev
    start = min(start, height)
    return start, max(0, min(n_rows, height - start))


def host_local_rows(height: int, mesh: Mesh):
    """(start_row, n_rows) of this process's contiguous row span — useful
    for host-side IO (e.g. each host writes its strip of the framebuffer)."""
    pids = [d.process_index for d in mesh.devices.flat]
    return _row_span(height, pids, jax.process_index())
