"""Device mesh construction.

The reference scales spatially inside one FPGA with FEA_THREADS/ADJ_THREADS
row-sharding (kernelMatrixmult_all.cpp:3060-3072,3439-3452); the
replacement is a 1D device mesh over which graph rows/edges are sharded, with
XLA collectives (NCCL on GPUs). The cards of one H100 host are joined all to
all by NVLink, so the mesh order follows the algorithm alone. Multi-host
extends the same mesh via jax.distributed (same code path — GSPMD is
host-count agnostic).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = "graph"
) -> Mesh:
    """1D mesh over the first n_devices local devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join a multi-host job (jax.distributed). Pass the coordinator
    address, process count and process id explicitly: nothing on an
    unmanaged cluster tells JAX about the others. After this,
    ``make_mesh()`` spans every device in the job and the same shard_map
    code runs within a host and across hosts. No-op if already
    initialized."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def global_mesh(axis_name: str = "graph") -> Mesh:
    """1D mesh over every device in the (possibly multi-host) job."""
    return Mesh(np.array(jax.devices()), (axis_name,))
