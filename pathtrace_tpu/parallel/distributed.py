"""Multi-host bootstrap.

The reference is single-process/single-GPU with no communication backend
(SURVEY.md §2: no NCCL/MPI; unified memory only). For several hosts we
use jax.distributed + a 1-D mesh over every device: scene arrays
replicated (broadcast once at setup), film tiles and rays sharded, psum
over NVLink within a host and the network across hosts.

On a single host this degenerates to the plain device mesh
(parallel/mesh.py), which is what CI and the virtual-device tests use.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from pathtrace_tpu.parallel.mesh import RAY_AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize passthrough; no-op if single-process
    (all args None and env unset)."""
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        import os
        if "JAX_COORDINATOR_ADDRESS" not in os.environ:
            return  # single process
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_ray_mesh() -> Mesh:
    """1-D mesh over ALL global devices (across hosts). Rays shard on it;
    XLA picks the links for the collectives (NVLink within a host)."""
    return jax.make_mesh((len(jax.devices()),), (RAY_AXIS,))


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
