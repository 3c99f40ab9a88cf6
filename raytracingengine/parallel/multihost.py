"""Multi-host initialization and mesh layout.

The reference is strictly single-process (SURVEY.md §2: no NCCL/MPI/
anything). Scale-out here: `jax.distributed.initialize` connects the
processes, and the global device list forms a ('rays', 'prims') mesh
(parallel/mesh.py). Rays need no cross-device traffic; the per-ray winner
combine over 'prims' and the scene-parameter gradient psums are the only
collectives.

Single-process runs skip initialize and just build a local mesh, so the
same entry points work everywhere. Nothing is auto-detected: pass the
coordinator address, process count and process id, or set
JAX_COORDINATOR_ADDRESS (with JAX's own JAX_NUM_PROCESSES /
JAX_PROCESS_ID).
"""

from __future__ import annotations

import os

import jax

from raytracingengine.parallel.mesh import make_mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Call jax.distributed.initialize when a coordinator is given.

    Returns True if distributed mode was initialized. The coordinator is
    the argument or JAX_COORDINATOR_ADDRESS; without either this is a
    no-op (single process).
    """
    if not (coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_global_mesh(n_prim_shards: int = 1):
    """('rays',) or ('rays','prims') mesh over *all* processes' devices.

    Device order from jax.devices() groups by process, so contiguous
    blocks of the ray axis land on single processes. `n_prim_shards` > 1
    carves the prim axis from within each process's devices (must divide
    the local device count).
    """
    n = len(jax.devices())
    if n % max(n_prim_shards, 1) != 0:
        raise ValueError(f"{n} devices not divisible by {n_prim_shards} prim shards")
    return make_mesh(
        n_ray_shards=n // n_prim_shards, n_prim_shards=n_prim_shards
    )
