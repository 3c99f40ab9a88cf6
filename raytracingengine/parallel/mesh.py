"""Device-mesh construction for the renderer.

The reference's entire parallelism story is one OpenMP `parallel for`
over pixels (Scene.h:318-320). The equivalents here:

  * `rays` axis — pixels/rays sharded across devices (the data-parallel /
    context-parallel analog; scene replicated),
  * `prims` axis — the triangle block sharded across devices (the
    tensor-parallel analog for huge meshes; ray blocks replicated along
    this axis, winners combined with an all_gather argmin).

A 1D mesh uses just `rays`; a 2D mesh uses both. The mesh follows the
algorithm only: the four GPUs of a host reach each other at one rate
(NVLink, all to all), so no axis order is preferred.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

RAY_AXIS = "rays"
PRIM_AXIS = "prims"


def make_mesh(
    n_ray_shards: int | None = None,
    n_prim_shards: int = 1,
    devices=None,
) -> Mesh:
    """Build a ('rays',) or ('rays', 'prims') mesh over the given devices
    (default: all)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_ray_shards is None:
        n_ray_shards = n // n_prim_shards
    if n_ray_shards * n_prim_shards != n:
        raise ValueError(
            f"mesh {n_ray_shards}x{n_prim_shards} != {n} devices"
        )
    arr = np.asarray(devices).reshape(n_ray_shards, n_prim_shards)
    if n_prim_shards == 1:
        return Mesh(arr.reshape(-1), (RAY_AXIS,))
    return Mesh(arr, (RAY_AXIS, PRIM_AXIS))
