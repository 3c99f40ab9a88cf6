"""Structure-of-arrays primitive batches (the scene's differentiable leaves).

The reference stores per-object C++ classes in vectors (Shape.h:59-307) and
linearly scans them per ray. Here each primitive family is a single SoA
pytree so a whole family intersects against a whole ray block as one fused
vector/matrix computation.

Every family carries an `active` mask so blocks can be padded to
fixed capacities (or to a multiple of a mesh axis): padded slots simply never hit. Padding
keeps shapes static across scene edits of the same capacity, avoiding
re-jits during inverse rendering.

`Triangles` covers both the reference's freestanding triangles and its
`Model` meshes (Shape.h:248-307): a mesh becomes a triangle block with a
shared material and a `group` id (the reference reports hit.index = model
index for mesh hits — Shape.h:276).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from raytracingengine.geometry.materials import Materials


def _concat(parts):
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["centers", "radii", "materials", "active"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Spheres:
    centers: jnp.ndarray  # [S, 3]
    radii: jnp.ndarray  # [S]
    materials: Materials  # fields [S, ...]
    active: jnp.ndarray  # [S] bool

    @staticmethod
    def empty(dtype=jnp.float32) -> "Spheres":
        return Spheres(
            centers=jnp.zeros((0, 3), dtype),
            radii=jnp.zeros((0,), dtype),
            materials=Materials.empty(dtype),
            active=jnp.zeros((0,), jnp.bool_),
        )

    def __len__(self) -> int:
        return self.radii.shape[0]

    @staticmethod
    def concat(parts: list["Spheres"]) -> "Spheres":
        return _concat(parts)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["points", "normals", "materials", "active"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Planes:
    """Infinite planes: a point on the plane + a normal.

    The reference normalizes the normal at construction (Shape.h:141-142);
    builders here do the same, and the intersection normalizes defensively
    so gradients w.r.t. raw normals stay well-defined.
    """

    points: jnp.ndarray  # [P, 3]
    normals: jnp.ndarray  # [P, 3], unit
    materials: Materials
    active: jnp.ndarray  # [P] bool

    @staticmethod
    def empty(dtype=jnp.float32) -> "Planes":
        return Planes(
            points=jnp.zeros((0, 3), dtype),
            normals=jnp.zeros((0, 3), dtype),
            materials=Materials.empty(dtype),
            active=jnp.zeros((0,), jnp.bool_),
        )

    def __len__(self) -> int:
        return self.points.shape[0]

    @staticmethod
    def concat(parts: list["Planes"]) -> "Planes":
        return _concat(parts)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["v0", "v1", "v2", "materials", "active", "group"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Triangles:
    """Triangle soup, vertices already in world space.

    (The reference translates triangle vertices by transform.position at
    intersection time — Shape.h:198-200; we bake that in at build time,
    keeping the translation differentiable through the bake.)

    `group` is the reported hit index: the freestanding-triangle index, or
    the model index for mesh triangles (Shape.h:276 reports the model id).
    """

    v0: jnp.ndarray  # [T, 3]
    v1: jnp.ndarray  # [T, 3]
    v2: jnp.ndarray  # [T, 3]
    materials: Materials
    active: jnp.ndarray  # [T] bool
    group: jnp.ndarray  # [T] int32

    @staticmethod
    def empty(dtype=jnp.float32) -> "Triangles":
        z = jnp.zeros((0, 3), dtype)
        return Triangles(
            v0=z,
            v1=z,
            v2=z,
            materials=Materials.empty(dtype),
            active=jnp.zeros((0,), jnp.bool_),
            group=jnp.zeros((0,), jnp.int32),
        )

    def __len__(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def concat(parts: list["Triangles"]) -> "Triangles":
        return _concat(parts)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["positions", "colors", "intensities", "active"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights (Light.h:6-15): position, color, intensity.

    emitted = color * intensity (Light.h:48-50); falloff 1/d^2 is applied
    by the shading code (Scene.h:110-113).
    """

    positions: jnp.ndarray  # [L, 3]
    colors: jnp.ndarray  # [L, 3]
    intensities: jnp.ndarray  # [L]
    active: jnp.ndarray  # [L] bool

    @staticmethod
    def empty(dtype=jnp.float32) -> "Lights":
        return Lights(
            positions=jnp.zeros((0, 3), dtype),
            colors=jnp.zeros((0, 3), dtype),
            intensities=jnp.zeros((0,), dtype),
            active=jnp.zeros((0,), jnp.bool_),
        )

    def __len__(self) -> int:
        return self.intensities.shape[0]

    @staticmethod
    def concat(parts: list["Lights"]) -> "Lights":
        return _concat(parts)
