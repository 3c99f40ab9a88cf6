"""Scene container + host-side builder.

The reference Scene owns vectors of primitives plus the camera and exposes
AddSphere/AddPlane/AddTriangle/AddModel/AddLight mutators (Scene.h:14-212).
Here the runtime `Scene` is an immutable pytree of SoA primitive blocks —
the differentiable parameter set for inverse rendering — and `SceneBuilder`
is the host-side mutable staging area that assembles it.

Meshes (the reference's `Model`, Shape.h:248-307) are triangulated into the
shared triangle block at build time with `group` = model index, matching
the reference's hit-index semantics (Shape.h:276). The builder can pad
every family to a chosen multiple so the compiled program is reusable
across scenes of the same padded capacity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from raytracingengine.geometry.materials import Material, Materials
from raytracingengine.geometry.primitives import Lights, Planes, Spheres, Triangles


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["spheres", "planes", "triangles", "lights"],
    meta_fields=["has_transparency"],
)
@dataclasses.dataclass(frozen=True)
class Scene:
    spheres: Spheres
    planes: Planes
    triangles: Triangles
    lights: Lights
    #: Static hint: True if any material may transmit light. Chooses the
    #: integrator (chain vs branching wavefront) and whether the shadow
    #: march must track partial transmittance.
    has_transparency: bool = False

    @property
    def n_primitives(self) -> int:
        return len(self.spheres) + len(self.planes) + len(self.triangles)


def _pad_to(n: int, multiple: int | None) -> int:
    if not multiple or multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


class SceneBuilder:
    """Mutable host-side scene assembly (numpy), -> immutable Scene pytree."""

    def __init__(self):
        self._spheres: list[tuple] = []  # (center, radius, Material)
        self._planes: list[tuple] = []  # (point, normal, Material)
        self._tris: list[tuple] = []  # (v0, v1, v2, Material, group)
        self._lights: list[tuple] = []  # (pos, color, intensity)
        self._n_models = 0
        self._n_free_tris = 0

    # -- mutators (the reference's AddX API, Scene.h:208-212) --------------

    def add_sphere(self, center, radius: float, material: Material) -> "SceneBuilder":
        self._spheres.append((np.asarray(center, np.float64), float(radius), material))
        return self

    def add_plane(self, point, normal, material: Material) -> "SceneBuilder":
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)  # normalized at construction (Shape.h:141-142)
        self._planes.append((np.asarray(point, np.float64), n, material))
        return self

    def add_triangle(
        self, v0, v1, v2, material: Material, translation=(0.0, 0.0, 0.0)
    ) -> "SceneBuilder":
        t = np.asarray(translation, np.float64)
        self._tris.append(
            (
                np.asarray(v0, np.float64) + t,
                np.asarray(v1, np.float64) + t,
                np.asarray(v2, np.float64) + t,
                material,
                self._n_free_tris,
            )
        )
        self._n_free_tris += 1
        return self

    def add_model(
        self,
        vertices: np.ndarray,
        indices: np.ndarray,
        material: Material,
        translation=(0.0, 0.0, 0.0),
    ) -> "SceneBuilder":
        """Indexed triangle mesh; `indices` is a flat [3*k] vertex-index
        list (the reference's Model storage, Shape.h:251-252). Vertices are
        translated by `translation` (transform.position, Shape.h:198-200).
        """
        verts = np.asarray(vertices, np.float64).reshape(-1, 3)
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        t = np.asarray(translation, np.float64)
        gid = self._n_models
        for tri in idx:
            self._tris.append(
                (
                    verts[tri[0]] + t,
                    verts[tri[1]] + t,
                    verts[tri[2]] + t,
                    material,
                    gid,
                )
            )
        self._n_models += 1
        return self

    def add_light(self, position, color, intensity: float) -> "SceneBuilder":
        self._lights.append(
            (np.asarray(position, np.float64), np.asarray(color, np.float64), float(intensity))
        )
        return self

    # -- build -------------------------------------------------------------

    def build(self, dtype=jnp.float32, pad_multiple: int | None = None) -> Scene:
        default_mat = Material()

        def mat_block(mats: list[Material], n_pad: int) -> Materials:
            return Materials.stack(mats + [default_mat] * n_pad, dtype=dtype)

        ns, npl, nt, nl = (
            len(self._spheres),
            len(self._planes),
            len(self._tris),
            len(self._lights),
        )
        ps = _pad_to(ns, pad_multiple)
        pp = _pad_to(npl, pad_multiple)
        pt = _pad_to(nt, pad_multiple)
        pLt = _pad_to(nl, pad_multiple)

        def arr(vals, pad, width=3, fill=0.0):
            a = np.full((pad, width) if width else (pad,), fill, np.float64)
            for i, v in enumerate(vals):
                a[i] = v
            return jnp.asarray(a, dtype=dtype)

        def mask(n, pad):
            return jnp.asarray(np.arange(pad) < n)

        spheres = Spheres(
            centers=arr([s[0] for s in self._spheres], ps),
            radii=arr([s[1] for s in self._spheres], ps, width=0, fill=1.0),
            materials=mat_block([s[2] for s in self._spheres], ps - ns),
            active=mask(ns, ps),
        )
        planes = Planes(
            points=arr([p[0] for p in self._planes], pp),
            normals=arr([p[1] for p in self._planes], pp),
            materials=mat_block([p[2] for p in self._planes], pp - npl),
            active=mask(npl, pp),
        )
        triangles = Triangles(
            v0=arr([t[0] for t in self._tris], pt),
            v1=arr([t[1] for t in self._tris], pt),
            v2=arr([t[2] for t in self._tris], pt),
            materials=mat_block([t[3] for t in self._tris], pt - nt),
            active=mask(nt, pt),
            group=jnp.asarray(
                [t[4] for t in self._tris] + [0] * (pt - nt), jnp.int32
            ),
        )
        lights = Lights(
            positions=arr([l[0] for l in self._lights], pLt),
            colors=arr([l[1] for l in self._lights], pLt),
            intensities=arr([l[2] for l in self._lights], pLt, width=0),
            active=mask(nl, pLt),
        )
        has_transparency = any(
            m.transparency > 0.0
            for m in (
                [s[2] for s in self._spheres]
                + [p[2] for p in self._planes]
                + [t[3] for t in self._tris]
            )
        )
        return Scene(
            spheres=spheres,
            planes=planes,
            triangles=triangles,
            lights=lights,
            has_transparency=has_transparency,
        )
