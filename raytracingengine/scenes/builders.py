"""Standard scenes: the reference's HEAD scene + the BASELINE.json configs.

`head_box_scene` rebuilds main() (RaytracingEngine.cpp:216-290): camera at
(0,0,-25) with focal 500 px and near/far 0/200, a box mesh at (0,0,10)
with a blue specular material, five axis-aligned planes at distance 15
forming an open Cornell-like box (white/green/blue/white/white, specular
0.01, shininess 0.128, refractive index 1.5), and two white point lights
of intensity 150 at (0,0,-5) and (-2,2,-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raytracingengine.core.camera import Camera
from raytracingengine.geometry.materials import Material
from raytracingengine.scene import Scene, SceneBuilder
from raytracingengine.scenes.assets import cube_mesh

#: Plane set from RaytracingEngine.cpp:253-284.
_PLANE_NORMALS = [
    (0, 0, -1),
    (1, 0, 0),
    (-1, 0, 0),
    (0, 1, 0),
    (0, -1, 0),
]
_PLANE_COLORS = [
    (1, 1, 1),
    (0, 1, 0),
    (0, 0, 1),
    (1, 1, 1),
    (1, 1, 1),
]


def _add_cornell_planes(b: SceneBuilder, distance: float = 15.0) -> None:
    for n, c in zip(_PLANE_NORMALS, _PLANE_COLORS):
        mat = Material(
            color=c, shininess=0.128, specular=0.01, transparency=0.0,
            refractive_index=1.5,
        )
        point = tuple(-distance * x for x in n)
        b.add_plane(point, n, mat)


def head_box_scene(
    width: int = 1000,
    height: int = 1000,
    spp: int = 32,
    dtype=jnp.float32,
    pad_multiple: int | None = None,
) -> tuple[Scene, Camera]:
    """The HEAD main() scene (RaytracingEngine.cpp:216-290), with the
    missing box.obj replaced by a procedural cube (scenes/assets.py)."""
    b = SceneBuilder()
    box_mat = Material(
        color=(0, 0, 1), shininess=128.0, specular=0.5, transparency=0.0,
        refractive_index=1.5,
    )
    verts, idx = cube_mesh(size=4.0)
    b.add_model(verts, idx, box_mat, translation=(0, 0, 10))
    _add_cornell_planes(b)
    b.add_light((0, 0, -5), (1, 1, 1), 150.0)
    b.add_light((-2, 2, -5), (1, 1, 1), 150.0)
    scene = b.build(dtype=dtype, pad_multiple=pad_multiple)
    camera = Camera.create(
        (0, 0, -25), focal=500.0, width=width, height=height, near=0.0,
        far=200.0, spp=spp, dtype=dtype,
    )
    return scene, camera


def baseline_sphere_scene(
    width: int = 256,
    height: int = 256,
    spp: int = 1,
    n_lights: int = 1,
    dtype=jnp.float32,
    pad_multiple: int | None = None,
) -> tuple[Scene, Camera]:
    """BASELINE config #1: spheres + plane + point light(s)."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 6.0), 2.0, Material(color=(0.8, 0.2, 0.2)))
    b.add_sphere(
        (-3.0, -1.0, 9.0), 1.0,
        Material(color=(0.2, 0.8, 0.2), specular=0.3, shininess=64.0),
    )
    b.add_sphere(
        (3.0, 1.0, 8.0), 1.5,
        Material(color=(0.2, 0.2, 0.8), specular=0.05, shininess=16.0),
    )
    b.add_plane((0.0, -2.5, 0.0), (0.0, 1.0, 0.0), Material(color=(0.9, 0.9, 0.9)))
    lights = [
        ((0.0, 6.0, -2.0), 80.0),
        ((-5.0, 4.0, 2.0), 50.0),
        ((5.0, 4.0, 2.0), 50.0),
        ((0.0, 8.0, 8.0), 60.0),
    ]
    for (pos, inten) in lights[:n_lights]:
        b.add_light(pos, (1, 1, 1), inten)
    scene = b.build(dtype=dtype, pad_multiple=pad_multiple)
    camera = Camera.create(
        (0, 0, -10), focal=float(width), width=width, height=height,
        near=0.0, far=100.0, spp=spp, dtype=dtype,
    )
    return scene, camera


def glass_sphere_scene(
    width: int = 64,
    height: int = 64,
    spp: int = 1,
    dtype=jnp.float32,
) -> tuple[Scene, Camera]:
    """A transparent (refractive) sphere over a plane — exercises the
    branching wavefront (refraction + Fresnel reflection + TIR)."""
    b = SceneBuilder()
    b.add_sphere(
        (0.0, 0.0, 5.0), 1.5,
        Material(
            color=(1.0, 1.0, 1.0), specular=0.0, transparency=0.9,
            refractive_index=1.5,
        ),
    )
    b.add_sphere((1.5, -0.8, 9.0), 1.0, Material(color=(0.9, 0.4, 0.1)))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), Material(color=(0.8, 0.8, 0.8)))
    b.add_light((-3.0, 5.0, -1.0), (1, 1, 1), 60.0)
    scene = b.build(dtype=dtype)
    camera = Camera.create(
        (0, 0, -8), focal=float(width), width=width, height=height,
        near=0.0, far=100.0, spp=spp, dtype=dtype,
    )
    return scene, camera


def stress_scene(
    n_spheres: int = 64,
    n_lights: int = 4,
    width: int = 3840,
    height: int = 2160,
    spp: int = 1,
    seed: int = 7,
    dtype=jnp.float32,
    pad_multiple: int | None = 128,
) -> tuple[Scene, Camera]:
    """BASELINE config #5: 64-sphere stress scene with 4 point lights at 4K."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for _ in range(n_spheres):
        center = rng.uniform([-12, -4, 4], [12, 8, 40])
        radius = float(rng.uniform(0.5, 2.0))
        color = tuple(rng.uniform(0.1, 1.0, 3))
        spec = float(rng.uniform(0.0, 0.4))
        b.add_sphere(center, radius, Material(color=color, specular=spec, shininess=64.0))
    b.add_plane((0.0, -5.0, 0.0), (0.0, 1.0, 0.0), Material(color=(0.85, 0.85, 0.85)))
    light_pos = [(-10, 15, -5), (10, 15, -5), (0, 20, 20), (0, 5, -15)]
    for i in range(n_lights):
        b.add_light(light_pos[i % 4], (1, 1, 1), 200.0)
    scene = b.build(dtype=dtype, pad_multiple=pad_multiple)
    camera = Camera.create(
        (0, 1, -25), focal=float(width) / 2.0, width=width, height=height,
        near=0.0, far=200.0, spp=spp, dtype=dtype,
    )
    return scene, camera


def dense_mesh_scene(
    width: int = 128,
    height: int = 128,
    spp: int = 1,
    ni: int = 48,
    nj: int = 64,
    dtype=jnp.float32,
    scramble: int | None = None,
) -> tuple[Scene, Camera]:
    """Dense-mesh stress scene: a 6,016-triangle bumpy sphere (for the
    default ni/nj) over a floor plane with two lights.

    Exercises the reference's arbitrary-size Model loop
    (/root/reference/RaytracingEngine/Shape.h:269-300) far past the old
    512-primitive kernel ceiling; refbuild/parity_main.cpp renders the
    identical scene with the real C++ engine for the parity dump.

    `scramble` (a seed) randomly shuffles the triangle index list —
    identical geometry in worst-case authoring order, the shape of a
    real-world OBJ whose faces were emitted in hash/vertex-cache order.
    The renders match the unscrambled scene except at exact seam ties
    (first-wins order changes).
    """
    from raytracingengine.scenes.assets import bumpy_sphere_mesh

    b = SceneBuilder()
    mesh_mat = Material(
        color=(0.85, 0.35, 0.2), shininess=64.0, specular=0.25,
        transparency=0.0, refractive_index=1.0,
    )
    verts, idx = bumpy_sphere_mesh(radius=2.0, ni=ni, nj=nj, amp=0.15)
    if scramble is not None:
        rng = np.random.default_rng(scramble)
        tris = np.asarray(idx).reshape(-1, 3)
        idx = tris[rng.permutation(len(tris))].reshape(-1)
    # x-offset breaks the exact alignment of the camera's central
    # pixel column with the mesh symmetry plane (which otherwise
    # makes a whole column of exact closest-hit ties that fp32 and
    # fp64 break differently — verified vs the fp64 oracle).
    b.add_model(verts, idx, mesh_mat, translation=(0.137, 0.5, 8.0))
    b.add_plane((0.0, -2.5, 0.0), (0.0, 1.0, 0.0), Material(color=(0.9, 0.9, 0.9)))
    b.add_light((-4.0, 6.0, -2.0), (1, 1, 1), 120.0)
    b.add_light((4.0, 5.0, 2.0), (1, 1, 1), 90.0)
    scene = b.build(dtype=dtype)
    camera = Camera.create(
        (0, 0, -8), focal=float(width), width=width, height=height,
        near=0.0, far=100.0, spp=spp, dtype=dtype,
    )
    return scene, camera


def mixed_dense_scene(
    width: int = 128,
    height: int = 128,
    spp: int = 1,
    ni: int = 16,
    nj: int = 36,
    dtype=jnp.float32,
) -> tuple[Scene, Camera]:
    """Dense mesh PLUS spheres and a plane: every primitive family in one
    scene, with counts (2 spheres, 1 plane) that are not multiples of any
    block size, so padded blocks of one family sit beside the next
    family's primitives in scan order. The single-family
    dense_mesh_scene can never exercise that."""
    from raytracingengine.scenes.assets import bumpy_sphere_mesh

    b = SceneBuilder()
    b.add_sphere(
        (-3.2, -0.8, 6.0), 1.1,
        Material(color=(0.2, 0.7, 0.3), specular=0.3, shininess=64.0),
    )
    b.add_sphere((3.1, 1.2, 7.0), 0.9, Material(color=(0.2, 0.3, 0.8)))
    mesh_mat = Material(
        color=(0.85, 0.35, 0.2), shininess=64.0, specular=0.25,
        transparency=0.0, refractive_index=1.0,
    )
    verts, idx = bumpy_sphere_mesh(radius=2.0, ni=ni, nj=nj, amp=0.15)
    b.add_model(verts, idx, mesh_mat, translation=(0.137, 0.5, 8.0))
    b.add_plane(
        (0.0, -2.5, 0.0), (0.0, 1.0, 0.0), Material(color=(0.9, 0.9, 0.9))
    )
    b.add_light((-4.0, 6.0, -2.0), (1, 1, 1), 120.0)
    b.add_light((4.0, 5.0, 2.0), (1, 1, 1), 90.0)
    scene = b.build(dtype=dtype)
    camera = Camera.create(
        (0, 0, -8), focal=float(width), width=width, height=height,
        near=0.0, far=100.0, spp=spp, dtype=dtype,
    )
    return scene, camera
