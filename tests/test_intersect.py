"""Intersection math vs the fp64 golden oracle, including epsilon edges."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracingengine.geometry.intersect import (
    all_distances,
    any_hit_before,
    closest_hit,
    flatten_scene,
    FAMILY_PLANE,
    FAMILY_SPHERE,
    FAMILY_TRIANGLE,
)
from raytracingengine.geometry.materials import Material
from raytracingengine.golden.reference import golden_from_scene
from raytracingengine.scene import SceneBuilder
from raytracingengine.core.camera import Camera


def _mixed_scene(pad=None):
    b = SceneBuilder()
    b.add_sphere((0, 0, 5), 1.0, Material(color=(1, 0, 0)))
    b.add_sphere((2.5, 0, 7), 1.2, Material(color=(0, 1, 0)))
    b.add_plane((0, -2, 0), (0, 1, 0), Material(color=(1, 1, 1)))
    b.add_triangle((-2, -1, 4), (-1, -1, 4), (-1.5, 1, 4), Material(color=(0, 0, 1)))
    b.add_light((0, 5, 0), (1, 1, 1), 50.0)
    return b.build(dtype=jnp.float32, pad_multiple=pad)


def _random_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3))
    o[:, 2] = rng.uniform(-10, 0, n)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_closest_hit_matches_golden():
    scene = _mixed_scene()
    cam = Camera.create((0, 0, -10), 64, 8, 8, 0, 100, spp=1)
    golden = golden_from_scene(scene, cam)
    flat = flatten_scene(scene)
    o, d = _random_rays(256)
    hit = jax.jit(lambda oo, dd: closest_hit(flat, oo, dd))(o, d)

    for i in range(o.shape[0]):
        gh = golden.intersect_closest(o[i].astype(np.float64), d[i].astype(np.float64))
        if gh is None:
            assert not bool(hit.valid[i]), f"ray {i}: golden miss but JAX hit"
        else:
            assert bool(hit.valid[i]), f"ray {i}: golden hit but JAX miss"
            np.testing.assert_allclose(hit.t[i], gh.t, rtol=2e-4, atol=1e-4)
            np.testing.assert_allclose(hit.normal[i], gh.normal, rtol=1e-3, atol=2e-3)
            np.testing.assert_allclose(hit.albedo[i], gh.albedo, atol=1e-6)


def test_padding_changes_nothing():
    scene = _mixed_scene()
    scene_pad = _mixed_scene(pad=8)
    o, d = _random_rays(128, seed=3)
    h1 = closest_hit(flatten_scene(scene), o, d)
    h2 = closest_hit(flatten_scene(scene_pad), o, d)
    np.testing.assert_array_equal(np.asarray(h1.valid), np.asarray(h2.valid))
    np.testing.assert_allclose(
        np.where(h1.valid, h1.t, 0), np.where(h2.valid, h2.t, 0), rtol=1e-6
    )


def test_family_codes_and_tie_break():
    # A sphere and a triangle both exactly 5 units away along +z; family
    # order must pick the sphere (Scene.h:218-257 scan order, strict <).
    b = SceneBuilder()
    b.add_sphere((0, 0, 6), 1.0, Material(color=(1, 0, 0)))  # front at z=5
    b.add_triangle((-1, -1, 5), (1, -1, 5), (0, 2, 5), Material(color=(0, 1, 0)))
    scene = b.build()
    flat = flatten_scene(scene)
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    hit = closest_hit(flat, o, d)
    assert bool(hit.valid[0])
    assert int(hit.family[0]) == FAMILY_SPHERE
    np.testing.assert_allclose(hit.albedo[0], [1, 0, 0], atol=1e-7)


def test_sphere_inside_prefers_far_root():
    # Ray origin inside the sphere: t0 < 0 -> t1 (Shape.h:91-96)
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 2.0, Material(color=(1, 0, 0)))
    scene = b.build()
    flat = flatten_scene(scene)
    hit = closest_hit(flat, jnp.array([[0.0, 0.0, 0.0]]), jnp.array([[0.0, 0.0, 1.0]]))
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, rtol=1e-6)
    # Outward normal at the hit point (not flipped at hit level)
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-6)


def test_plane_parallel_ray_misses():
    b = SceneBuilder()
    b.add_plane((0, -1, 0), (0, 1, 0), Material())
    scene = b.build()
    flat = flatten_scene(scene)
    hit = closest_hit(flat, jnp.array([[0.0, 0.0, 0.0]]), jnp.array([[1.0, 0.0, 0.0]]))
    assert not bool(hit.valid[0])


def test_triangle_barycentric_edges():
    b = SceneBuilder()
    b.add_triangle((0, 0, 5), (1, 0, 5), (0, 1, 5), Material(color=(0, 0, 1)))
    scene = b.build()
    flat = flatten_scene(scene)
    origins = jnp.zeros((3, 3))
    dirs = jnp.stack(
        [
            jnp.array([0.1, 0.1, 5.0]),  # inside
            jnp.array([0.9, 0.9, 5.0]),  # outside (u+v>1)
            jnp.array([-0.1, 0.5, 5.0]),  # outside (u<0)
        ]
    )
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    hit = closest_hit(flat, origins, dirs)
    assert [bool(v) for v in hit.valid] == [True, False, False]


def test_any_hit_before():
    scene = _mixed_scene()
    flat = flatten_scene(scene)
    o = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    occ = any_hit_before(flat, o, d, jnp.array([100.0, 100.0]))
    assert bool(occ[0]) and not bool(occ[1])
    # Max-dist excludes the hit at ~4 (sphere front face at z=4)
    occ2 = any_hit_before(flat, o, d, jnp.array([3.0, 3.0]))
    assert not bool(occ2[0])


def test_all_distances_order():
    scene = _mixed_scene()
    flat = flatten_scene(scene)
    o, d = _random_rays(16, seed=5)
    t = all_distances(flat, o, d)
    assert t.shape == (flat.n_primitives, 16)
    assert flat.n_spheres == 2 and flat.n_planes == 1 and flat.n_triangles == 1
