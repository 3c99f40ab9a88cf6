"""Shadow modes: march parity, binary==march on opaque scenes,
differentiable march, soft-visibility limits."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracingengine.geometry.intersect import flatten_scene
from raytracingengine.geometry.materials import Material
from raytracingengine.golden.reference import golden_from_scene
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.render.shading import (
    transmittance_binary,
    transmittance_hard,
    visibility_soft,
)
from raytracingengine.scene import SceneBuilder
from raytracingengine.scenes.builders import baseline_sphere_scene
from raytracingengine.core.camera import Camera


def _transparent_stack_scene():
    """Two transparent panes + one opaque pane along +z."""
    b = SceneBuilder()
    glass = Material(color=(1, 1, 1), transparency=0.5, refractive_index=1.0)
    half = Material(color=(1, 1, 1), transparency=0.25, refractive_index=1.0)
    b.add_plane((0, 0, 3), (0, 0, -1), glass)
    b.add_plane((0, 0, 6), (0, 0, -1), half)
    b.add_sphere((0, 0, 20), 1.0, Material(color=(1, 0, 0)))  # opaque, far
    b.add_light((0, 0, 30), (1, 1, 1), 10.0)
    return b.build()


def test_march_transmittance_matches_golden():
    scene = _transparent_stack_scene()
    cam = Camera.create((0, 0, 0), 32, 8, 8, 0, 100, spp=1)
    g = golden_from_scene(scene, cam)
    flat = flatten_scene(scene)
    cfg = RenderConfig()
    o = jnp.zeros((3, 3))
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (3, 1))
    max_dist = jnp.array([10.0, 4.0, 50.0])
    active = jnp.ones(3, bool)
    T = transmittance_hard(flat, o, d, max_dist, active, cfg)
    for i in range(3):
        tg = g.transmittance(
            np.zeros(3), np.array([0.0, 0.0, 1.0]), float(max_dist[i]), cfg.bias
        )
        np.testing.assert_allclose(float(T[i]), tg, rtol=1e-5, atol=1e-6)
    # through both panes: 0.5 * 0.25; through first only: 0.5;
    # through both + opaque sphere: 0
    np.testing.assert_allclose(np.asarray(T), [0.125, 0.5, 0.0], atol=1e-6)


def test_differentiable_march_equals_while_march():
    scene = _transparent_stack_scene()
    flat = flatten_scene(scene)
    o = jnp.zeros((4, 3))
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (4, 1))
    max_dist = jnp.array([2.0, 4.0, 10.0, 50.0])
    active = jnp.ones(4, bool)
    t_while = transmittance_hard(flat, o, d, max_dist, active, RenderConfig())
    t_scan = transmittance_hard(
        flat, o, d, max_dist, active, RenderConfig(differentiable=True)
    )
    np.testing.assert_allclose(np.asarray(t_while), np.asarray(t_scan), atol=1e-7)


def test_march_transparency_gradient():
    """d/d(transparency) through the differentiable march is the other
    pane's transparency (T = tr1 * tr2)."""
    scene = _transparent_stack_scene()
    cfg = RenderConfig(differentiable=True)

    def t_of_scene(s):
        flat = flatten_scene(s)
        return transmittance_hard(
            flat,
            jnp.zeros((1, 3)),
            jnp.array([[0.0, 0.0, 1.0]]),
            jnp.array([10.0]),
            jnp.ones(1, bool),
            cfg,
        )[0]

    g = jax.grad(
        lambda tr: t_of_scene(
            scene.replace_plane_transparency(tr)
            if hasattr(scene, "replace_plane_transparency")
            else _with_plane_transparency(scene, tr)
        )
    )(jnp.asarray(0.5, jnp.float32))
    np.testing.assert_allclose(float(g), 0.25, rtol=1e-5)


def _with_plane_transparency(scene, tr0):
    import dataclasses

    mats = scene.planes.materials
    new_tr = mats.transparency.at[0].set(tr0)
    new_mats = dataclasses.replace(mats, transparency=new_tr)
    new_planes = dataclasses.replace(scene.planes, materials=new_mats)
    return dataclasses.replace(scene, planes=new_planes)


def test_binary_equals_march_on_opaque_scene():
    scene, camera = baseline_sphere_scene(width=24, height=24, spp=1)
    a = render_hdr(scene, camera, RenderConfig(chunk_size=192))
    b = render_hdr(scene, camera, RenderConfig(chunk_size=192, shadow_mode="binary"))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_soft_visibility_hard_limit():
    """sigma -> 0 recovers hard sphere shadows."""
    b = SceneBuilder()
    b.add_sphere((0, 0, 5), 1.0, Material(color=(1, 0, 0)))
    scene = b.build()
    flat = flatten_scene(scene)
    o = jnp.zeros((2, 3))
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])  # blocked / clear
    md = jnp.array([10.0, 10.0])
    v = visibility_soft(flat, o, d, md, RenderConfig(soft_sigma=1e-4))
    np.testing.assert_allclose(np.asarray(v), [0.0, 1.0], atol=1e-3)


def test_soft_visibility_gradient_moves_sphere():
    """Moving the sphere across the shadow ray changes V smoothly."""
    b = SceneBuilder()
    b.add_sphere((0.9, 0, 5), 1.0, Material(color=(1, 0, 0)))
    scene = b.build()
    cfg = RenderConfig(soft_sigma=0.1)

    def v_of_x(x):
        import dataclasses

        sph = scene.spheres
        centers = sph.centers.at[0, 0].set(x)
        s2 = dataclasses.replace(scene, spheres=dataclasses.replace(sph, centers=centers))
        flat = flatten_scene(s2)
        return visibility_soft(
            flat, jnp.zeros((1, 3)), jnp.array([[0.0, 0.0, 1.0]]),
            jnp.array([10.0]), cfg,
        )[0]

    g = jax.grad(v_of_x)(jnp.asarray(0.9, jnp.float32))
    assert float(g) > 0.1  # moving sphere +x increases clearance -> more light
