"""End-to-end radiance parity: JAX-path fp32 vs golden fp64 oracle.

Compares `render_rays`/`render_hdr` (wavefront + chain integrators)
against the naive-recursion fp64 GoldenScene on deterministic center rays
(spp=1 — the reference's sample 0 is unjittered, Scene.h:289-296, so no
RNG is involved and results are directly comparable)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingengine.golden.reference import golden_from_scene
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr, render_rays, resolve_mode
from raytracingengine.scenes.builders import (
    baseline_sphere_scene,
    glass_sphere_scene,
    head_box_scene,
)

# fp32 vs fp64 over a 10-deep recursion with shadow marches: allow ~1e-3.
RTOL = 2e-3
ATOL = 3e-3


def _golden_image(scene, camera, cfg):
    g = golden_from_scene(scene, camera, max_depth=cfg.max_depth, bias=cfg.bias)
    return g.render()


def test_sphere_scene_matches_golden():
    scene, camera = baseline_sphere_scene(width=32, height=32, spp=1)
    cfg = RenderConfig(chunk_size=256)
    img = np.asarray(render_hdr(scene, camera, cfg), np.float64)
    gold = _golden_image(scene, camera, cfg)
    np.testing.assert_allclose(img, gold, rtol=RTOL, atol=ATOL)


def test_head_box_scene_matches_golden():
    scene, camera = head_box_scene(width=24, height=24, spp=1)
    cfg = RenderConfig(chunk_size=192)
    assert resolve_mode(scene, cfg) == "chain"
    img = np.asarray(render_hdr(scene, camera, cfg), np.float64)
    gold = _golden_image(scene, camera, cfg)
    np.testing.assert_allclose(img, gold, rtol=RTOL, atol=ATOL)


def test_glass_scene_wavefront_matches_golden():
    scene, camera = glass_sphere_scene(width=24, height=24, spp=1)
    cfg = RenderConfig(max_depth=6, chunk_size=192)
    assert resolve_mode(scene, cfg) == "wavefront"
    img = np.asarray(render_hdr(scene, camera, cfg), np.float64)
    gold = _golden_image(scene, camera, cfg)
    # Refraction chains amplify fp32 error; keep a slightly looser budget
    # but require the overwhelming majority of pixels to be tight.
    err = np.abs(img - gold)
    assert np.quantile(err, 0.99) < 5e-3, f"p99 err {np.quantile(err, 0.99)}"
    assert err.max() < 5e-2, f"max err {err.max()}"


def test_wavefront_equals_chain_on_opaque():
    scene, camera = baseline_sphere_scene(width=16, height=16, spp=1)
    cfg = RenderConfig(chunk_size=256)
    a = render_hdr(scene, camera, cfg, mode="chain")
    b = render_hdr(scene, camera, cfg, mode="wavefront")
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_sky_only_scene():
    from raytracingengine.scene import SceneBuilder
    from raytracingengine.core.camera import Camera
    from raytracingengine.render.shading import sky_color

    scene = SceneBuilder().build()
    camera = Camera.create((0, 0, 0), focal=16, width=8, height=8, spp=1)
    cfg = RenderConfig(chunk_size=64)
    img = render_hdr(scene, camera, cfg)
    px, py = camera.pixel_grid()
    _, d = camera.rays_for_pixels(px, py)
    expect = sky_color(d).reshape(8, 8, 3)
    np.testing.assert_allclose(np.asarray(img), np.asarray(expect), rtol=1e-6)


def test_spp_mean_is_deterministic_and_converges():
    scene, camera = baseline_sphere_scene(width=8, height=8, spp=4)
    cfg = RenderConfig(chunk_size=64)
    key = jax.random.PRNGKey(42)
    a = render_hdr(scene, camera, cfg, key=key)
    b = render_hdr(scene, camera, cfg, key=key)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Jittered mean should stay close to the center-ray render.
    scene1, camera1 = baseline_sphere_scene(width=8, height=8, spp=1)
    c = render_hdr(scene1, camera1, cfg)
    assert np.abs(np.asarray(a) - np.asarray(c)).mean() < 0.2


def test_render_rays_arbitrary_block():
    scene, camera = baseline_sphere_scene(width=8, height=8, spp=1)
    cfg = RenderConfig()
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-2, 2, (64, 3)), jnp.float32)
    d = rng.normal(size=(64, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    out = render_rays(scene, o, d, cfg)
    g = golden_from_scene(scene, camera, cfg.max_depth, cfg.bias)
    gold = g.render_rays(np.asarray(o, np.float64), np.asarray(d, np.float64))
    np.testing.assert_allclose(np.asarray(out, np.float64), gold, rtol=5e-3, atol=5e-3)
