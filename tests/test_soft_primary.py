"""Soft primary visibility (render/soft_primary.py).

Guarantees tested:
  * sigma -> 0 recovers the hard renderer (away from edges),
  * coverage is monotone in radius and AD gradients match FD on the
    soft renderer itself (the machinery is exact; whether a particular
    low-res single-view loss landscape is benign is a problem-conditioning
    question, not a correctness one — see test_inverse_geometry.py),
  * pseudo-hits shade with the correct sphere material.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytracingengine.geometry.intersect import flatten_scene
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.render.soft_primary import (
    integrate_chain_soft,
    soft_primary_layers,
)
from raytracingengine.scenes.builders import baseline_sphere_scene


def _cfg(sigma=0.1):
    return RenderConfig(
        chunk_size=28 * 28, shadow_mode="binary", soft_sigma=sigma,
        soft_primary=True,
    )


def test_sigma_zero_limit_matches_hard():
    scene, camera = baseline_sphere_scene(width=28, height=28, spp=1)
    soft = render_hdr(scene, camera, _cfg(sigma=1e-4))
    hard = render_hdr(
        scene, camera, RenderConfig(chunk_size=28 * 28, shadow_mode="binary")
    )
    diff = np.abs(np.asarray(soft) - np.asarray(hard))
    # identical except a measure-zero set of exact-edge pixels
    assert np.quantile(diff, 0.98) < 1e-4
    assert diff.mean() < 1e-3


def test_coverage_monotone_in_radius():
    scene, camera = baseline_sphere_scene(width=24, height=24, spp=1)
    cfg = _cfg(sigma=0.1)
    o, d = camera.rays_for_pixels(*camera.pixel_grid())

    def mean_cov(dr):
        sph = scene.spheres
        s = dataclasses.replace(
            scene, spheres=dataclasses.replace(sph, radii=sph.radii + dr)
        )
        _, _, cov = soft_primary_layers(flatten_scene(s), o, d, cfg)
        return float(jnp.mean(cov))

    c = [mean_cov(dr) for dr in (-0.2, 0.0, 0.2)]
    assert c[0] < c[1] < c[2]


def test_soft_ad_matches_fd_for_geometry():
    """On the *soft* renderer, reverse-mode gradients w.r.t. sphere
    center/radius equal finite differences of the same renderer."""
    scene, camera = baseline_sphere_scene(width=20, height=20, spp=1)
    cfg = _cfg(sigma=0.15)
    target = render_hdr(scene, camera, cfg) * 0.95

    def loss(dr, dx):
        sph = scene.spheres
        s = dataclasses.replace(
            scene,
            spheres=dataclasses.replace(
                sph,
                centers=sph.centers.at[0, 0].add(dx),
                radii=sph.radii.at[0].add(dr),
            ),
        )
        return jnp.mean((render_hdr(s, camera, cfg) - target) ** 2)

    g_r = float(jax.grad(loss, argnums=0)(jnp.float32(0.0), jnp.float32(0.0)))
    g_x = float(jax.grad(loss, argnums=1)(jnp.float32(0.0), jnp.float32(0.0)))
    h = 5e-3
    fd_r = float((loss(h, 0.0) - loss(-h, 0.0)) / (2 * h))
    fd_x = float((loss(0.0, h) - loss(0.0, -h)) / (2 * h))
    assert abs(g_r - fd_r) < 0.15 * (abs(fd_r) + 1e-4), (g_r, fd_r)
    assert abs(g_x - fd_x) < 0.15 * (abs(fd_x) + 1e-4), (g_x, fd_x)
    assert abs(fd_r) > 0  # silhouette gradient actually exists


def test_pseudo_hit_materials():
    scene, camera = baseline_sphere_scene(width=24, height=24, spp=1)
    cfg = _cfg(sigma=0.3)
    flat = flatten_scene(scene)
    o, d = camera.rays_for_pixels(*camera.pixel_grid())
    merged, _, cov = soft_primary_layers(flat, o, d, cfg)
    # All front-layer lanes have a "hit" (real or pseudo)
    assert bool(jnp.all(merged.valid))
    # Pseudo normals are unit
    n = np.linalg.norm(np.asarray(merged.normal), axis=1)
    np.testing.assert_allclose(n, 1.0, atol=1e-4)
    cov = np.asarray(cov)
    assert cov.min() >= 0.0 and cov.max() <= 1.0
