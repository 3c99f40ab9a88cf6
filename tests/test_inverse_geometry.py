"""Geometry/lighting recovery by gradient descent (BASELINE config #4).

Light position has smooth, well-posed pixel gradients (validated against
finite differences in test_grad_fd.py) and recovers cleanly.

Sphere center/radius recovery needs the soft-silhouette primary bounce
(render/soft_primary.py): hard closest-hit is piecewise-constant in
geometry across silhouette edges, so the silhouette-mismatch term of the
loss has zero gradient. With two-layer soft compositing (silhouette
sphere over the TRUE background hit) plus sigma annealing
(0.05 -> 0.015 -> 0.005, each stage re-sharpening the edge model toward
the hard target), descent recovers a 0.5-unit center offset and a 20%
radius error — `test_recover_sphere_center_and_radius` below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from raytracingengine.inverse import (
    combine,
    fit,
    make_train_step,
    masked_optimizer,
    partition,
)
from raytracingengine.inverse.params import select
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scenes.builders import baseline_sphere_scene


def test_recover_light_position():
    scene_true, camera = baseline_sphere_scene(width=24, height=24, spp=1)
    cfg = RenderConfig(chunk_size=24 * 24, shadow_mode="binary")
    target = render_hdr(scene_true, camera, cfg)

    lights = scene_true.lights
    scene0 = dataclasses.replace(
        scene_true,
        lights=dataclasses.replace(
            lights, positions=lights.positions.at[0].add(
                jnp.asarray([1.5, -1.0, 0.5], lights.positions.dtype)
            )
        ),
    )
    loss0 = float(jnp.mean((render_hdr(scene0, camera, cfg) - target) ** 2))

    params0, _ = partition(scene0)
    mask = select(params0, ["lights.positions"])
    opt = masked_optimizer(optax.adam(0.1), mask)
    fitted, losses = fit(scene0, camera, cfg, target, steps=150, optimizer=opt)

    assert losses[-1] < loss0 * 0.05, f"{loss0} -> {losses[-1]}"
    err = np.linalg.norm(
        np.asarray(fitted.lights.positions[0] - scene_true.lights.positions[0])
    )
    start_err = np.linalg.norm([1.5, -1.0, 0.5])
    assert err < start_err * 0.35, f"light pos err {err} (start {start_err})"


def test_recover_sphere_center_and_radius():
    """BASELINE config #4 headline: recover a perturbed sphere's center
    (offset 0.5 world units) and radius (+20%) by annealed soft-silhouette
    descent against a HARD-rendered target image.

    Acceptance (VERDICT r01 #5): recovered center error < 10% of the
    perturbation, final hard-render L2 < 5% of the initial mismatch.
    """
    W = H = 48
    scene_true, camera = baseline_sphere_scene(width=W, height=H, spp=1)
    hard_cfg = RenderConfig(chunk_size=W * H, shadow_mode="binary")
    target = render_hdr(scene_true, camera, hard_cfg)

    sph = scene_true.spheres
    center_delta = jnp.asarray([0.4, -0.3, 0.0], sph.centers.dtype)
    scene0 = dataclasses.replace(
        scene_true,
        spheres=dataclasses.replace(
            sph,
            centers=sph.centers.at[0].add(center_delta),
            radii=sph.radii.at[0].multiply(1.2),
        ),
    )
    loss0 = float(jnp.mean((render_hdr(scene0, camera, hard_cfg) - target) ** 2))

    params, static = partition(scene0)
    mask = select(params, ["spheres.centers", "spheres.radii"])
    key = jax.random.PRNGKey(0)
    for sigma, lr, steps in [(0.05, 0.02, 200), (0.015, 0.008, 200), (0.005, 0.003, 200)]:
        cfg = RenderConfig(
            chunk_size=W * H, shadow_mode="binary", soft_primary=True,
            soft_sigma=sigma,
        )
        opt = masked_optimizer(optax.adam(lr), mask)
        opt_state = opt.init(params)
        step_fn = make_train_step(camera, cfg, opt)
        for _ in range(steps):
            key, sub = jax.random.split(key)
            params, opt_state, _, _ = step_fn(params, static, opt_state, target, sub)

    fitted = combine(params, static)
    c_err = float(
        jnp.linalg.norm(fitted.spheres.centers[0] - scene_true.spheres.centers[0])
    )
    r_err = float(abs(fitted.spheres.radii[0] - scene_true.spheres.radii[0]))
    loss_f = float(jnp.mean((render_hdr(fitted, camera, hard_cfg) - target) ** 2))

    start_c = float(jnp.linalg.norm(center_delta))  # 0.5
    assert c_err < 0.10 * start_c, f"center err {c_err} (start {start_c})"
    assert r_err < 0.20 * 0.4, f"radius err {r_err} (start 0.4)"
    assert loss_f < 0.05 * loss0, f"hard L2 {loss_f} vs initial {loss0}"


def test_radius_gradient_is_finite_and_nonzero():
    """The machinery check: interior radius gradients exist and are finite
    (their sufficiency for silhouette recovery is a separate problem)."""
    import jax

    scene, camera = baseline_sphere_scene(width=16, height=16, spp=1)
    cfg = RenderConfig(chunk_size=256, shadow_mode="binary")
    target = render_hdr(scene, camera, cfg) * 0.9

    def loss_of_r(dr):
        sph = scene.spheres
        s = dataclasses.replace(
            scene, spheres=dataclasses.replace(sph, radii=sph.radii.at[0].add(dr))
        )
        return jnp.mean((render_hdr(s, camera, cfg) - target) ** 2)

    g = jax.grad(loss_of_r)(jnp.float32(0.0))
    assert np.isfinite(float(g)) and abs(float(g)) > 0


def test_recover_plane_orientation():
    """BASELINE config #4's remaining parameter family: recover a
    perturbed floor-plane orientation (normal tilted ~0.32 rad) and
    height (+0.3) by descent on the pixel L2 loss. Plane parameters have
    smooth INTERIOR shading gradients (ndotl, hit distance, shadow
    geometry all move continuously with the plane), so no soft-silhouette
    machinery is needed — plain hard-render gradients suffice.
    """
    W = H = 32
    scene_true, camera = baseline_sphere_scene(width=W, height=H, spp=1)
    cfg = RenderConfig(chunk_size=W * H, shadow_mode="binary")
    target = render_hdr(scene_true, camera, cfg)

    pl = scene_true.planes
    tilt = jnp.zeros_like(pl.normals).at[0].set(
        jnp.asarray([0.25, 0.0, -0.2], pl.normals.dtype)
    )
    scene0 = dataclasses.replace(
        scene_true,
        planes=dataclasses.replace(
            pl,
            normals=pl.normals + tilt,  # (0,1,0) -> (0.25, 1, -0.2), unnormalized
            points=pl.points.at[0, 1].add(0.3),
        ),
    )
    loss0 = float(jnp.mean((render_hdr(scene0, camera, cfg) - target) ** 2))

    params, static = partition(scene0)
    mask = select(params, ["planes.points", "planes.normals"])
    opt = masked_optimizer(optax.adam(0.02), mask)
    fitted, losses = fit(
        scene0, camera, cfg, target, steps=250, optimizer=opt
    )

    def angle(a, b):
        a = a / np.linalg.norm(a)
        b = b / np.linalg.norm(b)
        return float(np.arccos(np.clip(np.dot(a, b), -1.0, 1.0)))

    n_true = np.asarray(scene_true.planes.normals[0])
    ang0 = angle(np.asarray(scene0.planes.normals[0]), n_true)
    ang_f = angle(np.asarray(fitted.planes.normals[0]), n_true)
    # Height error measured as the plane offset along the true normal.
    h_err = abs(
        float(
            np.dot(np.asarray(fitted.planes.points[0]), n_true)
            - np.dot(np.asarray(scene_true.planes.points[0]), n_true)
        )
    )
    assert losses[-1] < 0.10 * loss0, f"L2 {losses[-1]} vs initial {loss0}"
    assert ang_f < 0.35 * ang0, f"normal angle {ang_f} rad (start {ang0})"
    assert h_err < 0.3 * 0.5, f"plane height err {h_err}"
