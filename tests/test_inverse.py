"""Inverse rendering (BASELINE config #4): recover perturbed scene
parameters by gradient descent on pixel L2 loss, plus checkpoint/resume."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from raytracingengine.inverse import combine, fit, partition
from raytracingengine.inverse.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scenes.builders import baseline_sphere_scene


def _perturb(scene, d_albedo=0.15, d_intensity=12.0):
    sph = scene.spheres
    mats = sph.materials
    mats2 = dataclasses.replace(
        mats, color=jnp.clip(mats.color + d_albedo, 0.0, 1.0)
    )
    sph2 = dataclasses.replace(sph, materials=mats2)
    lights2 = dataclasses.replace(
        scene.lights, intensities=scene.lights.intensities + d_intensity
    )
    return dataclasses.replace(scene, spheres=sph2, lights=lights2)


def test_recover_albedo_and_intensity():
    scene_true, camera = baseline_sphere_scene(width=24, height=24, spp=1)
    cfg = RenderConfig(chunk_size=192, shadow_mode="binary")
    target = render_hdr(scene_true, camera, cfg)

    scene0 = _perturb(scene_true)
    loss0 = float(jnp.mean((render_hdr(scene0, camera, cfg) - target) ** 2))
    # Optimize only the quantities that were perturbed (masked adam), the
    # standard move when geometry should stay pinned.
    from raytracingengine.inverse.params import select

    params0, _ = partition(scene0)
    m_albedo = select(params0, ["spheres.materials.color"])
    m_int = select(params0, ["lights.intensities"])
    labels = jax.tree.map(
        lambda a, b: "albedo" if a else ("intensity" if b else "freeze"),
        m_albedo,
        m_int,
        is_leaf=lambda x: x is None or isinstance(x, bool),
    )
    # Adam's step size is the lr: match it to each group's scale
    # (intensity ~80, albedo ~1).
    opt = optax.multi_transform(
        {
            "albedo": optax.adam(2e-2),
            "intensity": optax.adam(0.5),
            "freeze": optax.set_to_zero(),
        },
        labels,
    )
    fitted, losses = fit(scene0, camera, cfg, target, steps=120, optimizer=opt)
    assert losses[-1] < loss0 * 0.05, f"{loss0} -> {losses[-1]}"
    # The light intensity should move back toward truth.
    true_i = float(scene_true.lights.intensities[0])
    fit_i = float(fitted.lights.intensities[0])
    start_i = true_i + 12.0
    assert abs(fit_i - true_i) < abs(start_i - true_i) * 0.5


def test_partition_combine_roundtrip():
    scene, _ = baseline_sphere_scene(width=8, height=8, spp=1)
    params, static = partition(scene)
    back = combine(params, static)
    for a, b in zip(jax.tree.leaves(scene), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Params tree has only float leaves
    for leaf in jax.tree.leaves(params):
        assert np.issubdtype(np.asarray(leaf).dtype, np.floating)


def test_checkpoint_roundtrip(tmp_path):
    scene, _ = baseline_sphere_scene(width=8, height=8, spp=1)
    params, _ = partition(scene)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, opt_state, step=17)
    restored = restore_checkpoint(
        path, {"params": params, "opt_state": opt_state, "step": 0}
    )
    assert int(restored["step"]) == 17
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
