"""Mesh-sharded rendering on the 8-device virtual CPU mesh.

Checks that ray-sharded and (rays x prims)-sharded renders match the
single-device pipeline exactly, and that gradients w.r.t. the replicated
scene parameters are correctly psum-reduced by shard_map's transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np

from raytracingengine.parallel.mesh import make_mesh
from raytracingengine.parallel.sharded import render_hdr_auto, render_hdr_sharded
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scenes.builders import baseline_sphere_scene, head_box_scene


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_ray_sharded_matches_single_device():
    scene, camera = baseline_sphere_scene(width=32, height=24, spp=1)
    cfg = RenderConfig(chunk_size=128)
    mesh = make_mesh()  # 8-way rays
    img_s = render_hdr_sharded(scene, camera, cfg, mesh)
    img_1 = render_hdr(scene, camera, cfg)
    np.testing.assert_allclose(
        np.asarray(img_s), np.asarray(img_1), rtol=1e-5, atol=1e-6
    )


def test_rays_by_prims_mesh_matches():
    scene, camera = head_box_scene(width=16, height=16, spp=1, pad_multiple=4)
    cfg = RenderConfig(chunk_size=64)
    mesh = make_mesh(n_ray_shards=4, n_prim_shards=2)
    assert mesh.shape == {"rays": 4, "prims": 2}
    img_s = render_hdr_sharded(scene, camera, cfg, mesh)
    img_1 = render_hdr(scene, camera, cfg)
    np.testing.assert_allclose(
        np.asarray(img_s), np.asarray(img_1), rtol=1e-4, atol=1e-5
    )


def test_sharded_grads_psum_to_single_device_grads():
    scene, camera = baseline_sphere_scene(width=16, height=16, spp=1)
    # binary shadows: differentiable (no while_loop), identical values on
    # this all-opaque scene.
    cfg = RenderConfig(chunk_size=64, shadow_mode="binary")
    mesh = make_mesh()

    def loss_sharded(s):
        img = render_hdr_auto(s, camera, cfg, mesh)
        return jnp.sum(img**2)

    def loss_single(s):
        img = render_hdr(s, camera, cfg)
        return jnp.sum(img**2)

    g_s = jax.grad(loss_sharded, allow_int=True)(scene)
    g_1 = jax.grad(loss_single, allow_int=True)(scene)
    for a, b in zip(jax.tree.leaves(g_s), jax.tree.leaves(g_1)):
        if not np.issubdtype(np.asarray(a).dtype, np.floating):
            continue  # float0 tangents for bool/int leaves
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-5
        )
    # And the gradients are not all zero (light intensity certainly moves).
    total = sum(
        float(np.abs(np.asarray(x)).sum())
        for x in jax.tree.leaves(g_s)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
    )
    assert total > 0


def test_auto_sharded_forward_matches():
    scene, camera = baseline_sphere_scene(width=24, height=16, spp=1)
    cfg = RenderConfig(chunk_size=128)
    mesh = make_mesh()
    a = jax.jit(
        lambda s: render_hdr_auto(s, camera, cfg, mesh)
    )(scene)
    b = render_hdr(scene, camera, cfg)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_jitted_sharded_render():
    scene, camera = baseline_sphere_scene(width=16, height=16, spp=2)
    cfg = RenderConfig(chunk_size=64)
    mesh = make_mesh()
    f = jax.jit(
        lambda s, k: render_hdr_sharded(s, camera, cfg, mesh, key=k)
    )
    key = jax.random.PRNGKey(1)
    a = f(scene, key)
    b = render_hdr_sharded(scene, camera, cfg, mesh, key=key)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
