"""Triton closest-hit / any-hit kernel (geometry/hit_kernel.py).

On the CPU the kernel body runs through the Pallas interpreter
(`interpret_mode()`); the compiled kernel is checked on the card by the
`gpu` test below and by chip_smoke.py. Reference: the XLA all-pairs
intersection (geometry/intersect.py) with its first-wins argmin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingengine.core.camera import Camera
from raytracingengine.geometry import hit_kernel as hk
from raytracingengine.geometry.intersect import (
    any_hit_before,
    closest_hit,
    closest_index,
    flatten_scene,
)
from raytracingengine.geometry.materials import Material
from raytracingengine.inverse import combine, partition
from raytracingengine.parallel.mesh import make_mesh
from raytracingengine.parallel.sharded import (
    make_sharded_loss,
    render_hdr_sharded,
)
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scene import SceneBuilder
from raytracingengine.scenes.builders import (
    baseline_sphere_scene,
    dense_mesh_scene,
    glass_sphere_scene,
    head_box_scene,
    mixed_dense_scene,
    stress_scene,
)


@pytest.fixture
def interp():
    with hk.interpret_mode():
        yield


def _looking_away():
    """Mesh behind the camera and the floor plane switched off."""
    scene, _ = dense_mesh_scene(8, 8, ni=8, nj=12)
    planes = dataclasses.replace(
        scene.planes, active=jnp.zeros_like(scene.planes.active))
    scene = dataclasses.replace(scene, planes=planes)
    cam = Camera.create((0, 0, 200), focal=8.0, width=8, height=8,
                        near=0.0, far=100.0, spp=1)
    return scene, cam


SCENES = {
    "box": lambda: head_box_scene(width=16, height=12, spp=1),
    "spheres": lambda: baseline_sphere_scene(16, 12, n_lights=3),
    "stress_slice": lambda: stress_scene(
        n_spheres=16, n_lights=2, width=16, height=16, pad_multiple=8),
    "glass": lambda: glass_sphere_scene(16, 12),
    "dense_mesh": lambda: dense_mesh_scene(16, 16, ni=8, nj=12),
    "scrambled_mesh": lambda: dense_mesh_scene(16, 16, ni=8, nj=12, scramble=3),
    "mixed_overlap": lambda: mixed_dense_scene(16, 16, ni=6, nj=10),
    "inactive_padding": lambda: head_box_scene(16, 12, spp=1, pad_multiple=64),
    "ragged_counts": lambda: head_box_scene(width=13, height=7, spp=1),
    "all_miss": _looking_away,
}


def _rays(scene, cam):
    flat = flatten_scene(scene)
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    return flat, o, d


def _xla_winner(flat, o, d):
    return tuple(np.asarray(a) for a in closest_index(flat, o, d))


def _assert_same_winner(jk, tk, jx, tx):
    """Identical winners, except where two primitives tie in t to fp32
    rounding (the kernel and XLA sum the same products in another order):
    there the winner may differ but t may not."""
    fin = np.isfinite(tx)
    assert (np.isfinite(tk) == fin).all()
    np.testing.assert_allclose(tk[fin], tx[fin], rtol=1e-5)
    diff = jk != jx
    assert diff.sum() <= max(1, 0.01 * jk.size), int(diff.sum())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_winner_matches_xla(name, interp):
    flat, o, d = _rays(*SCENES[name]())
    jk, tk = (np.asarray(a) for a in hk.closest_winner(flat, o, d))
    jx, tx = _xla_winner(flat, o, d)
    _assert_same_winner(jk, tk, jx, tx)
    if name == "all_miss":
        assert (jk == -1).all() and np.isinf(tk).all()
    if name == "ragged_counts":
        assert o.shape[0] % hk.BLOCK_RAYS and flat.n_primitives % hk.BLOCK_PRIMS


@pytest.mark.parametrize("name", sorted(SCENES))
def test_any_hit_matches_xla(name, interp):
    flat, o, d = _rays(*SCENES[name]())
    r = o.shape[0]
    # A per-ray segment end that cuts through the scene.
    max_dist = jnp.linspace(0.5, 30.0, r).astype(o.dtype)
    for lo in (0.0, 1e-3):
        k = hk.any_hit(flat, o, d, max_dist, lo=lo)
        x = any_hit_before(flat, o, d, max_dist, lo=lo)
        np.testing.assert_array_equal(np.asarray(k), np.asarray(x))


@pytest.mark.parametrize("tiling", [
    hk.Tiling(block_prims=1, block_rays=32, num_warps=1, programs=64),
    hk.Tiling(block_prims=4, block_rays=64, num_warps=2, num_stages=2, programs=1),
    hk.Tiling(block_prims=32, block_rays=256, programs=4096),
], ids=["split8", "unsplit", "wide"])
def test_tilings_agree(tiling, interp):
    """Block shapes and primitive splits change the work split only."""
    flat, o, d = _rays(*SCENES["mixed_overlap"]())
    jk, tk = (np.asarray(a) for a in hk.closest_winner(flat, o, d, tiling))
    _assert_same_winner(jk, tk, *_xla_winner(flat, o, d))
    md = jnp.full((o.shape[0],), 9.0, o.dtype)
    k = hk.any_hit(flat, o, d, md, tiling=tiling)
    np.testing.assert_array_equal(np.asarray(k),
                                  np.asarray(any_hit_before(flat, o, d, md)))


def _tie_scene(kind):
    """Two primitives at exactly equal t for every ray that hits them; the
    earlier one (authoring / family order) must win, as in the
    reference's strict-< scan (Scene.h:218-257)."""
    b = SceneBuilder()
    red, green = Material(color=(1, 0, 0)), Material(color=(0, 1, 0))
    quad = np.array([[-3, -3, 5], [3, -3, 5], [3, 3, 5], [-3, 3, 5]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.int32)
    if kind == "triangles":
        b.add_model(quad, idx, red)
        b.add_model(quad, idx, green)
    elif kind == "spheres":
        b.add_sphere((0, 0, 5), 2.0, red)
        b.add_sphere((0, 0, 5), 2.0, green)
    else:
        b.add_plane((0, 0, 5), (0, 0, -1), red)
        b.add_plane((0, 0, 5), (0, 0, -1), green)
    b.add_light((0, 0, -5), (1, 1, 1), 10.0)
    scene = b.build()
    # Off-centre, so that no ray runs along the quad's diagonal edge.
    cam = Camera.create((0.0371, 0.0213, -5), focal=8.0, width=8, height=8,
                        near=0.0, far=100.0, spp=1)
    return scene, cam


@pytest.mark.parametrize("kind", ["triangles", "spheres", "planes"])
def test_equal_t_ties_resolve_to_first_primitive(kind, interp):
    flat, o, d = _rays(*_tie_scene(kind))
    jk, _ = hk.closest_winner(flat, o, d)
    jx, _ = _xla_winner(flat, o, d)
    np.testing.assert_array_equal(np.asarray(jk), jx)
    hit = closest_hit(flat, o, d, use_kernel=True)
    red = np.asarray(hit.albedo)[np.asarray(hit.valid)]
    assert red.size and (red == [1, 0, 0]).all()


def test_inactive_and_padded_primitives_never_hit(interp):
    scene, cam = head_box_scene(16, 12, spp=1)
    flat = flatten_scene(scene)
    off = dataclasses.replace(
        flat,
        tri_active=jnp.zeros_like(flat.tri_active),
        pl_active=jnp.zeros_like(flat.pl_active),
    )
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    j, t = hk.closest_winner(off, o, d)
    assert (np.asarray(j) == -1).all() and np.isinf(np.asarray(t)).all()
    sph, pln, tri = hk.pack_tables(flat)
    assert sph.shape == (4, hk.BLOCK_PRIMS)  # no spheres: one unscanned block
    bp = hk.BLOCK_PRIMS
    assert pln.shape == (4, -(-flat.n_planes // bp) * bp)
    assert tri.shape == (16, -(-flat.n_triangles // bp) * bp)
    assert float(sph[3, 0]) == 1.0  # centre 0, r^2 = -1


def test_pack_rays_pads_to_block_multiple():
    o = jnp.ones((200, 3))
    d = jnp.ones((200, 3))
    rays = hk.pack_rays(o, d, jnp.full((200,), 4.0), block_rays=128)
    assert rays.shape == (8, 256)
    np.testing.assert_array_equal(np.asarray(rays[6, :200]), 4.0)
    np.testing.assert_array_equal(np.asarray(rays[5, 200:]), 1.0)


_RENDER_CASES = [(depth, shadow) for depth in (0, 1, 3, 10)
                 for shadow in ("binary", "march")]


@pytest.mark.parametrize("depth,shadow", _RENDER_CASES)
def test_render_use_pallas_matches_xla(depth, shadow, interp):
    scene, cam = head_box_scene(width=12, height=10, spp=1)
    cfg = RenderConfig(max_depth=depth, shadow_mode=shadow, chunk_size=64)
    a = render_hdr(scene, cam, cfg)
    b = render_hdr(scene, cam, dataclasses.replace(cfg, use_pallas=True))
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["glass_wavefront", "jittered_spp3", "mixed_overlap"])
def test_render_use_pallas_other_paths(name, interp):
    if name == "glass_wavefront":
        scene, cam = glass_sphere_scene(12, 10)
        cfg = RenderConfig(max_depth=5)
    elif name == "jittered_spp3":
        scene, cam = head_box_scene(width=10, height=8, spp=3)
        cfg = RenderConfig(max_depth=3, shadow_mode="binary", chunk_size=32)
    else:
        scene, cam = mixed_dense_scene(10, 8, ni=6, nj=10)
        cfg = RenderConfig(max_depth=3)
    key = jax.random.PRNGKey(3)
    a = render_hdr(scene, cam, cfg, key=key)
    b = render_hdr(scene, cam, dataclasses.replace(cfg, use_pallas=True), key=key)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-5)


_GRAD_CASES = {
    "spheres": lambda: baseline_sphere_scene(8, 8, n_lights=2),
    "planes": lambda: head_box_scene(width=8, height=8, spp=1),
    "triangles": lambda: mixed_dense_scene(8, 8, ni=6, nj=10),
    "lights": lambda: baseline_sphere_scene(8, 8, n_lights=2),
}


@pytest.mark.parametrize("group", sorted(_GRAD_CASES))
def test_scene_grads_through_winner_recompute(group, interp):
    """The kernel path's gradient rule (value from the kernel, derivative
    from the plain-JAX recompute of the winner) against XLA autodiff of
    the all-pairs path."""
    scene, cam = _GRAD_CASES[group]()
    params, static = partition(scene)
    cfg = RenderConfig(shadow_mode="binary", max_depth=2, chunk_size=64)

    def loss(p, use):
        img = render_hdr(combine(p, static), cam,
                         dataclasses.replace(cfg, use_pallas=use))
        return jnp.mean(img**2)

    gk = jax.grad(loss)(params, True)
    gx = jax.grad(loss)(params, False)
    sub_k, sub_x = getattr(gk, group), getattr(gx, group)
    total = 0.0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(sub_k)[0],
                            jax.tree.leaves(sub_x)):
        a, b = np.asarray(a), np.asarray(b)
        if b.size == 0:
            continue
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))
        total += float(np.abs(a).sum())
    assert total > 0.0


@pytest.mark.parametrize("name", ["spheres", "triangles"])
def test_ray_grads_through_winner_recompute(name, interp):
    scene, cam = _GRAD_CASES[name]()
    flat, o, d = _rays(scene, cam)

    def f(o, d, use):
        hit = closest_hit(flat, o, d, use_kernel=use)
        t = jnp.where(hit.valid, hit.t, 0.0)
        return jnp.sum(t) + jnp.sum(jnp.where(hit.valid[:, None], hit.normal, 0.0))

    gk = jax.grad(f, argnums=(0, 1))(o, d, True)
    gx = jax.grad(f, argnums=(0, 1))(o, d, False)
    for a, b in zip(gk, gx):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * (float(np.abs(b).max()) + 1e-6))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_kernel_under_shard_map_mesh(shape, interp):
    """Per-device kernel winners combine over the prims axis
    (intersect._combine_hits_over_axis) to the single-device image."""
    scene, cam = head_box_scene(width=16, height=16, spp=1, pad_multiple=4)
    cfg = RenderConfig(shadow_mode="binary", chunk_size=32, max_depth=3)
    mesh = make_mesh(n_ray_shards=shape[0], n_prim_shards=shape[1])
    a = render_hdr_sharded(scene, cam, dataclasses.replace(cfg, use_pallas=True), mesh)
    b = render_hdr(scene, cam, cfg)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_sharded_loss_grads_with_kernel(interp):
    scene, cam = baseline_sphere_scene(width=16, height=8, spp=1)
    cfg = RenderConfig(shadow_mode="binary", max_depth=2)
    params, static = partition(scene)
    o, d = cam.rays_for_pixels(*cam.pixel_grid())
    target = jnp.zeros((o.shape[0], 3), o.dtype)
    mesh = make_mesh()
    lk = make_sharded_loss(static, dataclasses.replace(cfg, use_pallas=True), mesh)
    lx = make_sharded_loss(static, cfg, mesh)
    np.testing.assert_allclose(float(jax.jit(lk)(params, o, d, target)),
                               float(jax.jit(lx)(params, o, d, target)),
                               rtol=1e-6)
    gk = jax.jit(jax.grad(lk))(params, o, d, target)
    gx = jax.jit(jax.grad(lx))(params, o, d, target)
    for a, b in zip(jax.tree.leaves(gk), jax.tree.leaves(gx)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_use_pallas_without_gpu_raises():
    scene, cam = head_box_scene(width=8, height=8, spp=1)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        render_hdr(scene, cam, RenderConfig(use_pallas=True))


def test_closest_hit_kernel_without_gpu_raises():
    flat, o, d = _rays(*SCENES["box"]())
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        closest_hit(flat, o, d, use_kernel=True)


def test_gspmd_mesh_with_use_pallas_raises(interp):
    scene, cam = head_box_scene(width=8, height=8, spp=1)
    with pytest.raises(ValueError, match="render_hdr_sharded"):
        render_hdr(scene, cam, RenderConfig(use_pallas=True), mesh=make_mesh())


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """The compiled kernel at a real width: bounce-0 rays of the
    6,016-triangle mesh at 512^2, one 16,384-ray chunk."""
    scene, cam = dense_mesh_scene(512, 512)
    flat = flatten_scene(scene)
    px, py = cam.pixel_grid()
    o, d = cam.rays_for_pixels(px[120_000:136_384], py[120_000:136_384])
    jk, tk = (np.asarray(a) for a in jax.jit(
        lambda o, d: hk.closest_winner(flat, o, d))(o, d))
    _assert_same_winner(jk, tk, *_xla_winner(flat, o, d))
