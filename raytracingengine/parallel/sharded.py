"""Sharded rendering: shard_map over the device mesh.

Replaces the reference's OpenMP pixel loop (Scene.h:318-320) with a
`jax.shard_map` over a `Mesh`:

  * pixel blocks shard along `rays`; every device traces its own rays,
  * the scene pytree is replicated along `rays` — and optionally its
    triangle block is sharded along `prims` (each device intersects its
    triangle shard, winners combine via all_gather argmin inside
    `closest_hit`),
  * gradients w.r.t. replicated scene parameters are psum-reduced across
    the mesh automatically by shard_map's transpose.

With `cfg.use_pallas` every device runs the Triton intersection kernel on
its own rays (and its own triangle shard): shard_map is how the kernel
composes with a mesh, since GSPMD cannot partition it.

The image edge is padded so the ray axis divides evenly; padding pixels
trace real rays and are cropped on return.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from raytracingengine.core.camera import Camera
from raytracingengine.geometry.intersect import flatten_scene
from raytracingengine.parallel.mesh import PRIM_AXIS, RAY_AXIS
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import _render_chunk, resolve_mode
from raytracingengine.scene import Scene


def scene_partition_specs(scene: Scene, shard_triangles: bool) -> Scene:
    """PartitionSpec pytree for a Scene: everything replicated except
    (optionally) the triangle block, sharded along PRIM_AXIS on dim 0."""

    def repl(_):
        return P()

    specs = jax.tree.map(repl, scene)
    if shard_triangles:
        tri_specs = jax.tree.map(lambda _: P(PRIM_AXIS), scene.triangles)
        specs = jax.tree_util.tree_map(
            lambda s: s, specs
        )  # copy container
        specs = specs.__class__(
            spheres=specs.spheres,
            planes=specs.planes,
            triangles=tri_specs,
            lights=specs.lights,
            has_transparency=scene.has_transparency,
        )
    return specs


def render_hdr_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    key: jnp.ndarray | None = None,
    mode: str | None = None,
) -> jnp.ndarray:
    """Full-frame sharded render -> [H, W, 3]. Jittable.

    Mesh axes: RAY_AXIS shards pixels; PRIM_AXIS (if present) shards the
    triangle block (triangle count must divide the axis size — build the
    scene with pad_multiple).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    m = mode or resolve_mode(scene, cfg)
    has_prim_axis = PRIM_AXIS in mesh.axis_names
    prim_axis = PRIM_AXIS if has_prim_axis else None
    n_ray = mesh.shape[RAY_AXIS]

    px, py = camera.pixel_grid()
    r = camera.num_pixels
    # Local chunking keeps per-device memory bounded; pad to n_ray * chunk.
    local = -(-r // n_ray)
    chunk = min(cfg.chunk_size, local)
    n_chunks = -(-local // chunk)
    local = n_chunks * chunk
    pad = n_ray * local - r
    px = jnp.pad(px, (0, pad))
    py = jnp.pad(py, (0, pad))

    scene_specs = scene_partition_specs(scene, has_prim_axis)
    cam_specs = jax.tree.map(lambda _: P(), camera)

    def local_render(px_l, py_l, scene_l, camera_l, key_l):
        flat = flatten_scene(scene_l)
        shard_id = jax.lax.axis_index(RAY_AXIS)
        px_c = px_l.reshape(n_chunks, chunk)
        py_c = py_l.reshape(n_chunks, chunk)

        def per_chunk(args):
            cid, px_i, py_i = args
            ck = jax.random.fold_in(key_l, shard_id * n_chunks + cid)
            # base_key (replicated across shards) + per-pixel jitter
            # keying makes spp>1 renders shard-count-invariant AND
            # identical to the single-device pipeline at the same seed.
            return _render_chunk(
                flat, camera_l, cfg, m, px_i, py_i, ck, prim_axis,
                base_key=key_l,
            )

        out = jax.lax.map(per_chunk, (jnp.arange(n_chunks), px_c, py_c))
        return out.reshape(-1, 3)

    fn = jax.shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(RAY_AXIS), P(RAY_AXIS), scene_specs, cam_specs, P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    out = fn(px, py, scene, camera, key)
    return out[:r].reshape(camera.height, camera.width, 3)


def render_hdr_auto(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    key: jnp.ndarray | None = None,
    mode: str | None = None,
) -> jnp.ndarray:
    """GSPMD auto-partitioned render: the single-device pipeline with a
    sharding constraint on the ray axis; XLA distributes compute and
    inserts the backward-pass gradient psums itself. This is the
    differentiation-friendly distribution path (shard_map's manual path
    above is forward-render oriented).
    """
    from raytracingengine.render.pipeline import render_hdr

    return render_hdr(scene, camera, cfg, key=key, mode=mode, mesh=mesh)


def make_sharded_loss(static, cfg: RenderConfig, mesh: Mesh, mode: str = "chain"):
    """Multi-device training loss: shard_map over the ray axis, scene
    parameters replicated. shard_map's transpose inserts the psum of the
    replicated scene-parameter gradients. With `cfg.use_pallas` each
    device runs the Triton intersection kernel on its rays.

    Returns loss(params, o, d, target) -> scalar mean-squared error;
    o/d/target lead with a ray axis divisible by mesh.shape[RAY_AXIS].
    """
    from raytracingengine.inverse import combine
    from raytracingengine.render.integrator import (
        integrate_chain,
        integrate_wavefront,
    )

    def loss(params, o, d, target):
        n_elems = target.size

        def local(p, oo, dd, tt):
            flat = flatten_scene(combine(p, static))
            trace = integrate_chain if mode == "chain" else integrate_wavefront
            img = trace(flat, oo, dd, cfg)
            return jax.lax.psum(jnp.sum((img - tt) ** 2), RAY_AXIS)

        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
            out_specs=P(),
            check_vma=False,
        )
        return fn(params, o, d, target) / n_elems

    return loss
