"""Render pipeline: camera -> chunked ray blocks -> integrator -> HDR image.

The reference's RenderImage is one OpenMP `parallel for` over the flat
pixel index with a 32-sample AA loop per pixel (Scene.h:283-328). Here the
pixel axis is the vector axis: rays are generated and traced in fixed-size
chunks (`cfg.chunk_size`) via `lax.map`, and the AA loop is a `lax.scan`
over samples — sample 0 unjittered, samples 1.. jittered with a
counter-based `jax.random` stream (Scene.h:289-296, Math.h:103-116).

The mean over samples divides by spp: in the reference every sample
contributes (TraceRay always returns a value), so samples == spp always.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracingengine.core.camera import Camera
from raytracingengine.geometry.intersect import FlatScene, flatten_scene
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.integrator import (
    integrate_chain,
    integrate_wavefront,
)
from raytracingengine.scene import Scene


def resolve_mode(scene: Scene, cfg: RenderConfig) -> str:
    if cfg.mode != "auto":
        return cfg.mode
    return "wavefront" if scene.has_transparency else "chain"


def render_rays(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    cfg: RenderConfig,
    mode: str | None = None,
) -> jnp.ndarray:
    """Trace an arbitrary ray block [R,3]x[R,3] -> HDR [R,3]."""
    flat = flatten_scene(scene)
    m = mode or resolve_mode(scene, cfg)
    if cfg.soft_primary and m == "chain":
        from raytracingengine.render.soft_primary import integrate_chain_soft

        return integrate_chain_soft(flat, o, d, cfg)
    fn = integrate_chain if m == "chain" else integrate_wavefront
    return fn(flat, o, d, cfg)


def _pixel_jitter(key, s, pids, n, dtype):
    """Per-sample jitter in [0,1)^2, keyed by the pixel's row-major flat
    index (`pids`), not by chunk-relative position: each pixel draws the
    same stream however the frame is chunked or sharded. This is the
    renderer's only jitter stream, shared by every path."""
    ks = jax.random.fold_in(key, s)
    keys = jax.vmap(lambda p: jax.random.fold_in(ks, p))(pids)
    return jax.vmap(lambda k: jax.random.uniform(k, (2,), dtype=dtype))(keys)


def _render_chunk(
    flat: FlatScene,
    camera: Camera,
    cfg: RenderConfig,
    mode: str,
    px: jnp.ndarray,
    py: jnp.ndarray,
    chunk_key: jnp.ndarray,
    prim_axis: str | None = None,
    base_key: jnp.ndarray | None = None,
    pids: jnp.ndarray | None = None,
) -> jnp.ndarray:
    if cfg.soft_primary and mode == "chain":
        from raytracingengine.render.soft_primary import integrate_chain_soft

        integrate = integrate_chain_soft
    else:
        integrate = integrate_chain if mode == "chain" else integrate_wavefront
    o0, d0 = camera.rays_for_pixels(px, py, None)  # sample 0: center ray
    acc = integrate(flat, o0, d0, cfg, prim_axis)
    if camera.spp > 1:
        if pids is None:  # direct callers without a pixel-id mapping
            pids = (py.astype(jnp.int32) * camera.width
                    + px.astype(jnp.int32))
        jkey = base_key if base_key is not None else chunk_key

        def body(carry, s):
            jitter = _pixel_jitter(jkey, s, pids, px.shape[0], o0.dtype)
            o, d = camera.rays_for_pixels(px, py, jitter)
            return carry + integrate(flat, o, d, cfg, prim_axis), None

        acc, _ = jax.lax.scan(body, acc, jnp.arange(1, camera.spp))
    return acc / camera.spp


def render_hdr(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    key: jnp.ndarray | None = None,
    mode: str | None = None,
    mesh=None,
    ray_spec=None,
) -> jnp.ndarray:
    """Full-frame HDR render -> [H, W, 3]. Jittable (cfg/mode static).

    With `mesh` (a jax.sharding.Mesh), the ray axis is annotated with a
    sharding constraint and XLA's SPMD partitioner distributes the whole
    pipeline — including backward-pass psums of replicated scene-parameter
    gradients — across the mesh. `ray_spec` defaults to sharding over all
    mesh axes.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if mesh is not None and mesh.size > 1 and cfg.use_pallas:
        # XLA's SPMD partitioner has no rule for a Pallas custom call: it
        # all-gathers the rays and runs the whole kernel on every device
        # (`chip_smoke.py --four-cards` prints the compiled call's width).
        raise ValueError(
            "use_pallas=True cannot be partitioned by GSPMD (render_hdr with "
            "a multi-device mesh). Use parallel.sharded.render_hdr_sharded or "
            "make_sharded_loss (shard_map), which run the kernel per device, "
            "or set use_pallas=False."
        )
    flat = flatten_scene(scene)
    m = mode or resolve_mode(scene, cfg)

    px, py = camera.pixel_grid()
    r = camera.num_pixels
    # Row-major flat pixel ids ride along so jitter streams stay keyed to
    # the pixel, not to the chunk (_pixel_jitter).
    pids = jnp.arange(r, dtype=jnp.int32)
    chunk = min(cfg.chunk_size, r)
    n_chunks = -(-r // chunk)
    pad = n_chunks * chunk - r
    px = jnp.pad(px, (0, pad)).reshape(n_chunks, chunk)
    py = jnp.pad(py, (0, pad)).reshape(n_chunks, chunk)
    pids = jnp.pad(pids, (0, pad)).reshape(n_chunks, chunk)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        if ray_spec is None:
            ray_spec = PartitionSpec(None, mesh.axis_names)
        sh = NamedSharding(mesh, ray_spec)
        px = jax.lax.with_sharding_constraint(px, sh)
        py = jax.lax.with_sharding_constraint(py, sh)
    chunk_ids = jnp.arange(n_chunks)

    def per_chunk(args):
        cid, px_c, py_c, pid_c = args
        return _render_chunk(
            flat, camera, cfg, m, px_c, py_c, jax.random.fold_in(key, cid),
            base_key=key, pids=pid_c,
        )

    out = jax.lax.map(per_chunk, (chunk_ids, px, py, pids))  # [n_chunks, chunk, 3]
    return out.reshape(-1, 3)[:r].reshape(camera.height, camera.width, 3)
