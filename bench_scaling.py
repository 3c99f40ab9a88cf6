"""Scaling-efficiency harness: rays/s across mesh sizes.

On a multi-GPU host this measures wall-clock rays/s for the GSPMD
auto-sharded renderer over 1, 2, 4, ... device meshes and reports
efficiency relative to the single-device rate. Run with
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 to
exercise the same code path on a virtual mesh (correctness + collective
structure; virtual-device wall-clock shares host cores and is NOT a
scaling measurement — the harness says so).

Usage: python bench_scaling.py [--width 512 --height 512]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=1)
    args = ap.parse_args()

    from raytracingengine.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from raytracingengine.parallel.mesh import make_mesh
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.scenes.builders import head_box_scene

    devices = jax.devices()
    n = len(devices)
    virtual = jax.default_backend() == "cpu"
    print(
        f"backend={jax.default_backend()} devices={n}"
        + (" (virtual mesh: NOT a wall-clock scaling measurement)" if virtual else ""),
        file=sys.stderr,
    )

    scene, camera = head_box_scene(
        width=args.width, height=args.height, spp=args.spp
    )
    cfg = RenderConfig(shadow_mode="binary", chunk_size=args.width * args.height)
    n_rays = args.width * args.height * args.spp

    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n]
    results = []
    base_rate = None
    for size in sizes:
        mesh = make_mesh(n_ray_shards=size, devices=devices[:size])
        f = jax.jit(
            lambda s, _mesh=mesh: jnp.sum(render_hdr(s, camera, cfg, mesh=_mesh))
        )
        v = float(f(scene))  # compile + correctness-forcing readback
        t0 = time.time()
        iters = 3
        for _ in range(iters):
            v = float(f(scene))
        dt = (time.time() - t0) / iters
        rate = n_rays / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * size)
        results.append(
            {"devices": size, "rays_per_s": round(rate, 1),
             "efficiency": round(eff, 3)}
        )
        print(
            f"devices={size}: {dt*1e3:.1f} ms -> {rate/1e6:.2f} Mrays/s "
            f"(efficiency {eff:.1%})",
            file=sys.stderr,
        )

    print(json.dumps({"scaling": results, "virtual_mesh": virtual}))


if __name__ == "__main__":
    main()
