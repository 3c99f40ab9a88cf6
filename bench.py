"""Benchmark: frame and training-step times of the renderer on a CUDA GPU.

    python bench.py [--use-pallas] [--only NAME ...]

Each line runs through the entry points a user calls (`render_hdr`,
`inverse.make_train_step`) with the default RenderConfig unless noted,
warms up once (compile time reported separately), then times `--iters`
calls ending in block_until_ready. Prints one JSON object stamped with the
platform, device kind, device count, the card's name and power limit.
Exits non-zero without a GPU: no number here comes from a CPU run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: name -> ((scene, width, height, spp, builder kwargs), kind, RenderConfig overrides)
LINES = {
    "box_1080p_spp8": (("head_box", 1920, 1080, 8, {}), "render", {}),
    "box_1000_spp32": (("head_box", 1000, 1000, 32, {}), "render", {}),
    "glass_1080p": (("glass", 1920, 1080, 1, {}), "render", {}),
    "stress_4k": (("stress", 3840, 2160, 1, {"pad_multiple": None}), "render",
                  {"shadow_mode": "binary"}),
    "mesh6k_512": (("dense_mesh", 512, 512, 1, {}), "render", {}),
    "mesh50k_512": (("dense_mesh", 512, 512, 1, {"ni": 128, "nj": 200}),
                    "render", {}),
    "train_box_1080p": (("head_box", 1920, 1080, 1, {}), "train",
                        {"shadow_mode": "binary"}),
    "train_mesh6k_512": (("dense_mesh", 512, 512, 1, {}), "train",
                         {"shadow_mode": "binary"}),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--use-pallas", action="store_true")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from raytracingengine.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import optax

    from raytracingengine.inverse import make_train_step, partition
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.scenes import builders

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a CUDA GPU, found {dev.platform}", file=sys.stderr)
        return 1
    build = {"head_box": builders.head_box_scene,
             "glass": builders.glass_sphere_scene,
             "stress": builders.stress_scene,
             "dense_mesh": builders.dense_mesh_scene}
    results = {}
    for name, ((kind, w, h, spp, kw), what, over) in LINES.items():
        if args.only and name not in args.only:
            continue
        scene, cam = build[kind](width=w, height=h, spp=spp, **kw)
        cfg = dataclasses.replace(RenderConfig(use_pallas=args.use_pallas), **over)
        render = jax.jit(lambda s, cam=cam, cfg=cfg: render_hdr(s, cam, cfg))
        if what == "render":
            def call(render=render, scene=scene):
                return render(scene)
        else:
            params, static = partition(scene)
            target = render(scene) * 1.01
            opt = optax.adam(1e-3)
            step = make_train_step(cam, cfg, opt)
            opt_state = opt.init(params)

            def call(step=step, p=params, s=static, o=opt_state, t=target):
                return step(p, s, o, t, jax.random.PRNGKey(0))

        t0 = time.perf_counter()
        jax.block_until_ready(call())
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = call()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        rays = w * h * spp
        results[name] = {"kind": what, "seconds": dt, "compile_s": compile_s,
                         "rays_per_s": rays / dt}
        print(f"{name}: {dt * 1e3:.1f} ms ({rays / dt / 1e6:.2f} Mrays/s), "
              f"compile {compile_s:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card(), "use_pallas": args.use_pallas,
        "xla_flags": os.environ.get("XLA_FLAGS", ""), "results": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
