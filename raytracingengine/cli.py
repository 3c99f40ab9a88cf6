"""Command-line interface: render / aov / bench-style timing.

The reference's app layer is main() (RaytracingEngine.cpp:216-330): build
the hard-coded scene, render, print the wall-clock, write all 7 tonemaps
as PPM and shell out to ffmpeg for PNG. The CLI generalizes that:

  python -m raytracingengine.cli render --scene head_box \
      --width 512 --height 512 --spp 4 --tonemap all --format png --out out/

Scenes: builtin names (head_box, baseline_spheres, glass, stress) or a
JSON file (scenes/config.py schema). PNG is encoded in-process (native
zlib or pure Python) — no ffmpeg.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _build_scene(args):
    import jax.numpy as jnp

    kw = dict(width=args.width, height=args.height, spp=args.spp)
    if args.scene == "head_box":
        from raytracingengine.scenes.builders import head_box_scene

        return head_box_scene(**kw)
    if args.scene == "baseline_spheres":
        from raytracingengine.scenes.builders import baseline_sphere_scene

        return baseline_sphere_scene(**kw)
    if args.scene == "glass":
        from raytracingengine.scenes.builders import glass_sphere_scene

        return glass_sphere_scene(**kw)
    if args.scene == "stress":
        from raytracingengine.scenes.builders import stress_scene

        return stress_scene(**kw)
    if args.scene == "dense_mesh":
        from raytracingengine.scenes.builders import dense_mesh_scene

        return dense_mesh_scene(**kw)
    from raytracingengine.scenes.config import load_scene_json

    return load_scene_json(
        args.scene, width=args.width, height=args.height, spp=args.spp
    )


def _save(img_u8: np.ndarray, path_base: str, fmt: str) -> str:
    from raytracingengine.imageio import write_png, write_ppm

    path = f"{path_base}.{fmt}"
    if fmt == "png":
        write_png(path, img_u8)
    else:
        write_ppm(path, img_u8)
    return path


def cmd_render(args) -> int:
    import jax

    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.tonemap import OPERATORS, to_uint8
    from raytracingengine.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    scene, camera = _build_scene(args)
    cfg = RenderConfig(
        max_depth=args.max_depth,
        chunk_size=args.chunk_size,
        shadow_mode=args.shadow_mode,
        use_pallas=args.use_pallas,
    )
    if args.mesh:
        from raytracingengine.parallel import make_mesh
        from raytracingengine.parallel.sharded import render_hdr_sharded

        # shard_map path: it also runs the Triton kernel per device, which
        # GSPMD cannot partition (see parallel/sharded.py).
        mesh = make_mesh()
        render = jax.jit(lambda s: render_hdr_sharded(s, camera, cfg, mesh))
    else:
        render = jax.jit(lambda s: render_hdr(s, camera, cfg))

    t0 = time.time()
    hdr = jax.block_until_ready(render(scene))
    t1 = time.time()
    # Timing printout, like RaytracingEngine.cpp:292-299 (plus compile split)
    hdr2 = jax.block_until_ready(render(scene))
    t2 = time.time()
    del hdr2
    print(
        f"render: {camera.width}x{camera.height} spp={camera.spp} "
        f"first={t1-t0:.2f}s steady={t2-t1:.3f}s "
        f"({camera.num_pixels*camera.spp/max(t2-t1,1e-9)/1e6:.1f} Mrays/s)"
    )
    finite = bool(jax.numpy.isfinite(hdr).all())
    print(f"hdr: finite={finite} mean={float(hdr.mean()):.6f}")
    if not finite:
        print("render: the HDR image has non-finite values", file=sys.stderr)
        return 1

    os.makedirs(args.out, exist_ok=True)
    names = list(OPERATORS) if args.tonemap == "all" else [args.tonemap]
    for name in names:
        mapped = OPERATORS[name](hdr)
        u8 = np.asarray(to_uint8(mapped))
        path = _save(u8, os.path.join(args.out, name), args.format)
        print(f"wrote {path}")
    return 0


def cmd_aov(args) -> int:
    import jax

    from raytracingengine.render.aov import render_aovs
    from raytracingengine.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    scene, camera = _build_scene(args)
    aovs = jax.jit(lambda s: render_aovs(s, camera))(scene)
    os.makedirs(args.out, exist_ok=True)
    for name, arr in aovs.items():
        a = np.asarray(arr)
        if a.ndim == 2:
            a = np.repeat(a[..., None], 3, axis=-1)
        u8 = (np.clip(a, 0, 1) * 255).astype(np.uint8)
        path = _save(u8, os.path.join(args.out, name), args.format)
        print(f"wrote {path}")
    return 0


def cmd_fit(args) -> int:
    """Inverse-rendering demo (BASELINE config #4): perturb the scene's
    sphere albedos, recover them by Adam on pixel L2 loss, report the
    loss curve and write target / initial / fitted renders."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from raytracingengine.inverse import fit, masked_optimizer, partition
    from raytracingengine.inverse.params import select
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.tonemap import aces_approx, to_uint8
    from raytracingengine.utils.metrics import MetricsLogger, fit_callback
    from raytracingengine.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    scene_true, camera = _build_scene(args)
    cfg = RenderConfig(shadow_mode="binary", chunk_size=args.width * args.height)
    render = jax.jit(lambda s: render_hdr(s, camera, cfg))
    target = render(scene_true)

    sph = scene_true.spheres
    mats = dataclasses.replace(
        sph.materials,
        color=jnp.clip(sph.materials.color + args.perturb, 0.0, 1.0),
    )
    scene0 = dataclasses.replace(
        scene_true, spheres=dataclasses.replace(sph, materials=mats)
    )

    params0, _ = partition(scene0)
    mask = select(params0, ["spheres.materials.color"])
    opt = masked_optimizer(optax.adam(args.lr), mask)
    logger = MetricsLogger()
    fitted, losses = fit(
        scene0, camera, cfg, target, steps=args.steps, optimizer=opt,
        callback=fit_callback(logger),
    )
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} in {args.steps} steps")

    os.makedirs(args.out, exist_ok=True)
    for name, scn in [("target", scene_true), ("initial", scene0), ("fitted", fitted)]:
        img = np.asarray(to_uint8(aces_approx(render(scn))))
        print(f"wrote {_save(img, os.path.join(args.out, name), args.format)}")
    if args.checkpoint:
        from raytracingengine.inverse.checkpoint import save_checkpoint

        p, _ = partition(fitted)
        save_checkpoint(args.checkpoint, p, opt.init(p), step=args.steps)
        print(f"checkpoint saved to {args.checkpoint}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytracingengine")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="head_box",
                        help="builtin name or scene JSON path")
        sp.add_argument("--width", type=int, default=512)
        sp.add_argument("--height", type=int, default=512)
        sp.add_argument("--spp", type=int, default=4)
        sp.add_argument("--out", default="out")
        sp.add_argument("--format", choices=["png", "ppm"], default="png")

    r = sub.add_parser("render", help="render + tonemap")
    common(r)
    r.add_argument("--tonemap", default="aces",
                   help="operator name or 'all' (the 7-operator family)")
    r.add_argument("--max-depth", type=int, default=10)
    r.add_argument("--chunk-size", type=int, default=65536)
    r.add_argument("--use-pallas", action="store_true",
                   help="Triton intersection kernel (CUDA GPU only)")
    r.add_argument("--shadow-mode", choices=["march", "binary", "soft"],
                   default="march")
    r.add_argument("--mesh", action="store_true",
                   help="shard over all devices")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("aov", help="depth/normal/albedo/hit maps")
    common(a)
    a.set_defaults(fn=cmd_aov)

    f = sub.add_parser(
        "fit", help="inverse rendering demo: recover perturbed scene params"
    )
    common(f)
    f.add_argument("--steps", type=int, default=150)
    f.add_argument("--lr", type=float, default=2e-2)
    f.add_argument("--perturb", type=float, default=0.15,
                   help="albedo perturbation magnitude")
    f.add_argument("--checkpoint", default=None,
                   help="orbax checkpoint dir (saved at the end)")
    f.set_defaults(fn=cmd_fit)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
