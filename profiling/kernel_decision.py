"""Triton intersection kernel against XLA's all-pairs path, on the GPU.

Three measurements, each in its own mode:

  python profiling/kernel_decision.py tune
      Compiled kernel against XLA `closest_hit` / `any_hit_before` on one
      16,384-ray chunk of bounce-0 rays (box scene, 6,016- and
      50,800-triangle meshes): agreement, then device time of the kernel
      for a sweep of launch shapes (hit_kernel.Tiling) beside XLA's.

  python profiling/kernel_decision.py decide
      End-to-end `render_hdr` time with use_pallas=False and True on the
      four decision scenes (default RenderConfig: march shadows, depth 10,
      chunk 16,384), one process per scene, timed in turns xla, kernel,
      kernel, xla; then the XLA path's peak memory on the 50,800-triangle
      mesh at chunk sizes 65,536, 32,768 and 16,384, one fresh process
      each so that `peak_bytes_in_use` is that frame's own. The parent
      never imports JAX: one process holds the card at a time.

  python profiling/kernel_decision.py trace-names
      Process and thread names of a GPU profiler trace, to key
      utils/profiling.py on.

Every mode prints JSON lines (also appended to
chiprun_out/kernel_decision.jsonl) stamped with the card and its power
limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out", "kernel_decision.jsonl")

#: name -> (builder kwargs, width, height, spp)
SCENES = {
    "box_1080p_spp8": ("head_box", {}, 1920, 1080, 8),
    "mesh6k_512": ("dense_mesh", {}, 512, 512, 1),
    "mesh50k_512": ("dense_mesh", {"ni": 128, "nj": 200}, 512, 512, 1),
    "glass_1080p": ("glass", {}, 1920, 1080, 1),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _jax():
    sys.path.insert(0, REPO)
    from raytracingengine.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU: {jax.devices()[0]}")
    return jax


def build(name):
    from raytracingengine.scenes import builders

    kind, kw, w, h, spp = SCENES[name]
    fn = {"head_box": builders.head_box_scene,
          "dense_mesh": builders.dense_mesh_scene,
          "glass": builders.glass_sphere_scene}[kind]
    return fn(width=w, height=h, spp=spp, **kw)


def _time(fn, *args, iters=5):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def tune() -> None:
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from raytracingengine.geometry import hit_kernel as hk
    from raytracingengine.geometry.intersect import (
        any_hit_before,
        closest_index,
        flatten_scene,
    )

    c = card()
    configs = [hk.Tiling(bp, br, nw, ns, prog) for bp, br, nw, ns, prog in (
        (16, 128, 4, 1, 1), (16, 128, 4, 1, 1024), (16, 128, 4, 2, 1024),
        (16, 128, 4, 3, 2048), (8, 128, 4, 1, 1024), (32, 128, 4, 1, 1024),
        (32, 64, 4, 1, 2048), (16, 64, 2, 1, 2048), (8, 64, 2, 2, 4096),
        (4, 128, 4, 2, 2048), (16, 256, 8, 1, 1024), (8, 32, 1, 1, 4096),
        (16, 128, 4, 1, 4096), (32, 128, 8, 2, 2048))]
    for name in ("box_1080p_spp8", "mesh6k_512", "mesh50k_512"):
        scene, cam = build(name)
        flat = flatten_scene(scene)
        px, py = cam.pixel_grid()
        mid = cam.num_pixels // 2
        o, d = cam.rays_for_pixels(px[mid - 8192: mid + 8192],
                                   py[mid - 8192: mid + 8192])
        md = jnp.full((o.shape[0],), 6.0, o.dtype)

        xw = jax.jit(lambda o, d: closest_index(flat, o, d))
        xa = jax.jit(lambda o, d: any_hit_before(flat, o, d, md))
        jx, tx = (np.asarray(a) for a in xw(o, d))
        ax = np.asarray(xa(o, d))
        rec = {"mode": "tune", "scene": name, "card": c,
               "n_prims": flat.n_primitives, "rays": int(o.shape[0]),
               "xla_closest_ms": _time(xw, o, d) * 1e3,
               "xla_anyhit_ms": _time(xa, o, d) * 1e3, "configs": []}
        for tl in configs:
            kc = jax.jit(lambda o, d, tl=tl: hk.closest_winner(flat, o, d, tl))
            ka = jax.jit(lambda o, d, tl=tl: hk.any_hit(flat, o, d, md, tiling=tl))
            jk, tk = (np.asarray(a) for a in kc(o, d))
            ak = np.asarray(ka(o, d))
            fin = np.isfinite(tx)
            diff = jk != jx
            rel = np.abs(tk[fin] - tx[fin]) / np.abs(tx[fin])
            rec["configs"].append({
                **dataclasses.asdict(tl),
                "closest_ms": _time(kc, o, d) * 1e3,
                "anyhit_ms": _time(ka, o, d) * 1e3,
                "winner_mismatch": int(diff.sum()),
                "t_max_rel": float(rel.max()) if rel.size else 0.0,
                "miss_agree": bool((np.isfinite(tk) == fin).all()),
                "anyhit_mismatch": int((ak != ax).sum()),
            })
        emit(rec)


def case(name: str) -> None:
    """Both paths in one process, timed in turns xla, kernel, kernel, xla."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr

    scene, cam = build(name)
    fns, imgs, rec = {}, {}, {"mode": "case", "scene": name, "card": card(),
                              "chunk": RenderConfig().chunk_size}
    for impl in ("xla", "kernel"):
        cfg = RenderConfig(use_pallas=impl == "kernel")
        fns[impl] = jax.jit(lambda s, cfg=cfg: render_hdr(s, cam, cfg))
        t0 = time.perf_counter()
        imgs[impl] = np.asarray(jax.block_until_ready(fns[impl](scene)))
        rec[f"{impl}_first_s"] = time.perf_counter() - t0
    for impl in ("xla", "kernel", "kernel", "xla"):
        t0 = time.perf_counter()
        jax.block_until_ready(fns[impl](scene))
        rec.setdefault(f"{impl}_steady_s", []).append(time.perf_counter() - t0)
    diff = np.abs(imgs["kernel"] - imgs["xla"])
    rec.update(
        finite=bool(np.isfinite(imgs["kernel"]).all()),
        max_abs_diff=float(diff.max()),
        frac_diff_gt_1e3=float((diff.max(-1) > 1e-3).mean()),
        peak_bytes=jax.devices()[0].memory_stats()["peak_bytes_in_use"],
        rays=cam.num_pixels * cam.spp,
    )
    emit(rec)


def mem(chunk: int) -> None:
    """Peak device memory of one XLA-path frame of the 50.8k mesh."""
    jax = _jax()
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr

    scene, cam = build("mesh50k_512")
    f = jax.jit(lambda s: render_hdr(s, cam, RenderConfig(chunk_size=chunk)))
    rec = {"mode": "mem", "scene": "mesh50k_512", "impl": "xla",
           "chunk": chunk, "card": card()}
    try:
        jax.block_until_ready(f(scene))
    except Exception as e:  # running out of device memory is the result
        rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    rec["peak_bytes"] = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    emit(rec)


def decide() -> None:
    def run(*args):
        subprocess.run([sys.executable, __file__, *args], check=False)

    for name in SCENES:
        run("case", name)
    for chunk in ("65536", "32768", "16384"):
        run("mem", chunk)


def trace_names() -> None:
    jax = _jax()
    import glob
    import gzip
    import tempfile

    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.scenes.builders import head_box_scene

    scene, cam = head_box_scene(width=64, height=64, spp=1)
    out = {}
    for use in (False, True):
        f = jax.jit(lambda s, u=use: render_hdr(
            s, cam, RenderConfig(use_pallas=u, max_depth=2)))
        jax.block_until_ready(f(scene))
        d = tempfile.mkdtemp()
        with jax.profiler.trace(d, create_perfetto_trace=True):
            jax.block_until_ready(f(scene))
        path = sorted(glob.glob(d + "/**/*.trace.json.gz", recursive=True))[-1]
        with gzip.open(path, "rt") as fh:
            evs = json.load(fh)["traceEvents"]
        pids = {e["pid"]: e["args"]["name"] for e in evs
                if e.get("ph") == "M" and e.get("name") == "process_name"}
        tids = {f'{e["pid"]}/{e.get("tid")}': e["args"]["name"] for e in evs
                if e.get("ph") == "M" and e.get("name") == "thread_name"}
        sample: dict = {}
        for e in evs:
            if e.get("ph") == "X":
                k = f'{pids.get(e["pid"])} :: {tids.get(f"{e["pid"]}/{e.get("tid")}")}'
                sample.setdefault(k, set()).add(e["name"][:80])
        out[f"use_pallas={use}"] = {
            "processes": pids, "threads": tids,
            "events": {k: sorted(v)[:12] for k, v in sample.items()},
        }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "trace_names.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    emit({"mode": "trace-names", "card": card(),
          "processes": sorted(set().union(*(set(v["processes"].values())
                                            for v in out.values())))})


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "tune":
        tune()
    elif mode == "decide":
        decide()
    elif mode == "case":
        case(sys.argv[2])
    elif mode == "mem":
        mem(int(sys.argv[2]))
    elif mode == "trace-names":
        trace_names()
    else:
        raise SystemExit(__doc__)
