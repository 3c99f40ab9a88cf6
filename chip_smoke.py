"""The quickest proof that the renderer runs on a CUDA GPU.

    python chip_smoke.py              # one card: phases 1-6
    python chip_smoke.py --four-cards # four cards: the sharded paths only

Every phase goes through the entry points a user calls, at full scene
sizes, on the card (no interpreter, no CPU fallback), and checks its
result against a bound; it prints compile seconds, steady seconds and the
process's peak device memory so far. The real C++ engine's HDR dumps under
refbuild/ are the reference for the renders. Any failed phase makes the
exit code 1, and then the last line is not the result line. Without a GPU
the script exits 1 before any phase.

One card:
  1  `cli render` head_box 1920x1080 spp 8: the HDR is finite, the PNG is written.
  2  render_hdr dense_mesh (6,016 triangles) 512^2 vs refbuild/dense_mesh_512.
  3  render_hdr dense_mesh (50,800 triangles) 256^2 vs dense_mesh_streamed_256.
  4  render_hdr glass 256^2 vs refbuild/glass_256 (wavefront, refraction, march).
  5  `cli fit` 1920x1080, 5 steps: the loss falls; value_and_grad of an L2
     loss at 256^2 on the GPU vs the CPU.
  6  the compiled Triton kernel vs XLA's closest_hit / any_hit_before on
     bounce-0 rays of both meshes at 512^2; phase 2 with use_pallas=True.

Four cards (--four-cards): render_hdr_sharded on a ('rays',) 4-mesh and a
('rays','prims') 2x2 mesh vs the one-card render, make_sharded_loss grads
vs one-card grads, render_hdr(mesh=...) under GSPMD, and whether GSPMD
partitions the Triton kernel.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1 or 4}}
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

#: Parity budget of the real-engine gates (tests/test_reference_parity.py):
#: share of subpixels more than 1 LDR byte from the C++ engine's frame.
MESH_BAD_FRAC = 2e-5
#: Exact closest-hit ties the kernel may break differently from XLA, as a
#: share of rays; everywhere else winners must be identical.
TIE_FRAC = 2e-5
#: Relative tolerance of the kernel's t against XLA's.
T_RTOL = 1e-5
#: GPU-vs-CPU gradient tolerance (the one __graft_entry__.py uses).
GRAD_RTOL = 2e-4

FAILURES: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def peak_bytes(jax) -> int:
    return max(d.memory_stats()["peak_bytes_in_use"] for d in jax.local_devices())


def phase(name: str):
    """Decorator: run a phase, report it, record its failure."""

    def wrap(fn):
        def run(jax, *args):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                problems = fn(jax, *args) or []
            except Exception:
                traceback.print_exc()
                problems = ["raised"]
            status = "PASS" if not problems else "FAIL " + "; ".join(problems)
            log(f"   {status}  ({time.perf_counter() - t0:.1f} s, "
                f"peak {peak_bytes(jax) / 2**30:.2f} GiB so far)")
            if problems:
                FAILURES.append(name)

        return run

    return wrap


def timed(jax, fn, *args):
    """-> (result, compile_s, steady_s): first call, then one more."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def run_cli(argv: list) -> tuple[int, str]:
    from raytracingengine import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    sys.stdout.write("".join("   | " + ln + "\n" for ln in out.splitlines()))
    return rc, out


def parity(jax, scene, cam, cfg, dump, budget):
    import numpy as np

    from raytracingengine.golden import refdump
    from raytracingengine.render.pipeline import render_hdr

    f = jax.jit(lambda s: render_hdr(s, cam, cfg))
    img, first, steady = timed(jax, f, scene)
    stats = refdump.parity_stats(np.asarray(img), refdump.load_dump(dump))
    log(f"   compile+run {first:.2f} s, steady {steady:.3f} s; vs C++ {dump}: "
        f"p99.9 {stats['p999_hdr_diff']:.2e} (< 5e-05), bad subpixels "
        f"{stats['bad_subpixel_frac']:.2e} (<= {budget:.0e})")
    return refdump.parity_failures(stats, budget)


# ---------------------------------------------------------------- one card


@phase("1 cli render head_box 1920x1080 spp=8")
def phase_cli_render(jax):
    with tempfile.TemporaryDirectory() as out:
        rc, text = run_cli(["render", "--scene", "head_box", "--width", "1920",
                            "--height", "1080", "--spp", "8", "--out", out])
        png = os.path.join(out, "aces.png")
        ok_png = os.path.exists(png) and os.path.getsize(png) > 0
    m = re.search(r"first=([\d.]+)s steady=([\d.]+)s", text)
    if m:
        log(f"   compile+run {m.group(1)} s, steady {m.group(2)} s")
    problems = []
    if rc != 0 or "hdr: finite=True" not in text:
        problems.append("HDR not finite")
    if not ok_png:
        problems.append("no PNG")
    return problems


def _mesh6k(jax, use_pallas):
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.scenes.builders import dense_mesh_scene

    scene, cam = dense_mesh_scene(512, 512, spp=1)
    return parity(jax, scene, cam, RenderConfig(use_pallas=use_pallas),
                  "dense_mesh_512", MESH_BAD_FRAC)


@phase("2 render_hdr dense_mesh 6,016 tris 512^2 vs C++ engine")
def phase_mesh6k(jax):
    return _mesh6k(jax, False)


@phase("6b render_hdr dense_mesh 512^2 use_pallas=True vs C++ engine")
def phase_mesh6k_kernel(jax):
    return _mesh6k(jax, True)


@phase("3 render_hdr dense_mesh 50,800 tris 256^2 vs C++ engine")
def phase_mesh50k(jax):
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.scenes.builders import dense_mesh_scene

    scene, cam = dense_mesh_scene(256, 256, spp=1, ni=128, nj=200)
    return parity(jax, scene, cam, RenderConfig(), "dense_mesh_streamed_256",
                  MESH_BAD_FRAC)


@phase("4 render_hdr glass 256^2 vs C++ engine (budget 0)")
def phase_glass(jax):
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.scenes.builders import glass_sphere_scene

    scene, cam = glass_sphere_scene(256, 256, spp=1)
    return parity(jax, scene, cam, RenderConfig(), "glass_256", 0.0)


@phase("5 training: cli fit 1920x1080 5 steps; GPU vs CPU value_and_grad 256^2")
def phase_train(jax):
    import jax.numpy as jnp
    import numpy as np

    from raytracingengine.inverse import combine, partition
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.scenes.builders import baseline_sphere_scene

    problems = []
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc, text = run_cli(["fit", "--scene", "baseline_spheres", "--steps", "5",
                            "--width", "1920", "--height", "1080", "--spp", "1",
                            "--out", out])
        log(f"   cli fit {time.perf_counter() - t0:.2f} s (compile included)")
    m = re.search(r"fit: loss ([\d.e+-]+) -> ([\d.e+-]+)", text)
    if rc != 0 or not m or not float(m.group(2)) < float(m.group(1)):
        problems.append("fit loss did not fall")

    # HIGHEST-precision contractions keep the GPU in fp32 (no TF32), so the
    # GPU and CPU programs differ only in the order of fp32 sums and in
    # fused multiply-adds, ~1e-7 relative per operation; through
    # depth-limited chains and a mean over 65,536 pixels that stays far
    # below 2e-4 wherever the image is a smooth function of its inputs.
    # Sphere centres and radii are the exception: their gradients include
    # pixels at hard silhouettes and shadow edges, where a last-bit change
    # flips a pixel's hit. For those leaves the bound is twice the change
    # that moving the camera by 1e-6 causes on the CPU alone.
    scene, cam = baseline_sphere_scene(256, 256, spp=1)
    cfg = RenderConfig(shadow_mode="binary")
    params, static = partition(scene)
    target = render_hdr(scene, cam, cfg)
    p0 = jax.tree.map(lambda x: x * 1.05 if jnp.issubdtype(x.dtype, jnp.floating)
                      else x, params)

    def loss(p, tgt, cam):
        img = render_hdr(combine(p, static), cam, cfg)
        return jnp.mean((img - tgt) ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    (lg, gg), first, steady = timed(jax, vg, p0, target, cam)
    log(f"   value_and_grad on {jax.devices()[0].device_kind}: compile+run "
        f"{first:.2f} s, steady {steady:.3f} s")
    cpu = jax.devices("cpu")[0]
    vg_cpu = jax.jit(jax.value_and_grad(loss), device=cpu)
    p_c, t_c, cam_c = jax.device_put((p0, target, cam), cpu)
    cam_moved = dataclasses.replace(cam_c, position=cam_c.position + 1e-6)
    lc, gc = vg_cpu(p_c, t_c, cam_c)
    _, g_moved = vg_cpu(p_c, t_c, cam_moved)
    edge_leaves = (".spheres.centers", ".spheres.radii")
    l1 = 0.0
    for (path, a), b, m in zip(jax.tree_util.tree_flatten_with_path(gg)[0],
                               jax.tree.leaves(gc), jax.tree.leaves(g_moved)):
        a, b, m = np.asarray(a), np.asarray(b), np.asarray(m)
        name = jax.tree_util.keystr(path)
        if a.size == 0:
            continue
        l1 += float(np.abs(a).sum())
        if not np.isfinite(a).all():
            problems.append(f"non-finite GPU grads {name}")
        diff = float(np.abs(a - b).max())
        if name in edge_leaves:
            floor = float(np.abs(m - b).max())
            ok = diff <= 2 * floor + GRAD_RTOL * float(np.abs(b).max())
            log(f"   {name}: max |GPU-CPU| {diff:.2e}, CPU camera-moved floor "
                f"{floor:.2e} (bound 2x floor + rtol x max), {'ok' if ok else 'FAIL'}")
        else:
            ok = np.allclose(a, b, rtol=GRAD_RTOL, atol=1e-6)
            if not ok:
                log(f"   {name}: max |GPU-CPU| {diff:.2e} beyond rtol {GRAD_RTOL}")
        if not ok:
            problems.append(f"GPU grads differ from CPU grads at {name}")
    log(f"   loss GPU {float(lg):.8f} CPU {float(lc):.8f}; grad L1 {l1:.4e}; "
        f"other leaves within rtol {GRAD_RTOL}, atol 1e-6")
    if not np.isclose(float(lg), float(lc), rtol=GRAD_RTOL):
        problems.append("GPU loss differs from CPU loss")
    if not l1 > 0.0:
        problems.append("zero grads")
    return problems


def _bounce0(cam):
    return cam.rays_for_pixels(*cam.pixel_grid())


@phase("6 compiled Triton kernel vs XLA closest_hit / any_hit_before, 512^2")
def phase_kernel(jax):
    import jax.numpy as jnp
    import numpy as np

    from raytracingengine.geometry import hit_kernel as hk
    from raytracingengine.geometry.intersect import (
        any_hit_before,
        closest_index,
        flatten_scene,
    )
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.scenes.builders import dense_mesh_scene

    problems = []
    for label, kw in (("6,016 tris", {}), ("50,800 tris", {"ni": 128, "nj": 200})):
        scene, cam = dense_mesh_scene(512, 512, spp=1, **kw)
        flat = flatten_scene(scene)
        o, d = _bounce0(cam)
        md = jnp.full((o.shape[0],), 8.5, o.dtype)  # ends inside the mesh
        chunk = min(RenderConfig().chunk_size, o.shape[0])

        def xla(o, d, md):
            def one(args):
                oc, dc, mc = args
                return (*closest_index(flat, oc, dc),
                        any_hit_before(flat, oc, dc, mc))

            r = (-1, chunk)
            j, t, a = jax.lax.map(one, (o.reshape(*r, 3), d.reshape(*r, 3),
                                        md.reshape(r)))
            return j.reshape(-1), t.reshape(-1), a.reshape(-1)

        def kern(o, d, md):
            j, t = hk.closest_winner(flat, o, d)
            return j, t, hk.any_hit(flat, o, d, md)

        (jx, tx, ax), _, sx = timed(jax, jax.jit(xla), o, d, md)
        (jk, tk, ak), fk, sk = timed(jax, jax.jit(kern), o, d, md)
        jx, tx, ax, jk, tk, ak = map(np.asarray, (jx, tx, ax, jk, tk, ak))
        fin = np.isfinite(tx)
        rel = np.abs(tk[fin] - tx[fin]) / np.abs(tx[fin])
        differ = jk != jx
        ties = int((differ & np.isclose(tk, tx, rtol=T_RTOL, atol=0)).sum())
        hard = int(differ.sum()) - ties
        n = jk.size
        log(f"   {label}: {n} rays; kernel compile+run {fk:.2f} s, steady "
            f"{sk * 1e3:.2f} ms vs XLA steady {sx * 1e3:.2f} ms; winners differ "
            f"at {int(differ.sum())} rays ({ties} ties, bound {TIE_FRAC * n:.1f}); "
            f"t max rel {rel.max():.2e} (<= {T_RTOL:.0e}); miss sets equal "
            f"{bool((np.isfinite(tk) == fin).all())}; any-hit differs at "
            f"{int((ak != ax).sum())}")
        if hard or ties > TIE_FRAC * n:
            problems.append(f"{label}: winners differ beyond ties")
        if rel.max() > T_RTOL or not (np.isfinite(tk) == fin).all():
            problems.append(f"{label}: t differs")
        if (ak != ax).sum() > TIE_FRAC * n:
            problems.append(f"{label}: any-hit differs")
    return problems


def one_card(jax) -> None:
    phase_cli_render(jax)
    phase_mesh6k(jax)
    phase_mesh50k(jax)
    phase_glass(jax)
    phase_train(jax)
    phase_kernel(jax)
    phase_mesh6k_kernel(jax)


# -------------------------------------------------------------- four cards


@phase("4c-1 render_hdr_sharded ('rays',)x4 and ('rays','prims') 2x2 vs one card")
def phase_sharded_render(jax):
    import numpy as np

    from raytracingengine.golden import refdump
    from raytracingengine.parallel.mesh import make_mesh
    from raytracingengine.parallel.sharded import render_hdr_sharded
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.scenes.builders import dense_mesh_scene

    scene, cam = dense_mesh_scene(512, 512, spp=1)
    problems = []
    for use in (False, True):
        cfg = RenderConfig(use_pallas=use)
        one = np.asarray(jax.jit(lambda s: render_hdr(s, cam, cfg))(scene))
        for shape in ((4, 1), (2, 2)):
            mesh = make_mesh(n_ray_shards=shape[0], n_prim_shards=shape[1])
            f = jax.jit(lambda s, m=mesh: render_hdr_sharded(s, cam, cfg, m))
            img, first, steady = timed(jax, f, scene)
            stats = refdump.parity_stats(np.asarray(img), one)
            bad = refdump.parity_failures(stats, MESH_BAD_FRAC)
            log(f"   use_pallas={use} mesh {shape}: compile+run {first:.2f} s, "
                f"steady {steady:.3f} s; vs one card: bad subpixels "
                f"{stats['bad_subpixel_frac']:.2e}, p99.9 {stats['p999_hdr_diff']:.2e}")
            problems += [f"use_pallas={use} {shape}: {b}" for b in bad]
    return problems


@phase("4c-2 make_sharded_loss grads on 4 cards vs one card")
def phase_sharded_loss(jax):
    import jax.numpy as jnp
    import numpy as np

    from raytracingengine.inverse import combine, partition
    from raytracingengine.parallel.mesh import make_mesh
    from raytracingengine.parallel.sharded import make_sharded_loss
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.integrator import integrate_chain
    from raytracingengine.geometry.intersect import flatten_scene
    from raytracingengine.scenes.builders import dense_mesh_scene

    scene, cam = dense_mesh_scene(256, 256, spp=1)
    params, static = partition(scene)
    o, d = _bounce0(cam)
    problems = []
    for use in (False, True):
        cfg = RenderConfig(shadow_mode="binary", max_depth=3, use_pallas=use)
        target = jnp.zeros((o.shape[0], 3), o.dtype) + 0.3
        loss4 = make_sharded_loss(static, cfg, make_mesh())

        def loss1(p):
            img = integrate_chain(flatten_scene(combine(p, static)), o, d, cfg)
            return jnp.mean((img - target) ** 2)

        (l4, g4), first, steady = timed(
            jax, jax.jit(jax.value_and_grad(loss4)), params, o, d, target)
        l1, g1 = jax.jit(jax.value_and_grad(loss1))(params)
        ok = all(np.allclose(np.asarray(a), np.asarray(b), rtol=GRAD_RTOL, atol=1e-6)
                 for a, b in zip(jax.tree.leaves(g4), jax.tree.leaves(g1)))
        ok &= bool(np.isclose(float(l4), float(l1), rtol=1e-5))
        log(f"   use_pallas={use}: loss 4 cards {float(l4):.8f} one card "
            f"{float(l1):.8f}; grads match at rtol {GRAD_RTOL}: {ok}; "
            f"compile+run {first:.2f} s, steady {steady:.3f} s")
        if not ok:
            problems.append(f"use_pallas={use}: grads differ")
    return problems


@phase("4c-3 render_hdr(mesh=...) under GSPMD; the Triton kernel under GSPMD")
def phase_gspmd(jax):
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from raytracingengine.geometry import hit_kernel as hk
    from raytracingengine.geometry.intersect import flatten_scene
    from raytracingengine.golden import refdump
    from raytracingengine.parallel.mesh import make_mesh
    from raytracingengine.render.config import RenderConfig
    from raytracingengine.render.pipeline import render_hdr
    from raytracingengine.scenes.builders import dense_mesh_scene

    import __graft_entry__

    scene, cam = dense_mesh_scene(512, 512, spp=1)
    cfg = RenderConfig()
    mesh = make_mesh()
    one = np.asarray(jax.jit(lambda s: render_hdr(s, cam, cfg))(scene))
    img, first, steady = timed(
        jax, jax.jit(lambda s: render_hdr(s, cam, cfg, mesh=mesh)), scene)
    stats = refdump.parity_stats(np.asarray(img), one)
    problems = refdump.parity_failures(stats, MESH_BAD_FRAC)
    log(f"   GSPMD render: compile+run {first:.2f} s, steady {steady:.3f} s; "
        f"bad subpixels vs one card {stats['bad_subpixel_frac']:.2e}")
    __graft_entry__.dryrun_multichip(4)

    # Does GSPMD split the kernel's rays? Compile it on 4-way-sharded rays
    # and read the per-device operand shape of the Triton custom call.
    flat = flatten_scene(scene)
    o, d = _bounce0(cam)
    sh = NamedSharding(mesh, P("rays", None))
    o, d = jax.device_put(o, sh), jax.device_put(d, sh)
    try:
        hlo = jax.jit(lambda o, d: hk.closest_winner(flat, o, d)).lower(o, d) \
            .compile().as_text()
    except Exception as e:  # XLA refusing to partition it is a finding too
        log(f"   the Triton kernel does not compile under GSPMD: {str(e)[:200]}")
    else:
        calls = [ln for ln in hlo.splitlines()
                 if "custom-call" in ln and "triton" in ln.lower()]
        widths = sorted({m for ln in calls for m in re.findall(r"f32\[8,(\d+)\]", ln)})
        log(f"   Triton custom calls under GSPMD: {len(calls)}, ray operand "
            f"widths {widths} (full frame {o.shape[0]}, a quarter "
            f"{o.shape[0] // 4}); all-gathers in the program: "
            f"{hlo.count('all-gather')}")
    try:
        render_hdr(scene, cam, RenderConfig(use_pallas=True), mesh=mesh)
        problems.append("use_pallas under GSPMD did not raise")
    except ValueError as e:
        log(f"   use_pallas under GSPMD raises: {str(e)[:80]}...")
    return problems


def four_cards(jax) -> None:
    if len(jax.devices()) < 4:
        FAILURES.append(f"--four-cards needs 4 devices, have {len(jax.devices())}")
        return
    phase_sharded_render(jax)
    phase_sharded_loss(jax)
    phase_gspmd(jax)


def main(argv: list) -> int:
    four = "--four-cards" in argv
    sys.path.insert(0, REPO)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU, found {dev.platform} ({dev})",
              file=sys.stderr)
        return 1
    from raytracingengine.utils.compile_cache import setup_compile_cache

    log(f"compile cache: {setup_compile_cache()}")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"devices: {len(jax.devices())} x {dev.device_kind}")
    t0 = time.perf_counter()
    (four_cards if four else one_card)(jax)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if FAILURES:
        log(f"FAILED phases: {FAILURES}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
