"""Closest-hit and any-hit scans as one Pallas kernel through Triton.

The XLA path (`intersect.all_distances`) writes a [prims, rays] fp32
matrix to device memory for every field of every intersection test, and
reads it back for the argmin. Here each program owns one block of
`block_rays` rays, loops over blocks of `block_prims` primitives of each
family in the reference's scan order (spheres, planes, triangles —
Scene.h:221-254), and keeps a running `(t, index)` in registers, updated
with a strict `<` so the first index wins ties exactly as the reference's
linear scan does. No pair matrix is ever written.

The kernels return only the winner (index and `t`) or the occlusion bit.
`intersect.hit_from_winner` rebuilds the hit record from the gathered
primitive in plain JAX, so gradients come from XLA autodiff of that
recompute; the kernel's inputs are `stop_gradient`-ed and Pallas never
differentiates its body.

Primitive tables are structure-of-arrays, padded to `block_prims`
multiples with primitives that can never be hit: a sphere with centre 0
and r^2 = -1 (its discriminant is negative for every ray), a plane with
normal 0 and a triangle with geometric normal 0 (both fail the 1e-6
denominator test). Inactive primitives use the same encodings, so there
is no cap on scene size and no applicability gate.

The compiled kernel runs on a CUDA GPU only. Elsewhere a call raises,
unless `interpret_mode()` is active, which runs the same kernel body
through the Pallas interpreter (how the CPU tests reach it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracingengine.geometry.intersect import EPS, FlatScene

# Launch shape, tuned on an H100 over 16,384-ray chunks of the 6,016- and
# 50,800-triangle meshes (profiling/kernel_decision.py tune; PERF.md).
#: Rays per program (a power of two).
BLOCK_RAYS = 128
#: Primitives per loop step (a power of two).
BLOCK_PRIMS = 4
#: Warps per program.
NUM_WARPS = 4
#: Software-pipelining stages of the primitive loop.
NUM_STAGES = 2
#: Target number of programs per launch (the card has 132 SMs).
PROGRAMS = 2048

_interpret = False


@contextlib.contextmanager
def interpret_mode():
    """Run the kernels through the Pallas interpreter on any backend."""
    global _interpret
    prev, _interpret = _interpret, True
    try:
        yield
    finally:
        _interpret = prev


def _use_interpreter() -> bool:
    if jax.default_backend() == "gpu":
        return False
    if _interpret:
        return True
    raise RuntimeError(
        "use_pallas=True runs the Triton intersection kernel, which needs a "
        f"CUDA GPU; the default backend is {jax.default_backend()!r}. Set "
        "use_pallas=False for the XLA path."
    )


def pack_tables(flat: FlatScene, block_prims: int = BLOCK_PRIMS):
    """-> (sph [4,S'], pl [4,P'], tri [16,T']) never-hit padded tables."""
    f = jax.lax.stop_gradient

    def dot(a, b):
        return jnp.sum(a * b, axis=-1)

    def padded(rows, n):
        tab = jnp.concatenate(rows, axis=0)
        width = max(1, -(-n // block_prims)) * block_prims
        return jnp.pad(tab, ((0, 0), (0, width - n)))

    s, on = flat.n_spheres, flat.sph_active
    c = jnp.where(on[:, None], f(flat.sph_centers), 0.0)
    k = jnp.where(on, dot(c, c) - f(flat.sph_radii) ** 2, 1.0)
    sph = padded([c.T, k[None]], s).at[3, s:].set(1.0)  # centre 0, r^2 = -1

    n = jnp.where(flat.pl_active[:, None], f(flat.pl_normals), 0.0)
    pln = padded([n.T, dot(f(flat.pl_points), n)[None]], flat.n_planes)

    on = flat.tri_active
    rows = [jnp.where(on[:, None], f(x), 0.0).T
            for x in (flat.tri_ngeo, flat.tri_e1, flat.tri_e2, flat.tri_c1,
                      flat.tri_c2)]
    tk = jnp.where(on, f(flat.tri_k), 0.0)
    return sph, pln, padded(rows + [tk[None]], flat.n_triangles)


def pack_rays(o, d, max_dist=None, block_rays: int = BLOCK_RAYS):
    """-> [8, R'] rows ox oy oz dx dy dz max_dist 0, R' a block multiple."""
    r = o.shape[0]
    width = -(-r // block_rays) * block_rays
    md = jnp.zeros((r,), o.dtype) if max_dist is None else max_dist
    rows = jnp.concatenate(
        [o.T, d.T, md[None].astype(o.dtype), jnp.zeros((1, r), o.dtype)], axis=0
    )
    rows = jax.lax.stop_gradient(rows)
    # Padded rays point along +z from the origin; their results are cut off.
    pad = jnp.zeros((8, width - r), o.dtype).at[5].set(1.0)
    return jnp.concatenate([rows, pad], axis=1)


# ---------------------------------------------------------------------------
# Per-family distance tiles [block_prims, block_rays], +inf on miss. Same
# formulas as intersect.intersect_* (Shape.h:72-98, :149-159, :202-220).


def _sphere_t(tab, i, bp, ray):
    ox, oy, oz, dx, dy, dz = ray
    cols = pl.ds(i * bp, bp)
    cx, cy, cz, k = (plgpu.load(tab.at[f, cols])[:, None] for f in range(4))
    a = dx * dx + dy * dy + dz * dz
    od = ox * dx + oy * dy + oz * dz
    b = 2.0 * (od - (cx * dx + cy * dy + cz * dz))
    cc = (ox * ox + oy * oy + oz * oz) - 2.0 * (cx * ox + cy * oy + cz * oz) + k
    disc = b * b - 4.0 * a * cc
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = jnp.where(t0 >= EPS, t0, t1)
    return jnp.where(ok & (t >= EPS), t, jnp.inf)


def _plane_t(tab, i, bp, ray):
    ox, oy, oz, dx, dy, dz = ray
    cols = pl.ds(i * bp, bp)
    nx, ny, nz, pn = (plgpu.load(tab.at[f, cols])[:, None] for f in range(4))
    denom = nx * dx + ny * dy + nz * dz
    on = nx * ox + ny * oy + nz * oz
    ok = jnp.abs(denom) > EPS
    t = (pn - on) / jnp.where(ok, denom, 1.0)
    return jnp.where(ok & (t >= 0.0), t, jnp.inf)


def _triangle_t(tab, i, bp, ray):
    ox, oy, oz, dx, dy, dz = ray
    cols = pl.ds(i * bp, bp)
    (gx, gy, gz, e1x, e1y, e1z, e2x, e2y, e2z,
     c1x, c1y, c1z, c2x, c2y, c2z, k) = (
        plgpu.load(tab.at[f, cols])[:, None] for f in range(16)
    )
    mx = oy * dz - oz * dy  # m = o x d
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    a = -(gx * dx + gy * dy + gz * dz)
    sh = (e2x * mx + e2y * my + e2z * mz) - (c2x * dx + c2y * dy + c2z * dz)
    dq = (c1x * dx + c1y * dy + c1z * dz) - (e1x * mx + e1y * my + e1z * mz)
    tk = (gx * ox + gy * oy + gz * oz) - k
    ok = jnp.abs(a) > EPS
    f = 1.0 / jnp.where(ok, a, 1.0)
    u = f * sh
    v = f * dq
    t = f * tk
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return jnp.where(hit, t, jnp.inf)


_FAMILIES = (_sphere_t, _plane_t, _triangle_t)


def _load_rays(rays_ref, br, with_max=False):
    cols = pl.ds(pl.program_id(0) * br, br)
    n = 7 if with_max else 6
    return tuple(plgpu.load(rays_ref.at[f, cols])[None, :] for f in range(n))


def _block_range(nb: int, n_split: int):
    """This program's share [lo, hi) of a family's nb primitive blocks."""
    per = -(-nb // n_split)
    lo = jnp.minimum(pl.program_id(1) * per, nb)
    return lo, jnp.minimum(lo + per, nb)


def _closest_kernel(rays_ref, sph_ref, pl_ref, tri_ref, t_ref, j_ref, *,
                    bp, br, n_blocks, bases, n_split):
    ray = _load_rays(rays_ref, br)
    t_best = jnp.full((br,), jnp.inf, jnp.float32)
    j_best = jnp.full((br,), -1, jnp.int32)
    for fam, tab, nb, base in zip(_FAMILIES, (sph_ref, pl_ref, tri_ref),
                                  n_blocks, bases):
        if nb == 0:
            continue

        def body(i, carry, fam=fam, tab=tab, base=base):
            tb, jb = carry
            t = fam(tab, i, bp, ray)
            tmin = jnp.min(t, axis=0)
            jmin = jnp.argmin(t, axis=0).astype(jnp.int32) + (base + i * bp)
            better = tmin < tb  # strict: the earlier primitive keeps ties
            return jnp.where(better, tmin, tb), jnp.where(better, jmin, jb)

        lo, hi = _block_range(nb, n_split)
        t_best, j_best = jax.lax.fori_loop(lo, hi, body, (t_best, j_best))
    cols = pl.ds(pl.program_id(0) * br, br)
    plgpu.store(t_ref.at[pl.program_id(1), cols], t_best)
    plgpu.store(j_ref.at[pl.program_id(1), cols], j_best)


def _any_kernel(rays_ref, sph_ref, pl_ref, tri_ref, occ_ref, *,
                bp, br, n_blocks, lo_t, n_split):
    ray = _load_rays(rays_ref, br, with_max=True)
    max_dist = ray[6]
    occ = jnp.zeros((br,), jnp.int32)
    for fam, tab, nb in zip(_FAMILIES, (sph_ref, pl_ref, tri_ref), n_blocks):
        if nb == 0:
            continue
        lo, hi = _block_range(nb, n_split)

        def cond(carry, hi=hi):
            i, oc = carry
            return (i < hi) & (jnp.min(oc) == 0)  # stop once all are occluded

        def body(carry, fam=fam, tab=tab):
            i, oc = carry
            t = fam(tab, i, bp, ray[:6])
            blocked = (t > lo_t) & (t < max_dist)
            return i + 1, jnp.maximum(oc, jnp.max(blocked.astype(jnp.int32), axis=0))

        _, occ = jax.lax.while_loop(cond, body, (lo, occ))
    cols = pl.ds(pl.program_id(0) * br, br)
    plgpu.store(occ_ref.at[pl.program_id(1), cols], occ)


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Launch shape. Programs form a (ray blocks, primitive splits) grid:
    each split scans its share of every family's blocks, and XLA combines
    the splits' winners. Splitting fills the card when a chunk has few
    ray blocks but the scene has many primitive blocks."""

    block_prims: int = BLOCK_PRIMS
    block_rays: int = BLOCK_RAYS
    num_warps: int = NUM_WARPS
    num_stages: int = NUM_STAGES
    #: Aim for about this many programs, splitting primitives to get there.
    programs: int = PROGRAMS


def _launch(kernel, out_dtypes, rays, flat, tiling: Tiling, name, **kw):
    bp, br = tiling.block_prims, tiling.block_rays
    tabs = pack_tables(flat, bp)
    counts = (flat.n_spheres, flat.n_planes, flat.n_triangles)
    n_blocks = tuple(-(-n // bp) for n in counts)
    n_ray_blocks = rays.shape[1] // br
    n_split = max(1, min(max(n_blocks), -(-tiling.programs // n_ray_blocks)))
    shape = (n_split, rays.shape[1])
    return pl.pallas_call(
        functools.partial(kernel, bp=bp, br=br, n_blocks=n_blocks,
                          n_split=n_split, **kw),
        out_shape=[jax.ShapeDtypeStruct(shape, dt) for dt in out_dtypes],
        grid=(n_ray_blocks, n_split),
        compiler_params=plgpu.CompilerParams(
            num_warps=tiling.num_warps, num_stages=tiling.num_stages),
        interpret=_use_interpreter(),
        name=name,
    )(rays, *tabs)


def closest_winner(flat: FlatScene, o, d, tiling: Tiling = Tiling()):
    """First-wins closest hit -> (index [R] int32, -1 on miss; t [R], +inf
    on miss). Indices are in FlatScene's family order."""
    r = o.shape[0]
    rays = pack_rays(o, d, block_rays=tiling.block_rays)
    bases = (0, flat.n_spheres, flat.n_spheres + flat.n_planes)
    t, j = _launch(_closest_kernel, (o.dtype, jnp.int32), rays, flat, tiling,
                   "closest_hit", bases=bases)
    # Each split holds the lexicographic (t, index) minimum of its range;
    # that of the splits' minima is the first-wins winner of the scene.
    t_min = jnp.min(t, axis=0)
    big = jnp.iinfo(jnp.int32).max
    j_min = jnp.min(jnp.where((t == t_min) & (j >= 0), j, big), axis=0)
    j_min = jnp.where(j_min == big, -1, j_min)
    return j_min[:r], t_min[:r]


def any_hit(flat: FlatScene, o, d, max_dist, lo: float = 0.0,
            tiling: Tiling = Tiling()):
    """Occlusion -> bool [R]: some primitive has lo < t < max_dist."""
    r = o.shape[0]
    rays = pack_rays(o, d, max_dist, block_rays=tiling.block_rays)
    (occ,) = _launch(_any_kernel, (jnp.int32,), rays, flat, tiling,
                     "any_hit", lo_t=float(lo))
    return jnp.max(occ, axis=0)[:r] > 0
