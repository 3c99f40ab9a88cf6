"""All-pairs ray/primitive intersection and closest-hit selection.

This replaces the reference's per-ray linear scan (Scene::IntersectClosest,
Scene.h:218-257). Instead of branchy per-object tests, a block of R rays
intersects every primitive at once, producing an [N, R] distance matrix
whose column-argmin is the closest hit. `argmin` returns the *first*
minimal index, which reproduces the reference's keep-first-strictly-closer
tie-break exactly, given the same family order (spheres, planes,
triangles/models — Scene.h:221-254).

All ray x primitive coupling terms are [N,3]x[R,3] contractions. For
triangles, Möller–Trumbore (Shape.h:202-220) is rewritten with
scalar-triple-product identities so the per-pair work becomes six
contractions plus an elementwise epilogue:

    a   = e1.(d x e2)            = -(d @ n_geo^T)
    s.h = (o-v0).(d x e2)        =  (o x d) @ e2^T - d @ (e2 x v0)^T
    d.q = d.((o-v0) x e1)        =  d @ (e1 x v0)^T - (o x d) @ e1^T
    e2.q = (o-v0).(e1 x e2)      =  o @ n_geo^T - v0.n_geo

with n_geo = e1 x e2 and all per-triangle constants precomputed once in
`flatten_scene`. With `use_kernel=True`, `closest_hit` and
`any_hit_before` run the same formulas in a Triton kernel that never
writes the pair matrix (geometry/hit_kernel.py). Epsilon semantics follow the reference exactly:
sphere accepts t >= 1e-6 preferring the near root (Shape.h:89-97), plane
requires |denom| > 1e-6 and t >= 0 (Shape.h:149-159), triangle uses
EPSILON = 1e-6 with u in [0,1], v >= 0, u+v <= 1, t > eps (Shape.h:202-220).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from raytracingengine.core import vecmath as vm

#: Matches the reference's intersection epsilons (Shape.h:89, :151, :203).
EPS = 1e-6

# Family codes in the flattened primitive ordering.
FAMILY_NONE = -1
FAMILY_SPHERE = 0
FAMILY_PLANE = 1
FAMILY_TRIANGLE = 2


def _contract(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[N,3] x [R,3] -> [N,R] in full fp32: HIGHEST precision keeps a
    GPU from running the product in TF32 (about three decimal digits)."""
    return jnp.einsum("nc,rc->nr", a, b, precision=jax.lax.Precision.HIGHEST)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "sph_centers",
        "sph_radii",
        "sph_active",
        "pl_points",
        "pl_normals",
        "pl_active",
        "tri_v0",
        "tri_e1",
        "tri_e2",
        "tri_ngeo",
        "tri_nunit",
        "tri_c1",
        "tri_c2",
        "tri_k",
        "tri_active",
        "aux",
        "albedo",
        "shininess",
        "specular",
        "transparency",
        "refractive_index",
        "index",
        "light_positions",
        "light_colors",
        "light_intensities",
        "light_active",
    ],
    meta_fields=["n_spheres", "n_planes", "n_triangles"],
)
@dataclasses.dataclass(frozen=True)
class FlatScene:
    """Render-ready scene: per-family geometry blocks + concatenated
    per-primitive shading attributes in family order (spheres, planes,
    triangles). Produced functionally by `flatten_scene` inside jit so
    gradients flow back to the user-facing Scene pytree."""

    # Spheres
    sph_centers: jnp.ndarray  # [S,3]
    sph_radii: jnp.ndarray  # [S]
    sph_active: jnp.ndarray  # [S] bool
    # Planes
    pl_points: jnp.ndarray  # [P,3]
    pl_normals: jnp.ndarray  # [P,3] unit
    pl_active: jnp.ndarray  # [P] bool
    # Triangles (freestanding + mesh, concatenated)
    tri_v0: jnp.ndarray  # [T,3]
    tri_e1: jnp.ndarray  # [T,3] v1-v0
    tri_e2: jnp.ndarray  # [T,3] v2-v0
    tri_ngeo: jnp.ndarray  # [T,3] e1 x e2 (unnormalized)
    tri_nunit: jnp.ndarray  # [T,3] safe-normalized geometric normal
    tri_c1: jnp.ndarray  # [T,3] e1 x v0
    tri_c2: jnp.ndarray  # [T,3] e2 x v0
    tri_k: jnp.ndarray  # [T]   v0 . n_geo
    tri_active: jnp.ndarray  # [T] bool
    # Per-primitive (N = S+P+T), family order: spheres, planes, triangles
    aux: jnp.ndarray  # [N,3] sphere center / plane unit normal / tri unit normal
    albedo: jnp.ndarray  # [N,3]
    shininess: jnp.ndarray  # [N]
    specular: jnp.ndarray  # [N]
    transparency: jnp.ndarray  # [N]
    refractive_index: jnp.ndarray  # [N]
    index: jnp.ndarray  # [N] int32 family-local index (model id for meshes)
    # Lights
    light_positions: jnp.ndarray  # [L,3]
    light_colors: jnp.ndarray  # [L,3]
    light_intensities: jnp.ndarray  # [L]
    light_active: jnp.ndarray  # [L] bool
    # Static counts
    n_spheres: int
    n_planes: int
    n_triangles: int

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_planes + self.n_triangles

    @property
    def n_lights(self) -> int:
        return self.light_intensities.shape[0]


def flatten_scene(scene) -> FlatScene:
    """Scene (scene.py) -> FlatScene. Pure function; call inside jit."""
    sph, pl, tri, lights = scene.spheres, scene.planes, scene.triangles, scene.lights
    e1 = tri.v1 - tri.v0
    e2 = tri.v2 - tri.v0
    ngeo = vm.cross(e1, e2)
    nunit = vm.normalize(ngeo)
    mats = [sph.materials, pl.materials, tri.materials]
    cat = lambda xs: jnp.concatenate(xs, axis=0)
    aux = cat([sph.centers, pl.normals, nunit])
    s, p, t = len(sph), len(pl), len(tri)
    index = cat(
        [
            jnp.arange(s, dtype=jnp.int32),
            jnp.arange(p, dtype=jnp.int32),
            tri.group.astype(jnp.int32),
        ]
    )
    return FlatScene(
        sph_centers=sph.centers,
        sph_radii=sph.radii,
        sph_active=sph.active,
        pl_points=pl.points,
        pl_normals=pl.normals,
        pl_active=pl.active,
        tri_v0=tri.v0,
        tri_e1=e1,
        tri_e2=e2,
        tri_ngeo=ngeo,
        tri_nunit=nunit,
        tri_c1=vm.cross(e1, tri.v0),
        tri_c2=vm.cross(e2, tri.v0),
        tri_k=vm.dot(tri.v0, ngeo),
        tri_active=tri.active,
        aux=aux,
        albedo=cat([m.color for m in mats]),
        shininess=cat([m.shininess for m in mats]),
        specular=cat([m.specular for m in mats]),
        transparency=cat([m.transparency for m in mats]),
        refractive_index=cat([m.refractive_index for m in mats]),
        index=index,
        light_positions=lights.positions,
        light_colors=lights.colors,
        light_intensities=lights.intensities,
        light_active=lights.active,
        n_spheres=s,
        n_planes=p,
        n_triangles=t,
    )


def intersect_spheres(flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Analytic quadratic test (Shape.h:72-98) for all pairs -> t [S,R],
    +inf on miss. Prefers the near root t0 when t0 >= eps, else t1."""
    if flat.n_spheres == 0:
        return jnp.full((0, o.shape[0]), jnp.inf, o.dtype)
    inf = jnp.asarray(jnp.inf, o.dtype)
    a = vm.dot(d, d)[None, :]  # [1,R] (1.0 for unit dirs; kept general)
    od = vm.dot(o, d)[None, :]
    b = 2.0 * (od - _contract(flat.sph_centers, d))  # 2 (o-c).d
    cc = (
        vm.dot(o, o)[None, :]
        - 2.0 * _contract(flat.sph_centers, o)
        + (vm.dot(flat.sph_centers, flat.sph_centers) - flat.sph_radii**2)[:, None]
    )  # |o-c|^2 - r^2
    disc = b * b - 4.0 * a * cc
    disc_ok = disc >= 0.0
    # sqrt is evaluated on 1.0 in the miss branch: sqrt(max(disc,0)) would
    # backprop inf*0 = NaN through every missing (ray, sphere) pair. The
    # grad-clamped sqrt also keeps tangent rays (disc == 0 exactly, which
    # the hit branch ACCEPTS) from emitting sqrt'(0) = inf.
    sq = vm.sqrt_grad_safe(jnp.where(disc_ok, jnp.maximum(disc, 0.0), 1.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = jnp.where(t0 >= EPS, t0, t1)
    hit = disc_ok & (t >= EPS) & flat.sph_active[:, None]
    return jnp.where(hit, t, inf)


def intersect_planes(flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Point-normal plane test (Shape.h:149-159) -> t [P,R], +inf on miss.
    Requires |d.n| > 1e-6 and t >= 0 (note: >= 0, not >= eps)."""
    if flat.n_planes == 0:
        return jnp.full((0, o.shape[0]), jnp.inf, o.dtype)
    inf = jnp.asarray(jnp.inf, o.dtype)
    denom = _contract(flat.pl_normals, d)  # [P,R]
    pn = vm.dot(flat.pl_points, flat.pl_normals)[:, None]  # p0 . n
    on = _contract(flat.pl_normals, o)
    denom_ok = jnp.abs(denom) > EPS
    safe = jnp.where(denom_ok, denom, 1.0)
    t = (pn - on) / safe
    hit = denom_ok & (t >= 0.0) & flat.pl_active[:, None]
    return jnp.where(hit, t, inf)


def intersect_triangles(flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Möller–Trumbore (Shape.h:202-220) in triple-product/matmul form ->
    t [T,R], +inf on miss."""
    if flat.n_triangles == 0:
        return jnp.full((0, o.shape[0]), jnp.inf, o.dtype)
    inf = jnp.asarray(jnp.inf, o.dtype)
    m = vm.cross(o, d)  # [R,3]
    a = -_contract(flat.tri_ngeo, d)  # e1.(d x e2)
    sh = _contract(flat.tri_e2, m) - _contract(flat.tri_c2, d)  # s.h
    dq = _contract(flat.tri_c1, d) - _contract(flat.tri_e1, m)  # d.q
    tk = _contract(flat.tri_ngeo, o) - flat.tri_k[:, None]  # e2.q
    a_ok = jnp.abs(a) > EPS
    f = 1.0 / jnp.where(a_ok, a, 1.0)
    u = f * sh
    v = f * dq
    t = f * tk
    hit = (
        a_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
        & flat.tri_active[:, None]
    )
    return jnp.where(hit, t, inf)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "t",
        "valid",
        "point",
        "normal",
        "albedo",
        "shininess",
        "specular",
        "transparency",
        "refractive_index",
        "family",
        "index",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Hit:
    """Batched hit record (the reference's HitInfo, Shape.h:28-57).

    `normal` is the *geometric* normal exactly as the reference packs it:
    sphere = normalize(p - center) (Shape.h:100-102), plane = constant
    plane normal, NOT flipped toward the viewer (Shape.h:161-163 — the
    flip happens later in TraceRay, Scene.h:145-146), triangle = local
    edge cross product (Shape.h:222-227).
    On miss lanes: t=+inf, valid=False, other fields are garbage-but-finite.
    """

    t: jnp.ndarray  # [R]
    valid: jnp.ndarray  # [R] bool
    point: jnp.ndarray  # [R,3]
    normal: jnp.ndarray  # [R,3]
    albedo: jnp.ndarray  # [R,3]
    shininess: jnp.ndarray  # [R]
    specular: jnp.ndarray  # [R]
    transparency: jnp.ndarray  # [R]
    refractive_index: jnp.ndarray  # [R]
    family: jnp.ndarray  # [R] int32 (FAMILY_*)
    index: jnp.ndarray  # [R] int32 family-local index / model id


def all_distances(flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """[S+P+T, R] distances, +inf on miss, in the reference's scan order
    (prims on the leading axis, rays on the trailing one)."""
    return jnp.concatenate(
        [
            intersect_spheres(flat, o, d),
            intersect_planes(flat, o, d),
            intersect_triangles(flat, o, d),
        ],
        axis=0,
    )


def closest_index(
    flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """First-wins closest primitive by the all-pairs matrix -> (index [R],
    -1 on miss; t [R], +inf on miss): what the Triton kernel's
    `closest_winner` returns, for checking it."""
    t_all = all_distances(flat, o, d)
    t = jnp.min(t_all, axis=0)
    return jnp.where(jnp.isfinite(t), jnp.argmin(t_all, axis=0), -1), t


def closest_hit(
    flat: FlatScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    prim_axis: str | None = None,
    use_kernel: bool = False,
) -> Hit:
    """Closest hit for a ray block — IntersectClosest (Scene.h:218-257).

    `use_kernel` selects the Triton scan (geometry/hit_kernel.py) over
    the XLA all-pairs matrix; both give the same first-wins winner.

    If `prim_axis` names a mesh axis (inside shard_map), the triangle block
    of `flat` is treated as this device's *shard* of a larger scene:
    each device computes its local closest hit and the winners combine via
    an all_gather + argmin over the axis. Contiguous-block sharding plus
    lowest-device-wins tie-break reproduces the global scan order exactly
    (spheres/planes are replicated; every device agrees on their hits, and
    device order == global triangle order). This is the tensor-parallel
    analog for huge meshes: geometry stays sharded, only the per-ray
    winner (a few floats) crosses the interconnect.
    """
    if use_kernel and flat.n_primitives > 0:
        from raytracingengine.geometry.hit_kernel import closest_winner

        local = hit_from_winner(flat, o, d, *closest_winner(flat, o, d))
    else:
        local = _closest_hit_local(flat, o, d)
    if prim_axis is None:
        return local
    return _combine_hits_over_axis(local, prim_axis)


def _combine_hits_over_axis(hit: Hit, axis: str) -> Hit:
    """all_gather per-device winners along `axis`, argmin by t (first-win
    tie-break = lowest device id = global primitive order)."""
    packed = jnp.concatenate(
        [
            jnp.where(hit.valid, hit.t, jnp.inf)[:, None],
            hit.point,
            hit.normal,
            hit.albedo,
            hit.shininess[:, None],
            hit.specular[:, None],
            hit.transparency[:, None],
            hit.refractive_index[:, None],
            hit.family.astype(hit.t.dtype)[:, None],
            hit.index.astype(hit.t.dtype)[:, None],
        ],
        axis=1,
    )  # [R, 16]
    gathered = jax.lax.all_gather(packed, axis)  # [Ndev, R, 16]
    win = jnp.argmin(gathered[..., 0], axis=0)  # [R]
    r = hit.t.shape[0]
    best = gathered[win, jnp.arange(r)]  # [R, 16]
    t = best[:, 0]
    valid = jnp.isfinite(t)
    return Hit(
        t=t,
        valid=valid,
        point=best[:, 1:4],
        normal=best[:, 4:7],
        albedo=best[:, 7:10],
        shininess=best[:, 10],
        specular=best[:, 11],
        transparency=best[:, 12],
        refractive_index=best[:, 13],
        family=jnp.where(valid, best[:, 14].astype(jnp.int32), FAMILY_NONE),
        index=best[:, 15].astype(jnp.int32),
    )


def _closest_hit_local(flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray) -> Hit:
    r = o.shape[0]
    dtype = o.dtype
    n = flat.n_primitives
    if n == 0:
        z3 = jnp.zeros((r, 3), dtype)
        z1 = jnp.zeros((r,), dtype)
        return Hit(
            t=jnp.full((r,), jnp.inf, dtype),
            valid=jnp.zeros((r,), jnp.bool_),
            point=z3,
            normal=z3,
            albedo=z3,
            shininess=z1,
            specular=z1,
            transparency=z1,
            refractive_index=jnp.ones((r,), dtype),
            family=jnp.full((r,), FAMILY_NONE, jnp.int32),
            index=jnp.zeros((r,), jnp.int32),
        )
    return hit_from_distances(flat, o, d, all_distances(flat, o, d))


def hit_from_distances(
    flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray, t_all: jnp.ndarray
) -> Hit:
    """Hit record from a (possibly caller-masked) [N,R] distance matrix.

    Exposed so callers can exclude primitives per ray (e.g. the soft
    silhouette compositor masks the silhouette sphere's row to get the
    true background hit, render/soft_primary.py)."""
    j = jnp.argmin(t_all, axis=0)  # first-minimum == reference tie-break
    t = jnp.take_along_axis(t_all, j[None, :], axis=0)[0]
    return _hit_record(flat, o, d, j, t, jnp.isfinite(t))


def winner_distance(
    flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray, j: jnp.ndarray
) -> jnp.ndarray:
    """Unmasked hit distance of each ray's primitive `j` [R] -> t [R].

    The same formulas as intersect_* on one gathered primitive per ray,
    without the accept tests (the caller already knows the winner hits).
    Differentiable in every scene parameter and in the rays."""
    s, p, n_t = flat.n_spheres, flat.n_planes, flat.n_triangles
    dot = vm.dot
    t = jnp.zeros(o.shape[:1], o.dtype)
    if s:
        k = jnp.clip(j, 0, s - 1)
        c, rad = flat.sph_centers[k], flat.sph_radii[k]
        a = dot(d, d)
        b = 2.0 * (dot(o, d) - dot(c, d))
        cc = dot(o, o) - 2.0 * dot(c, o) + (dot(c, c) - rad**2)
        disc = b * b - 4.0 * a * cc
        sq = vm.sqrt_grad_safe(jnp.where(disc >= 0.0, jnp.maximum(disc, 0.0), 1.0))
        t0 = (-b - sq) * (0.5 / a)
        t1 = (-b + sq) * (0.5 / a)
        t = jnp.where(j < s, jnp.where(t0 >= EPS, t0, t1), t)
    if p:
        k = jnp.clip(j - s, 0, p - 1)
        n = flat.pl_normals[k]
        denom = dot(n, d)
        safe = jnp.where(jnp.abs(denom) > EPS, denom, 1.0)
        t_pl = (dot(flat.pl_points[k], n) - dot(n, o)) / safe
        t = jnp.where((j >= s) & (j < s + p), t_pl, t)
    if n_t:
        k = jnp.clip(j - s - p, 0, n_t - 1)
        a = -dot(flat.tri_ngeo[k], d)
        safe = jnp.where(jnp.abs(a) > EPS, a, 1.0)
        t_tri = (dot(flat.tri_ngeo[k], o) - flat.tri_k[k]) / safe
        t = jnp.where(j >= s + p, t_tri, t)
    return t


def hit_from_winner(
    flat: FlatScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    j: jnp.ndarray,
    t_kernel: jnp.ndarray,
) -> Hit:
    """Hit record from a kernel's winner index `j` [R] (-1 on miss) and
    its distance `t_kernel` [R].

    The value of t is the kernel's, so it agrees with the kernel's choice
    of winner; its derivative is that of `winner_distance`, the plain-JAX
    recompute of the winner's hit (straight-through). This is the
    gradient rule of the XLA path restricted to the winning primitive."""
    valid = j >= 0
    jj = jnp.where(valid, j, 0)
    t_rec = jnp.where(valid, winner_distance(flat, o, d, jj), 0.0)
    t_k = jax.lax.stop_gradient(jnp.where(valid, t_kernel, 0.0))
    t = t_k + (t_rec - jax.lax.stop_gradient(t_rec))
    return _hit_record(flat, o, d, jj, jnp.where(valid, t, jnp.inf), valid)


def _hit_record(flat, o, d, j, t, valid) -> Hit:
    s, p = flat.n_spheres, flat.n_planes
    family = jnp.where(
        j < s, FAMILY_SPHERE, jnp.where(j < s + p, FAMILY_PLANE, FAMILY_TRIANGLE)
    ).astype(jnp.int32)
    family = jnp.where(valid, family, FAMILY_NONE)

    t_safe = jnp.where(valid, t, 0.0)
    point = o + d * t_safe[:, None]

    aux = flat.aux[j]  # center / plane normal / tri normal
    n_sphere = vm.normalize(point - aux)
    normal = jnp.where((family == FAMILY_SPHERE)[:, None], n_sphere, aux)

    return Hit(
        t=t,
        valid=valid,
        point=point,
        normal=normal,
        albedo=flat.albedo[j],
        shininess=flat.shininess[j],
        specular=flat.specular[j],
        transparency=flat.transparency[j],
        refractive_index=flat.refractive_index[j],
        family=family,
        index=flat.index[j],
    )


def any_hit_before(
    flat: FlatScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    max_dist: jnp.ndarray,
    prim_axis: str | None = None,
    lo: float = 0.0,
    use_kernel: bool = False,
) -> jnp.ndarray:
    """Binary occlusion: any primitive with lo < t < max_dist [R] -> bool [R].

    Semantics of the reference's (dead-at-HEAD) Scene::IntersectAnyBefore
    (Scene.h:259-276) with lo = 0; kept as a first-class capability for
    hard-shadow mode and binary visibility AOVs. `use_kernel` selects the
    Triton scan, which stops once every ray of its block is occluded.
    With `prim_axis`, ORs the per-shard verdicts across the mesh axis.
    """
    if use_kernel and flat.n_primitives > 0:
        from raytracingengine.geometry.hit_kernel import any_hit

        occluded = any_hit(flat, o, d, max_dist, lo=lo)
    else:
        t_all = all_distances(flat, o, d)
        occluded = jnp.any((t_all > lo) & (t_all < max_dist[None, :]), axis=0)
    if prim_axis is not None:
        occluded = jax.lax.pmax(occluded.astype(jnp.int32), prim_axis) > 0
    return occluded
