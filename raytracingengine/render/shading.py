"""Shading: sky, shadow transmittance, direct lighting.

Faithful batched re-derivations of:
  * backgroundColor — vertical sky gradient (Scene.h:30-33),
  * computeTransmittance — the multiplicative-transparency shadow march
    (Scene.h:35-77), re-expressed as a masked `lax.while_loop` over ray
    lanes; every lane steps the march in lockstep and the loop exits as
    soon as all lanes are done,
  * directLightning — per-light diffuse + Blinn-Phong specular with 1/d^2
    falloff (Scene.h:79-129), vectorized over (ray, light) pairs: the
    shadow march runs on the flattened R*L pair batch so all lights of all
    rays march together.

A differentiable soft-visibility path (sigmoid over the segment's closest
approach to each sphere) is provided for inverse rendering; hard mode is
the parity path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracingengine.core import vecmath as vm
from raytracingengine.geometry.intersect import (
    FlatScene,
    Hit,
    any_hit_before,
    closest_hit,
)
from raytracingengine.render.config import RenderConfig


def sky_color(d: jnp.ndarray) -> jnp.ndarray:
    """lerp(white, (0.5,0.7,1.0), 0.5*(dir.y+1)) — Scene.h:30-33."""
    dn = vm.normalize(d)
    t = 0.5 * (dn[..., 1] + 1.0)
    white = jnp.array([1.0, 1.0, 1.0], d.dtype)
    blue = jnp.array([0.5, 0.7, 1.0], d.dtype)
    return white * (1.0 - t)[..., None] + blue * t[..., None]


def transmittance_hard(
    flat: FlatScene,
    origin: jnp.ndarray,  # [B,3]
    direction: jnp.ndarray,  # [B,3]
    max_dist: jnp.ndarray,  # [B]
    active: jnp.ndarray,  # [B] bool — lanes to actually march
    cfg: RenderConfig,
    prim_axis: str | None = None,
) -> jnp.ndarray:
    """computeTransmittance (Scene.h:35-77) for a lane batch -> T [B].

    Per iteration: closest hit from the current origin; no-hit breaks;
    t<=0 micro-steps by bias; t<=bias steps past the surface without
    attenuating; a hit at or beyond max_dist breaks; otherwise
    T *= clamp(transparency, 0, 1) and the march re-biases past the hit.
    Exits when T <= 1e-4, traveled >= max_dist, or 64 iterations.
    """
    bias = cfg.bias
    live0 = active & (max_dist > 0.0)
    init = (
        origin,
        jnp.zeros_like(max_dist),  # traveled
        jnp.ones_like(max_dist),  # T
        live0,
        jnp.int32(0),
    )

    def cond(state):
        _, _, _, live, it = state
        return jnp.any(live) & (it < cfg.shadow_max_steps)

    def body(state):
        o, traveled, T, live, it = state
        hit = closest_hit(flat, o, direction, prim_axis, use_kernel=cfg.use_pallas)
        no_hit = ~hit.valid
        t = jnp.where(hit.valid, hit.t, 0.0)  # keep arithmetic NaN-free
        c_zero = hit.valid & (t <= 0.0)
        c_near = hit.valid & (t > 0.0) & (t <= bias)
        c_beyond = hit.valid & (t > bias) & (traveled + t >= max_dist)
        c_pass = hit.valid & (t > bias) & (traveled + t < max_dist)

        step_len = jnp.where(c_zero, bias, jnp.where(c_near | c_pass, t + bias, 0.0))
        new_o = o + direction * step_len[:, None]
        new_traveled = traveled + step_len
        tr = jnp.clip(hit.transparency, 0.0, 1.0)
        new_T = jnp.where(c_pass, T * tr, T)

        o = jnp.where(live[:, None], new_o, o)
        traveled = jnp.where(live, new_traveled, traveled)
        T = jnp.where(live, new_T, T)
        live = (
            live
            & ~no_hit
            & ~c_beyond
            & (T > cfg.shadow_min_t)
            & (traveled < max_dist)
        )
        return o, traveled, T, live, it + 1

    if cfg.differentiable:
        # Fixed-trip scan: same body, reverse-mode differentiable.
        def scan_body(state, _):
            return body(state), None

        (_, _, T, _, _), _ = jax.lax.scan(
            scan_body, init, None, length=cfg.shadow_max_steps
        )
    else:
        _, _, T, _, _ = jax.lax.while_loop(cond, body, init)
    return jnp.clip(T, 0.0, 1.0)


def transmittance_binary(
    flat: FlatScene,
    origin: jnp.ndarray,  # [B,3]
    direction: jnp.ndarray,  # [B,3]
    max_dist: jnp.ndarray,  # [B]
    cfg: RenderConfig,
    prim_axis: str | None = None,
) -> jnp.ndarray:
    """Hard binary visibility in one pass -> T in {0,1} [B].

    V = 0 iff any surface lies at bias < t < max_dist. For fully opaque
    scenes this equals the reference march (Scene.h:35-77): the march's
    first hit inside (bias, max_dist) multiplies T by clamp(0) = 0, hits
    with t <= bias are stepped past (excluded here by the lower bound),
    and a first hit at t >= max_dist breaks with T = 1. No loop, so it is
    reverse-mode differentiable (with the correct a.e.-zero visibility
    gradient of a hard shadow).
    """
    occluded = any_hit_before(
        flat, origin, direction, max_dist, prim_axis, lo=cfg.bias,
        use_kernel=cfg.use_pallas,
    )
    return jnp.where(occluded, 0.0, 1.0).astype(max_dist.dtype)


def visibility_soft(
    flat: FlatScene,
    origin: jnp.ndarray,  # [B,3]
    direction: jnp.ndarray,  # [B,3] unit
    max_dist: jnp.ndarray,  # [B]
    cfg: RenderConfig,
    prim_axis: str | None = None,
) -> jnp.ndarray:
    """Differentiable visibility in [0,1] -> [B].

    Spheres contribute a smooth factor sigmoid(delta/sigma) where delta is
    the signed clearance of the shadow segment past the sphere surface
    (closest approach along [0, max_dist] minus radius); a blocked sphere
    still transmits its material transparency, so hard mode is recovered
    as sigma -> 0. Planes and triangles use the hard march's binary
    crossing (stop-gradient) — their silhouettes don't move smoothly with
    the parameters we target for inverse rendering (BASELINE config #4).
    """
    sigma = cfg.soft_sigma
    v = jnp.ones_like(max_dist)
    if flat.n_spheres > 0:
        oc = flat.sph_centers[None, :, :] - origin[:, None, :]  # [B,S,3]
        t_close = jnp.clip(
            jnp.sum(oc * direction[:, None, :], axis=-1), 0.0, max_dist[:, None]
        )
        closest = origin[:, None, :] + direction[:, None, :] * t_close[..., None]
        delta = (
            jnp.linalg.norm(closest - flat.sph_centers[None, :, :], axis=-1)
            - flat.sph_radii[None, :]
        )
        soft = jax.nn.sigmoid(delta / sigma)
        tr = jnp.clip(flat.transparency[: flat.n_spheres], 0.0, 1.0)[None, :]
        factor = tr + (1.0 - tr) * soft
        factor = jnp.where(flat.sph_active[None, :], factor, 1.0)
        v = v * jnp.prod(factor, axis=1)
    if flat.n_planes + flat.n_triangles > 0:
        # Hard occlusion from the non-sphere families, no gradient.
        from raytracingengine.geometry.intersect import (
            intersect_planes,
            intersect_triangles,
        )

        t_pl = intersect_planes(flat, origin, direction)
        t_tr = intersect_triangles(flat, origin, direction)
        t_all = jnp.concatenate([t_pl, t_tr], axis=0)  # [P+T, B]
        blocked = jnp.any((t_all > 0.0) & (t_all < max_dist[None, :]), axis=0)
        if prim_axis is not None:
            blocked = jax.lax.pmax(blocked.astype(jnp.int32), prim_axis) > 0
        v = v * jax.lax.stop_gradient(jnp.where(blocked, 0.0, 1.0))
    return v


def direct_light(
    flat: FlatScene,
    hit: Hit,
    view_dir: jnp.ndarray,  # [R,3] (-incoming)
    normal: jnp.ndarray,  # [R,3] front-face-flipped unit normal
    active: jnp.ndarray,  # [R] bool — lanes being shaded
    cfg: RenderConfig,
    prim_axis: str | None = None,
) -> jnp.ndarray:
    """directLightning (Scene.h:79-129) -> [R,3].

    Per light: skip if dist <= 0, N.L <= 0, or dist <= bias; shadow ray
    from point + normal*bias marched to dist - bias; skip if T <= bias;
    diffuse += emitted / d^2 * N.L * T; Blinn-Phong specular (only for
    opaque materials with specular > 0) shares the same falloff and T.
    Result = albedo * sum(diffuse) + sum(spec) * specular.
    """
    bias = cfg.bias
    r = hit.point.shape[0]
    n_l = flat.n_lights
    if n_l == 0:
        return jnp.zeros((r, 3), hit.point.dtype)

    # Static unroll over lights: every intermediate stays [R]-shaped (an
    # [R, L] layout would put the tiny light axis innermost).
    shadow_o = hit.point + normal * bias  # [R,3]
    spec_enabled = (hit.transparency <= 0.0) & (hit.specular > 0.0)  # [R]
    diffuse = jnp.zeros((r, 3), hit.point.dtype)
    spec = jnp.zeros((r, 3), hit.point.dtype)

    for li in range(n_l):
        vec = flat.light_positions[li][None, :] - hit.point  # [R,3]
        # sqrt on the squared distance with the zero case masked: norm's
        # VJP is v/|v|, NaN at v = 0 even under a zero cotangent.
        dist2 = jnp.sum(vec * vec, axis=-1)
        dist_pos = dist2 > 0.0
        dist = jnp.sqrt(jnp.where(dist_pos, dist2, 1.0))
        dist = jnp.where(dist_pos, dist, 0.0)
        dist_safe = jnp.where(dist > 0.0, dist, 1.0)
        ldir = vec / dist_safe[:, None]
        ndotl = jnp.maximum(0.0, vm.dot(normal, ldir))
        ok0 = (
            active
            & flat.light_active[li]
            & (dist > 0.0)
            & (ndotl > 0.0)
            & (dist > bias)
        )

        max_dist = dist - bias
        if cfg.shadow_mode == "soft":
            T = visibility_soft(flat, shadow_o, ldir, max_dist, cfg, prim_axis)
        elif cfg.shadow_mode == "binary":
            T = transmittance_binary(
                flat, shadow_o, ldir, max_dist, cfg, prim_axis
            )
        else:
            T = transmittance_hard(
                flat, shadow_o, ldir, max_dist, ok0, cfg, prim_axis
            )
        ok = ok0 & (T > bias)

        emitted = flat.light_colors[li] * flat.light_intensities[li]  # [3]
        inv_d2 = 1.0 / (dist_safe * dist_safe)
        contrib = (inv_d2 * ndotl * T)[:, None] * emitted[None, :]
        diffuse = diffuse + jnp.where(ok[:, None], contrib, 0.0)

        half = vm.normalize(ldir + view_dir)
        ndoth = jnp.maximum(0.0, vm.dot(normal, half))
        spec_ok = ok & (ndoth > 0.0) & spec_enabled
        ndoth_safe = jnp.where(spec_ok, ndoth, 1.0)  # keep pow-grad NaN-free
        spec_factor = ndoth_safe**hit.shininess
        spec_term = (inv_d2 * spec_factor * T)[:, None] * emitted[None, :]
        spec = spec + jnp.where(spec_ok[:, None], spec_term, 0.0)

    return hit.albedo * diffuse + spec * hit.specular[:, None]
