"""Whitted integrator: recursion re-expressed as masked wavefronts.

The reference TraceRay (Scene.h:131-198) is a depth-<=10 recursion that at
each hit adds the local direct lighting weighted by (1 - transparency),
then recurses into a refraction ray weighted transparency*(1-F) and a
reflection ray weighted F (transparent) or material.specular (opaque),
with Schlick Fresnel F and TIR forcing F=1 (Scene.h:161-195). Misses and
depth exhaustion return the sky gradient.

Since radiance is *linear* in the child contributions, the recursion tree
flattens into a sum over nodes of (path weight x local term). Two
executions of that sum are provided:

  * `integrate_chain` — for scenes with no transparency the tree is a pure
    reflection chain (at most one child per node), so a `lax.scan` over
    depth carries (ray, weight, live) per lane. This is the benchmark path.

  * `integrate_wavefront` — the general case: a per-lane LIFO ray stack
    (capacity max_depth+2, the exact DFS bound for a binary tree) stepped
    by a `lax.while_loop`; each iteration pops one node per lane,
    accumulates weight*local, and pushes up to two children. The loop ends
    when every lane's stack is empty, so opaque regions cost chain-like
    iteration counts even inside a transparent scene.

Both produce exactly the reference's weighting, including: clamped
transparency, eta = etaI/etaT vs etaT/etaI by face side (Scene.h:176),
refraction origin biased by bias*1e2 (Scene.h:180), reflection origin
biased by bias (Scene.h:191), and reflection spawned only when
reflectiveness > bias (Scene.h:189).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracingengine.core import vecmath as vm
from raytracingengine.geometry.intersect import FlatScene, closest_hit
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.shading import direct_light, sky_color


def _shade_node(flat, o, d, active, cfg, prim_axis=None):
    """Shared per-node work: intersect + classify + local light + child rays.

    Returns a dict of per-lane tensors; callers combine them per-integrator.
    """
    hit = closest_hit(flat, o, d, prim_axis, use_kernel=cfg.use_pallas)
    return _shade_from_hit(flat, hit, d, active, cfg, prim_axis)


def _shade_from_hit(flat, hit, d, active, cfg, prim_axis=None):
    """Shading/child-ray computation for an already-computed hit record."""
    miss = active & ~hit.valid
    shade = active & hit.valid

    incoming = d  # unit by construction (camera + normalized child dirs)
    front = vm.dot(hit.normal, incoming) < 0.0
    normal = jnp.where(front[:, None], hit.normal, -hit.normal)
    view = -incoming
    cos_theta = jnp.maximum(0.0, vm.dot(normal, view))

    eta_t = hit.refractive_index
    f0 = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
    fresnel = f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5
    tau = jnp.clip(hit.transparency, 0.0, 1.0)

    local = direct_light(flat, hit, view, normal, shade, cfg, prim_axis)
    local_term = local * (1.0 - tau)[:, None]  # Scene.h:171-173

    # Refraction child (Scene.h:175-187)
    eta = jnp.where(front, 1.0 / eta_t, eta_t)
    refr_raw = vm.refract(incoming, normal, eta)
    refr_len = vm.length(refr_raw)
    wants_refr = shade & (tau > 0.0)
    has_refr = wants_refr & (refr_len > cfg.bias)
    tir = wants_refr & (refr_len <= cfg.bias)
    fresnel_eff = jnp.where(tir, 1.0, fresnel)  # TIR forces F=1 (Scene.h:185)
    refr_dir = vm.normalize(refr_raw)
    refr_o = hit.point + refr_dir * (cfg.bias * 1e2)
    refr_w = tau * (1.0 - fresnel)  # pre-TIR F (Scene.h:182)

    # Reflection child (Scene.h:189-195)
    reflectiveness = jnp.where(tau > 0.0, fresnel_eff, hit.specular)
    has_refl = shade & (reflectiveness > cfg.bias)
    refl_dir = vm.normalize(vm.reflect(incoming, normal))
    refl_o = hit.point + refl_dir * cfg.bias

    return dict(
        hit=hit,
        miss=miss,
        shade=shade,
        local_term=local_term,
        has_refr=has_refr,
        refr_o=refr_o,
        refr_dir=refr_dir,
        refr_w=refr_w,
        has_refl=has_refl,
        refl_o=refl_o,
        refl_dir=refl_dir,
        refl_w=reflectiveness,
    )


def integrate_chain(
    flat: FlatScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    cfg: RenderConfig,
    prim_axis: str | None = None,
) -> jnp.ndarray:
    """Opaque-scene integrator: the recursion is a reflection chain.

    Requires all transparencies == 0 (guaranteed when the scene was built
    with has_transparency=False); then the refraction branch never spawns
    and the per-node weight update is weight *= specular.
    """
    r = o.shape[0]
    dtype = o.dtype
    accum0 = jnp.zeros((r, 3), dtype)
    w0 = jnp.ones((r,), dtype)
    live0 = jnp.ones((r,), jnp.bool_)
    return _chain_scan(
        flat, o, d, w0, live0, accum0, 0, cfg, prim_axis
    )


def _chain_scan(flat, o, d, w0, live0, accum0, start_depth, cfg, prim_axis):
    """The reflection-chain depth scan from an arbitrary starting state."""

    def body(carry, depth):
        o_c, d_c, w, live, accum = carry
        at_max = depth >= cfg.max_depth  # depth-exceeded -> sky (Scene.h:132-134)
        sky = sky_color(d_c)
        if_max_sky = live & at_max
        node_active = live & ~at_max

        nd = _shade_node(flat, o_c, d_c, node_active, cfg, prim_axis)
        sky_lanes = if_max_sky | nd["miss"]
        accum = accum + jnp.where(sky_lanes[:, None], w[:, None] * sky, 0.0)
        accum = accum + jnp.where(
            nd["shade"][:, None], w[:, None] * nd["local_term"], 0.0
        )

        # Weight-pruned chains (RenderConfig.min_weight).
        cont = nd["has_refl"] & (w * nd["refl_w"] >= cfg.min_weight)
        o_n = jnp.where(cont[:, None], nd["refl_o"], o_c)
        d_n = jnp.where(cont[:, None], nd["refl_dir"], d_c)
        w_n = jnp.where(cont, w * nd["refl_w"], w)
        return (o_n, d_n, w_n, cont, accum), None

    (_, _, _, _, accum), _ = jax.lax.scan(
        body,
        (o, d, w0, live0, accum0),
        jnp.arange(start_depth, cfg.max_depth + 1),
    )
    return accum


def integrate_wavefront(
    flat: FlatScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    cfg: RenderConfig,
    prim_axis: str | None = None,
) -> jnp.ndarray:
    """General integrator: per-lane DFS over the binary recursion tree."""
    r = o.shape[0]
    dtype = o.dtype
    cap = cfg.max_depth + 2  # DFS stack bound: net +1 per level
    ar = jnp.arange(r)

    stack_o = jnp.zeros((r, cap, 3), dtype)
    stack_d = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype), (r, cap, 3)
    )  # benign unit dir in unused slots
    stack_w = jnp.zeros((r, cap), dtype)
    stack_depth = jnp.zeros((r, cap), jnp.int32)

    stack_o = stack_o.at[:, 0].set(o)
    stack_d = stack_d.at[:, 0].set(d)
    stack_w = stack_w.at[:, 0].set(1.0)
    sp0 = jnp.ones((r,), jnp.int32)
    accum0 = jnp.zeros((r, 3), dtype)

    def push(stacks, sp, mask, o_new, d_new, w_new, depth_new):
        s_o, s_d, s_w, s_dep = stacks
        slot = jnp.clip(sp, 0, cap - 1)
        s_o = s_o.at[ar, slot].set(
            jnp.where(mask[:, None], o_new, s_o[ar, slot])
        )
        s_d = s_d.at[ar, slot].set(
            jnp.where(mask[:, None], d_new, s_d[ar, slot])
        )
        s_w = s_w.at[ar, slot].set(jnp.where(mask, w_new, s_w[ar, slot]))
        s_dep = s_dep.at[ar, slot].set(
            jnp.where(mask, depth_new, s_dep[ar, slot])
        )
        return (s_o, s_d, s_w, s_dep), sp + mask.astype(jnp.int32)

    def cond(state):
        _, sp, _, it = state
        return jnp.any(sp > 0) & (it < cfg.budget())

    def body(state):
        stacks, sp, accum, it = state
        s_o, s_d, s_w, s_dep = stacks
        live = sp > 0
        top = jnp.clip(sp - 1, 0, cap - 1)
        o_c = s_o[ar, top]
        d_c = s_d[ar, top]
        w = s_w[ar, top]
        depth = s_dep[ar, top]
        sp = sp - live.astype(jnp.int32)

        at_max = depth >= cfg.max_depth
        if_max_sky = live & at_max
        node_active = live & ~at_max
        nd = _shade_node(flat, o_c, d_c, node_active, cfg, prim_axis)

        sky = sky_color(d_c)
        sky_lanes = if_max_sky | nd["miss"]
        accum = accum + jnp.where(sky_lanes[:, None], w[:, None] * sky, 0.0)
        accum = accum + jnp.where(
            nd["shade"][:, None], w[:, None] * nd["local_term"], 0.0
        )

        # Push reflection first, refraction second: the LIFO pop order then
        # matches the reference's refraction-before-reflection DFS.
        # Children whose path weight falls below min_weight are pruned
        # (same bound as the chain integrator).
        stacks, sp = push(
            (s_o, s_d, s_w, s_dep),
            sp,
            nd["has_refl"] & (w * nd["refl_w"] >= cfg.min_weight),
            nd["refl_o"],
            nd["refl_dir"],
            w * nd["refl_w"],
            depth + 1,
        )
        stacks, sp = push(
            stacks,
            sp,
            nd["has_refr"] & (w * nd["refr_w"] >= cfg.min_weight),
            nd["refr_o"],
            nd["refr_dir"],
            w * nd["refr_w"],
            depth + 1,
        )
        return stacks, sp, accum, it + 1

    init = ((stack_o, stack_d, stack_w, stack_depth), sp0, accum0, jnp.int32(0))
    if cfg.differentiable:
        # Fixed-trip scan (set cfg.wavefront_budget to a sane bound for
        # training; the full-binary-tree default would be enormous).
        def scan_body(state, _):
            return body(state), None

        (_, _, accum, _), _ = jax.lax.scan(
            scan_body, init, None, length=cfg.budget()
        )
    else:
        _, _, accum, _ = jax.lax.while_loop(cond, body, init)
    return accum
