"""Soft primary visibility: differentiable sphere silhouettes.

Hard closest-hit gives pixel colors that are piecewise-constant in
geometry across silhouette edges — interior shading gradients exist (and
match finite differences), but the *silhouette mismatch* term of an image
loss has zero gradient, so center/radius recovery stalls. This module
adds a SoftRas-style edge relaxation for the primary bounce, as proper
TWO-LAYER compositing:

  * per sphere, the ray's signed silhouette clearance
        delta_i = |closest_approach - c_i| - r_i
    is smooth in (c_i, r_i); the nearest-silhouette sphere j defines the
    FRONT layer with coverage = sigmoid(-delta_j / sigma),
  * the BACK layer is the true background: the closest hit with sphere
    j's distance row masked out (geometry/intersect.hit_from_distances),
    falling back to the sky on total miss — NOT sky unconditionally;
    blending against sky where a wall or floor sits behind the sphere
    biases every gradient at sphere-over-geometry edges,
  * the front layer only composites where it is actually in front:
    coverage is gated to 0 when the background surface is closer than
    the sphere layer (a sphere behind a wall casts no silhouette),
  * pixel = cov * shade(front) + (1 - cov) * shade(back), and the
    reflection chain continues from BOTH layers with weights cov and
    (1 - cov) respectively.

sigma -> 0 recovers the hard renderer. Secondary bounces stay hard: the
edge term that matters for inverse rendering is the primary silhouette.
Spheres only (the BASELINE config #4 target set); plane/triangle
silhouettes stay hard.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracingengine.core import vecmath as vm
from raytracingengine.geometry.intersect import (
    FAMILY_SPHERE,
    FlatScene,
    Hit,
    all_distances,
    closest_hit,
    hit_from_distances,
)
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.integrator import _chain_scan, _shade_from_hit
from raytracingengine.render.shading import sky_color


def soft_primary_layers(
    flat: FlatScene, o: jnp.ndarray, d: jnp.ndarray, cfg: RenderConfig
) -> tuple[Hit, Hit, jnp.ndarray]:
    """-> (front hit, background hit, coverage [R]).

    Front: the nearest-silhouette sphere j — the hard hit where the ray
    really intersects it, else a pseudo-hit at the sphere point nearest
    the ray (true normal + material), so the blend is meaningful just
    outside the edge too. Background: closest hit with sphere j excluded.
    Coverage: sigmoid silhouette, gated to 0 where the background is in
    front of the sphere layer.
    """
    r = o.shape[0]
    sigma = cfg.soft_sigma
    t_all = all_distances(flat, o, d)  # [N,R]
    hit = hit_from_distances(flat, o, d, t_all)

    if flat.n_spheres == 0:
        return hit, hit, hit.valid.astype(o.dtype)

    # Signed clearance per sphere: [S, R].
    oc = flat.sph_centers[:, None, :] - o[None, :, :]  # [S,R,3]
    t_c = jnp.maximum(jnp.sum(oc * d[None, :, :], axis=-1), 0.0)  # [S,R]
    closest = o[None, :, :] + d[None, :, :] * t_c[..., None]  # [S,R,3]
    cc = closest - flat.sph_centers[:, None, :]
    cc2 = jnp.sum(cc * cc, axis=-1)
    dist_c = jnp.sqrt(jnp.maximum(cc2, 1e-20))
    delta = dist_c - flat.sph_radii[:, None]  # [S,R]
    delta = jnp.where(flat.sph_active[:, None], delta, jnp.inf)

    j = jnp.argmin(delta, axis=0)  # nearest-silhouette sphere per ray
    ar = jnp.arange(r)
    delta_min = delta[j, ar]
    delta_min = jnp.where(jnp.isfinite(delta_min), delta_min, 1e6)

    # Background: the scene without sphere j (spheres lead the flat
    # primitive order, so global row index == j).
    row = jax.lax.broadcasted_iota(jnp.int32, t_all.shape, 0)
    t_bg = jnp.where(row == j[None, :], jnp.inf, t_all)
    bg = hit_from_distances(flat, o, d, t_bg)

    # Front layer: hard sphere-j hit where it exists, else pseudo-hit.
    c_j = flat.sph_centers[j]
    r_j = flat.sph_radii[j]
    n_pseudo = vm.normalize(closest[j, ar] - c_j)
    p_pseudo = c_j + n_pseudo * r_j[:, None]
    t_pseudo = t_c[j, ar]

    hit_is_j = hit.valid & (hit.family == FAMILY_SPHERE) & (hit.index == j)
    use_pseudo = ~hit_is_j

    def fill(field_hit, field_pseudo):
        mask = use_pseudo
        if field_hit.ndim == 2:
            mask = mask[:, None]
        return jnp.where(mask, field_pseudo, field_hit)

    front = Hit(
        t=fill(hit.t, t_pseudo),
        valid=jnp.ones((r,), jnp.bool_),
        point=fill(hit.point, p_pseudo),
        normal=fill(hit.normal, n_pseudo),
        albedo=fill(hit.albedo, flat.albedo[j]),
        shininess=fill(hit.shininess, flat.shininess[j]),
        specular=fill(hit.specular, flat.specular[j]),
        transparency=fill(hit.transparency, flat.transparency[j]),
        refractive_index=fill(hit.refractive_index, flat.refractive_index[j]),
        family=jnp.full((r,), FAMILY_SPHERE, jnp.int32),
        index=j.astype(jnp.int32),
    )

    cov = jax.nn.sigmoid(-delta_min / sigma)
    # Depth gate: the silhouette only shows where the sphere layer is in
    # front of the background surface.
    in_front = ~bg.valid | (front.t < bg.t)
    cov = jnp.where(in_front, cov, 0.0)
    return front, bg, cov.astype(o.dtype)


def integrate_chain_soft(
    flat: FlatScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    cfg: RenderConfig,
    prim_axis: str | None = None,
) -> jnp.ndarray:
    """Chain integrator with a two-layer soft-silhouette primary bounce."""
    r = o.shape[0]
    active = jnp.ones((r,), jnp.bool_)
    front, bg, cov = soft_primary_layers(flat, o, d, cfg)

    nd_f = _shade_from_hit(flat, front, d, active, cfg, prim_axis)
    nd_b = _shade_from_hit(flat, bg, d, active, cfg, prim_axis)

    sky = sky_color(d)
    one_m_cov = 1.0 - cov
    accum = jnp.where(
        nd_b["miss"][:, None], one_m_cov[:, None] * sky, 0.0
    )
    accum = accum + jnp.where(
        nd_f["shade"][:, None], cov[:, None] * nd_f["local_term"], 0.0
    )
    accum = accum + jnp.where(
        nd_b["shade"][:, None], one_m_cov[:, None] * nd_b["local_term"], 0.0
    )

    # Reflection chains from both layers, weighted by their coverage.
    cont_f = nd_f["has_refl"]
    accum = _chain_scan(
        flat,
        jnp.where(cont_f[:, None], nd_f["refl_o"], o),
        jnp.where(cont_f[:, None], nd_f["refl_dir"], d),
        jnp.where(cont_f, cov * nd_f["refl_w"], 0.0),
        cont_f,
        accum,
        1,
        cfg,
        prim_axis,
    )
    cont_b = nd_b["has_refl"]
    return _chain_scan(
        flat,
        jnp.where(cont_b[:, None], nd_b["refl_o"], o),
        jnp.where(cont_b[:, None], nd_b["refl_dir"], d),
        jnp.where(cont_b, one_m_cov * nd_b["refl_w"], 0.0),
        cont_b,
        accum,
        1,
        cfg,
        prim_axis,
    )
