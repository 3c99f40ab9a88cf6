"""Arbitrary output variables: depth / normal / albedo / hit-mask maps.

The reference advertises depth and normal map rendering (README.md:27-28)
via `CalculatePixelDepth` + `HitInfo::normalizedDistance` (Scene.h:278-281,
Shape.h:40-42) and the compile-time `visualizeNormals` debug branch
(Scene.h:150-159). These are first-class forward-only AOV renders here
(BASELINE config #1: 256x256 depth/normal/color maps).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracingengine.core.camera import Camera
from raytracingengine.core import vecmath as vm
from raytracingengine.geometry.intersect import closest_hit, flatten_scene
from raytracingengine.render.shading import sky_color
from raytracingengine.scene import Scene


def render_aovs(scene: Scene, camera: Camera) -> dict[str, jnp.ndarray]:
    """Single-sample center-ray AOVs.

    Returns:
      depth  [H,W]   — (t - near) / (far - near) (Shape.h:40-42); miss -> 1.
      normal [H,W,3] — front-face-flipped normal * 0.5 + 0.5; magenta for
                       non-finite hits; sky gradient on miss (Scene.h:150-159
                       composed with the miss path at Scene.h:137-139).
      albedo [H,W,3] — hit material color; sky gradient on miss.
      hit    [H,W]   — 1.0 where a primitive was hit.
    """
    flat = flatten_scene(scene)
    px, py = camera.pixel_grid()
    o, d = camera.rays_for_pixels(px, py, None)
    hit = closest_hit(flat, o, d)

    h, w = camera.height, camera.width
    miss = ~hit.valid

    depth = (hit.t - camera.near) / (camera.far - camera.near)
    depth = jnp.where(miss, 1.0, jnp.clip(depth, 0.0, 1.0))

    incoming = d
    front = vm.dot(hit.normal, incoming) < 0.0
    n = jnp.where(front[:, None], hit.normal, -hit.normal)
    n = vm.normalize(n)
    finite = jnp.all(jnp.isfinite(n), axis=-1) & jnp.isfinite(hit.t)
    magenta = jnp.array([1.0, 0.0, 1.0], o.dtype)
    normal_rgb = jnp.where(
        finite[:, None], n * 0.5 + 0.5, jnp.broadcast_to(magenta, n.shape)
    )
    sky = sky_color(d)
    normal_rgb = jnp.where(miss[:, None], sky, normal_rgb)

    albedo = jnp.where(miss[:, None], sky, hit.albedo)

    return {
        "depth": depth.reshape(h, w),
        "normal": normal_rgb.reshape(h, w, 3),
        "albedo": albedo.reshape(h, w, 3),
        "hit": (~miss).astype(o.dtype).reshape(h, w),
    }
