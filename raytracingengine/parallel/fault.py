"""Fault-tolerant tiled rendering: detect-and-retry at the tile level.

The reference has no failure handling (single process, exceptions only —
SURVEY.md §5). The equivalent here, for long offline renders: split
the frame into independent host-level tiles, render each with bounded
retries, verify each result is finite, and re-render any tile that
failed (device error, preemption) or produced non-finite pixels. Tiles
are pure functions of (scene, camera, tile coords), so a retry is always
safe. This is the host-side complement to the in-graph NaN guards
(utils/checks.py).
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from raytracingengine.core.camera import Camera
from raytracingengine.geometry.intersect import flatten_scene
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import _render_chunk, resolve_mode
from raytracingengine.scene import Scene


def render_hdr_faulttolerant(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    key: jnp.ndarray | None = None,
    tile_rows: int = 8,
    max_retries: int = 2,
    on_event: Callable[[str, dict], None] | None = None,
) -> np.ndarray:
    """Render in `tile_rows` horizontal bands with per-band retry.

    Returns a numpy [H, W, 3] image. A band is retried when the device
    raises or the result contains non-finite values; after `max_retries`
    the error propagates (and `on_event` has the full audit trail).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    flat = flatten_scene(scene)
    mode = resolve_mode(scene, cfg)
    h, w = camera.height, camera.width
    rows_per = -(-h // tile_rows)
    out = np.zeros((h, w, 3), np.float32)

    def emit(event, **fields):
        if on_event is not None:
            on_event(event, fields)

    render_band = jax.jit(
        lambda px, py, k: _render_chunk(flat, camera, cfg, mode, px, py, k)
    )

    for band in range(tile_rows):
        y0 = band * rows_per
        y1 = min(y0 + rows_per, h)
        if y0 >= y1:
            break
        ys, xs = jnp.meshgrid(
            jnp.arange(y0, y1), jnp.arange(w), indexing="ij"
        )
        px = xs.reshape(-1).astype(jnp.int32)
        py = ys.reshape(-1).astype(jnp.int32)
        for attempt in range(max_retries + 1):
            try:
                band_key = jax.random.fold_in(key, band)
                result = np.asarray(render_band(px, py, band_key))
                if not np.isfinite(result).all():
                    raise FloatingPointError(
                        f"non-finite pixels in band {band}"
                    )
                out[y0:y1] = result.reshape(y1 - y0, w, 3)
                emit("band_ok", band=band, attempt=attempt)
                break
            except Exception as e:  # device fault / NaN: retry the band
                emit("band_retry", band=band, attempt=attempt, error=str(e))
                if attempt == max_retries:
                    raise
                time.sleep(0.1 * (attempt + 1))
    return out
