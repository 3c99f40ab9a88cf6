"""Full-pipeline LDR parity: render -> tonemap -> uint8 -> PPM bytes.

The strongest parity statement: the JAX fp32 pipeline and the fp64
golden oracle must agree at the *output byte* level — every uint8 channel
within one quantization step, and the PPM container byte-exact given the
same pixels (BASELINE 'bit-faithful image' criterion at LDR precision).
"""

import numpy as np

from raytracingengine.golden.reference import (
    GOLDEN_OPERATORS,
    g_to_uint8,
    golden_from_scene,
)
from raytracingengine.imageio import ppm_bytes
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scenes.builders import baseline_sphere_scene, head_box_scene
from raytracingengine.tonemap import OPERATORS, to_uint8


def _ldr_compare(scene, camera, cfg, ops=("aces", "simple", "reinhard_simple")):
    hdr = np.asarray(render_hdr(scene, camera, cfg), np.float64)
    g = golden_from_scene(scene, camera, cfg.max_depth, cfg.bias)
    gold_hdr = g.render()
    for name in ops:
        ours = np.asarray(to_uint8(OPERATORS[name](hdr.astype(np.float32))))
        gold = g_to_uint8(GOLDEN_OPERATORS[name](gold_hdr))
        diff = np.abs(ours.astype(int) - gold.astype(int))
        frac_exact = (diff == 0).mean()
        assert diff.max() <= 1, f"{name}: max LDR diff {diff.max()}"
        assert frac_exact > 0.95, f"{name}: only {frac_exact:.1%} bytes exact"


def test_sphere_scene_ldr_bytes():
    scene, camera = baseline_sphere_scene(width=24, height=24, spp=1)
    _ldr_compare(scene, camera, RenderConfig(chunk_size=24 * 24))


def test_head_box_ldr_bytes():
    scene, camera = head_box_scene(width=20, height=20, spp=1)
    _ldr_compare(scene, camera, RenderConfig(chunk_size=400))


def test_ppm_container_roundtrip_equivalence():
    scene, camera = baseline_sphere_scene(width=16, height=16, spp=1)
    cfg = RenderConfig(chunk_size=256)
    hdr = np.asarray(render_hdr(scene, camera, cfg))
    u8 = np.asarray(to_uint8(OPERATORS["aces"](hdr)))
    data = ppm_bytes(u8)
    # header + payload exactly like Image.cpp:18-22
    assert data[: len(b"P6\n16 16\n255\n")] == b"P6\n16 16\n255\n"
    assert len(data) == len(b"P6\n16 16\n255\n") + 16 * 16 * 3
