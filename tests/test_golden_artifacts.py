"""Regression tests against the pinned golden images in goldens/.

The reference checks rendered goldens into its repo
(/root/reference/README.md:5-24: output.ppm + 7 tonemap PNGs); these
tests are the equivalent practice. goldens/*.ppm were produced by the
fp64 CPU oracle (goldens/generate.py); the production fp32 pipeline must
reproduce them to within one LDR quantization step, with >=95% of bytes
exact — the same budget the oracle-parity tests use, now pinned to bytes
on disk so any future regression diffs against a fixed artifact.

Seam ties: on geometric silhouettes (box edges over walls) fp32 and fp64
can pick different closest primitives for a ray that grazes the edge, so
a per-scene handful of pixels differ by a whole shading level rather than
one quantization step. tests/test_reference_parity.py budgets these at
2e-5 of pixels at 1920x1080; here the same class gets <=1e-3 (edges are
proportionally wider at 128px), and each such pixel must reproduce one of
its golden neighbors exactly — a real shading regression shifts values
off-edge and fails both gates.
"""

import os

import numpy as np
import pytest

from raytracingengine.imageio import read_ppm
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scenes.builders import (
    baseline_sphere_scene,
    glass_sphere_scene,
    head_box_scene,
)
from raytracingengine.tonemap import OPERATORS, to_uint8

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "goldens")
SIZE = 128

SCENES = {
    "head_box": lambda: head_box_scene(width=SIZE, height=SIZE, spp=1),
    "baseline_spheres": lambda: baseline_sphere_scene(
        width=SIZE, height=SIZE, spp=1, n_lights=2
    ),
    "glass": lambda: glass_sphere_scene(width=SIZE, height=SIZE, spp=1),
}


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("op", ["aces", "simple"])
def test_pipeline_matches_pinned_golden(scene_name, op):
    path = os.path.join(GOLDEN_DIR, f"{scene_name}_{SIZE}_{op}.ppm")
    if not os.path.exists(path):
        pytest.skip(f"golden artifact missing: {path} (run goldens/generate.py)")
    gold = read_ppm(path)
    scene, camera = SCENES[scene_name]()
    hdr = np.asarray(render_hdr(scene, camera, RenderConfig(chunk_size=SIZE * SIZE)))
    ours = np.asarray(to_uint8(OPERATORS[op](hdr)))
    diff = np.abs(ours.astype(int) - gold.astype(int))
    seam_ys, seam_xs = np.nonzero(diff.max(axis=2) > 1)
    assert len(seam_ys) <= max(4, int(1e-3 * SIZE * SIZE)), (
        f"{scene_name}/{op}: {len(seam_ys)} pixels beyond 1 LDR step"
    )
    for y, x in zip(seam_ys, seam_xs):
        neighbors = [
            gold[yy, xx]
            for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1))
            if 0 <= yy < SIZE and 0 <= xx < SIZE
        ]
        assert any(np.array_equal(ours[y, x], n) for n in neighbors), (
            f"{scene_name}/{op}: pixel ({y},{x}) ours={ours[y, x]} "
            f"gold={gold[y, x]} is not a silhouette seam tie"
        )
        # A genuine seam tie sits ON an edge: at least one golden
        # neighbor must differ visibly from the golden pixel itself
        # (ADVICE r02 — otherwise a flat-background coincidence would
        # also pass the neighbor-match test).
        assert any(
            np.abs(n.astype(int) - gold[y, x].astype(int)).max() > 1
            for n in neighbors
        ), (
            f"{scene_name}/{op}: pixel ({y},{x}) diverges but sits in a "
            f"flat region — not a seam tie"
        )
    frac_exact = (diff == 0).mean()
    assert frac_exact > 0.95, f"{scene_name}/{op}: only {frac_exact:.1%} bytes exact"
