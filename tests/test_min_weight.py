"""Adversarial-specular parity for the min_weight chain pruning.

RenderConfig.min_weight=1e-8 prunes reflection chains whose carried
weight drops below the threshold — a deliberate semantic deviation from
the reference's full-depth recursion (Scene.h:189-195), justified by a
documented contribution bound of ~3e-6 HDR (PROFILE.md §2). The HEAD
parity gates all use specular 0.01 walls where pruning is trivially
inert; this test attacks the regime VERDICT r03 weak #5 called out:
mid-range specular (~0.25-0.45) chains deep enough that the prune
ACTUALLY fires before depth exhaustion (0.25^(k+1) < 1e-8 at bounce
k+1 = 14 < max_depth = 16).

Three gates:
  1. default min_weight vs min_weight=0 differ by <= 3e-6 HDR — the
     documented bound, now measured off the HEAD parameter regime;
  2. the pruned render still matches the fp64 full-depth oracle within
     the standard fp32 budget;
  3. non-vacuity: an aggressive min_weight=1e-3 (pruning from bounce ~5)
     DOES diverge visibly, proving the scene exercises chains whose tail
     pruning could corrupt.
"""

import numpy as np

from raytracingengine.golden.reference import golden_from_scene
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr, resolve_mode
from raytracingengine.scene import Material, SceneBuilder
from raytracingengine.core.camera import Camera

SIZE = 24
DEPTH = 16


def _mirror_hall_scene():
    """Two facing specular-0.25 planes with a specular-0.45 sphere
    between them: every primary ray enters a reflection chain that only
    ends at max_depth (or the prune)."""
    b = SceneBuilder()
    hall = Material(color=(0.7, 0.75, 0.8), specular=0.25, shininess=32.0)
    b.add_plane((0.0, 0.0, 12.0), (0.0, 0.0, -1.0), hall)
    b.add_plane((0.0, 0.0, -12.0), (0.0, 0.0, 1.0), hall)
    b.add_plane(
        (0.0, -3.0, 0.0), (0.0, 1.0, 0.0),
        Material(color=(0.9, 0.85, 0.7), specular=0.3, shininess=16.0),
    )
    b.add_sphere(
        (0.0, 0.0, 5.0), 1.8,
        Material(color=(0.8, 0.3, 0.2), specular=0.45, shininess=64.0),
    )
    b.add_light((0.0, 5.0, -2.0), (1.0, 1.0, 1.0), 120.0)
    b.add_light((-3.0, 4.0, 6.0), (1.0, 0.9, 0.8), 80.0)
    scene = b.build()
    camera = Camera.create(
        (0.0, 0.5, -9.0), focal=float(SIZE), width=SIZE, height=SIZE,
        near=0.0, far=200.0, spp=1,
    )
    return scene, camera


def _render(scene, camera, min_weight):
    cfg = RenderConfig(
        max_depth=DEPTH, min_weight=min_weight, chunk_size=SIZE * SIZE
    )
    assert resolve_mode(scene, cfg) == "chain"
    return np.asarray(render_hdr(scene, camera, cfg), np.float64)


def test_min_weight_bound_holds_on_adversarial_specular():
    scene, camera = _mirror_hall_scene()
    pruned = _render(scene, camera, 1e-8)
    full = _render(scene, camera, 0.0)
    err = np.abs(pruned - full).max()
    assert err <= 3e-6, (
        f"min_weight=1e-8 deviates {err:.2e} HDR from full-depth chains "
        f"on specular-0.25/0.45 mirror hall — documented bound is 3e-6"
    )


def test_pruned_matches_fp64_oracle():
    scene, camera = _mirror_hall_scene()
    pruned = _render(scene, camera, 1e-8)
    g = golden_from_scene(scene, camera, max_depth=DEPTH, bias=1e-4)
    gold = g.render()
    np.testing.assert_allclose(pruned, gold, rtol=2e-3, atol=3e-3)


def test_scene_is_prune_sensitive():
    """The adversarial gate is only meaningful if pruning CAN corrupt
    this scene: chopping chains from bounce ~5 (min_weight=1e-3) must
    move the image far beyond the 3e-6 budget."""
    scene, camera = _mirror_hall_scene()
    full = _render(scene, camera, 0.0)
    chopped = _render(scene, camera, 1e-3)
    assert np.abs(chopped - full).max() > 1e-4
