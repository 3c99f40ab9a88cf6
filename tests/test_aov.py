"""AOV renders: depth / normal / albedo / hit maps (BASELINE config #1)."""

import numpy as np

from raytracingengine.render.aov import render_aovs
from raytracingengine.scenes.builders import baseline_sphere_scene


def test_aov_shapes_and_ranges():
    scene, camera = baseline_sphere_scene(width=32, height=32, spp=1)
    aovs = render_aovs(scene, camera)
    assert aovs["depth"].shape == (32, 32)
    assert aovs["normal"].shape == (32, 32, 3)
    assert aovs["albedo"].shape == (32, 32, 3)
    assert aovs["hit"].shape == (32, 32)
    d = np.asarray(aovs["depth"])
    assert (d >= 0).all() and (d <= 1).all()
    n = np.asarray(aovs["normal"])
    assert (n >= 0).all() and (n <= 1.0001).all()


def test_depth_semantics():
    # Center pixel hits the big sphere front face (center z=6, r=2, cam
    # z=-10 -> t=14); depth = (t - near)/(far - near) = 14/100.
    scene, camera = baseline_sphere_scene(width=33, height=33, spp=1)
    aovs = render_aovs(scene, camera)
    # (pixel centers sit at half-integer offsets: sx = 16 - 33/2 = -0.5,
    # so the ray is ~half a pixel off-axis -> t is a hair above 14)
    center = float(np.asarray(aovs["depth"])[16, 16])
    np.testing.assert_allclose(center, 14.0 / 100.0, rtol=5e-3)
    assert float(np.asarray(aovs["hit"])[16, 16]) == 1.0


def test_normal_facing_camera():
    # The sphere's front-face normal points back at the camera (-z):
    # encoded color z-channel = (-1)*0.5+0.5 = 0.
    scene, camera = baseline_sphere_scene(width=33, height=33, spp=1)
    aovs = render_aovs(scene, camera)
    nz = float(np.asarray(aovs["normal"])[16, 16, 2])
    assert nz < 0.01


def test_miss_is_sky():
    scene, camera = baseline_sphere_scene(width=33, height=33, spp=1)
    aovs = render_aovs(scene, camera)
    # Top corner rays go up into the sky (no geometry above).
    assert float(np.asarray(aovs["hit"])[0, 0]) == 0.0
    assert float(np.asarray(aovs["depth"])[0, 0]) == 1.0
