"""CLI + scene-JSON config: end-to-end through the command line."""

import json
import os

import numpy as np
import pytest

from raytracingengine.cli import main
from raytracingengine.imageio import read_png, read_ppm
from raytracingengine.scenes.config import scene_from_dict


def test_scene_from_dict_roundtrip():
    cfg = {
        "camera": {"position": [0, 0, -10], "focal": 64, "width": 32,
                   "height": 32, "near": 0, "far": 100, "spp": 1},
        "spheres": [
            {"center": [0, 0, 5], "radius": 1.5,
             "material": {"color": [1, 0, 0], "specular": 0.2}}
        ],
        "planes": [
            {"point": [0, -2, 0], "normal": [0, 1, 0],
             "material": {"color": [1, 1, 1]}}
        ],
        "lights": [{"position": [0, 5, 0], "intensity": 40}],
    }
    scene, camera = scene_from_dict(cfg)
    assert len(scene.spheres) == 1 and len(scene.planes) == 1
    assert camera.width == 32 and camera.spp == 1
    assert float(scene.spheres.materials.specular[0]) == pytest.approx(0.2)


def test_cli_render_builtin(tmp_path):
    out = tmp_path / "o"
    rc = main(
        [
            "render", "--scene", "baseline_spheres", "--width", "24",
            "--height", "16", "--spp", "1", "--out", str(out),
            "--tonemap", "aces", "--format", "ppm", "--chunk-size", "128",
        ]
    )
    assert rc == 0
    img = read_ppm(str(out / "aces.ppm"))
    assert img.shape == (16, 24, 3)
    assert img.std() > 5  # lit content


def test_cli_render_json_scene_all_tonemaps(tmp_path):
    scene_json = {
        "camera": {"position": [0, 0, -8], "focal": 24, "width": 24,
                   "height": 24, "near": 0, "far": 50, "spp": 1},
        "spheres": [{"center": [0, 0, 4], "radius": 1.5,
                     "material": {"color": [0.2, 0.4, 0.9]}}],
        "lights": [{"position": [2, 4, -4], "intensity": 30}],
    }
    sp = tmp_path / "scene.json"
    sp.write_text(json.dumps(scene_json))
    out = tmp_path / "o"
    rc = main(
        [
            "render", "--scene", str(sp), "--width", "24", "--height", "24",
            "--spp", "1", "--out", str(out), "--tonemap", "all",
            "--format", "png", "--chunk-size", "128",
        ]
    )
    assert rc == 0
    files = sorted(os.listdir(out))
    assert len(files) == 7
    img = read_png(str(out / "aces.png"))
    assert img.shape == (24, 24, 3)


def test_cli_aov(tmp_path):
    out = tmp_path / "aov"
    rc = main(
        [
            "aov", "--scene", "baseline_spheres", "--width", "16",
            "--height", "16", "--spp", "1", "--out", str(out),
            "--format", "png",
        ]
    )
    assert rc == 0
    assert sorted(os.listdir(out)) == [
        "albedo.png", "depth.png", "hit.png", "normal.png",
    ]


def test_cli_json_model_obj(tmp_path):
    from raytracingengine.scenes.assets import cube_obj_text

    (tmp_path / "box.obj").write_text(cube_obj_text(2.0))
    scene_json = {
        "camera": {"position": [0, 0, -6], "focal": 16, "width": 16,
                   "height": 16, "near": 0, "far": 50, "spp": 1},
        "models": [{"obj": "box.obj", "translation": [0, 0, 2],
                    "material": {"color": [0, 0, 1], "specular": 0.5}}],
        "lights": [{"position": [0, 3, -4], "intensity": 20}],
    }
    sp = tmp_path / "scene.json"
    sp.write_text(json.dumps(scene_json))
    from raytracingengine.scenes.config import load_scene_json

    scene, camera = load_scene_json(str(sp))
    assert len(scene.triangles) == 12
    assert camera.width == 16
