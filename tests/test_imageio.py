"""I/O: PPM byte-compat vs the reference golden, PNG roundtrip, OBJ load."""

import os

import numpy as np
import pytest

from raytracingengine.imageio import (
    load_obj,
    ppm_bytes,
    read_ppm,
    read_png,
    write_png,
    write_ppm,
)
from raytracingengine.scenes.assets import cube_mesh, cube_obj_text

REF_PPM = "/root/reference/RaytracingEngine/output.ppm"


def test_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    p = tmp_path / "x.ppm"
    write_ppm(str(p), img)
    back = read_ppm(str(p))
    np.testing.assert_array_equal(img, back)


def test_ppm_header_bytes():
    # Exact header layout of the reference writer (Image.cpp:18)
    img = np.zeros((2, 3, 3), np.uint8)
    data = ppm_bytes(img)
    assert data.startswith(b"P6\n3 2\n255\n")
    assert len(data) == len(b"P6\n3 2\n255\n") + 2 * 3 * 3


@pytest.mark.skipif(not os.path.exists(REF_PPM), reason="reference not mounted")
def test_read_reference_golden_ppm():
    img = read_ppm(REF_PPM)
    assert img.shape == (1000, 1000, 3)
    assert img.dtype == np.uint8
    # The golden render is a lit scene: nontrivial content.
    assert img.std() > 10


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 9, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    write_png(str(p), img)
    back = read_png(str(p))
    np.testing.assert_array_equal(img, back)


def test_obj_loader_cube(tmp_path):
    p = tmp_path / "box.obj"
    p.write_text(cube_obj_text(size=2.0))
    data = load_obj(str(p))
    verts, idx = cube_mesh(size=2.0)
    np.testing.assert_allclose(data["vertices"], verts)
    np.testing.assert_array_equal(data["indices"], idx)


def test_obj_loader_forms(tmp_path):
    # v/vt/vn forms, negative indices, quad fan triangulation
    p = tmp_path / "t.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvn 0 0 1\n"
        "f 1/1/1 2/1/1 3/1/1 4/1/1\n"  # quad -> 2 tris
        "f -4//-1 -3//-1 -2//-1\n"  # negative indices
    )
    data = load_obj(str(p))
    assert data["indices"].tolist() == [0, 1, 2, 0, 2, 3, 0, 1, 2]


def test_obj_loader_mtl(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 1 0 0\nNs 32\nnewmtl blue\nKd 0 0 1\n"
    )
    p = tmp_path / "t.obj"
    p.write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "usemtl blue\nf 1 2 3\n"
    )
    data = load_obj(str(p))
    # material_names = usemtl first-seen order; properties resolved
    # from the mtllib
    assert data["material_names"] == ["blue"]
    assert data["face_materials"].tolist() == [0]
    assert data["materials"][0]["Kd"] == (0.0, 0.0, 1.0)


def test_native_backend_matches_python(tmp_path):
    from raytracingengine import native_bridge

    if not native_bridge.available():
        import pytest

        pytest.skip("native library not built")
    p = tmp_path / "box.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "usemtl a\nf 1 2 3 4\nusemtl b\nf -4 -3 -2\n"
    )
    a = load_obj(str(p), backend="python")
    b = load_obj(str(p), backend="native")
    np.testing.assert_allclose(a["vertices"], b["vertices"])
    np.testing.assert_array_equal(a["indices"], b["indices"])
    np.testing.assert_array_equal(a["face_materials"], b["face_materials"])
    assert a["material_names"] == b["material_names"]


def test_native_ppm_png_match_python(tmp_path):
    from raytracingengine import native_bridge
    from raytracingengine.imageio.png import png_bytes

    if not native_bridge.available():
        import pytest

        pytest.skip("native library not built")
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    p1, p2 = tmp_path / "a.ppm", tmp_path / "b.ppm"
    write_ppm(str(p1), img, backend="python")
    native_bridge.write_ppm_native(str(p2), img)
    assert p1.read_bytes() == p2.read_bytes()
    # PNGs decode to identical pixels (compressed bytes may differ)
    from raytracingengine.imageio.png import read_png

    n = tmp_path / "n.png"
    n.write_bytes(native_bridge.png_bytes_native(img))
    np.testing.assert_array_equal(read_png(str(n)), img)
