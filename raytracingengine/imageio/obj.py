"""Wavefront OBJ loader, from scratch (no tinyobj code).

Covers what the reference pipeline consumes (RaytracingEngine.cpp:15-65 +
vendored tiny_obj_loader): `v` positions, `f` faces with any of the index
forms `v`, `v/vt`, `v//vn`, `v/vt/vn`, negative (relative) indices, and
polygon faces triangulated as a fan (the reference passes triangulate=true,
RaytracingEngine.cpp:31). Materials from `.mtl` are parsed but the
caller-supplied material always wins — matching the reference, which
discards parsed materials (RaytracingEngine.cpp:64, Shape.h:275); we still
return them so callers *can* use them.

If the optional native C++ parser (native/objparser.cpp) is built, large
files parse there; this pure-Python path is the always-available fallback
with identical output.
"""

from __future__ import annotations

import os

import numpy as np


def _materials_for(obj_path: str, names: list[str]) -> list[dict]:
    """Parse the obj's mtllib(s) and return property dicts matching the
    given usemtl name order (empty dict for unresolved names)."""
    base = os.path.dirname(os.path.abspath(obj_path))
    parsed: dict[str, dict] = {}
    try:
        with open(obj_path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if parts and parts[0] == "mtllib" and len(parts) > 1:
                    parsed.update(_parse_mtl(os.path.join(base, parts[1])))
    except OSError:
        pass
    return [parsed.get(n, {}) for n in names]


def _parse_mtl(path: str) -> dict[str, dict]:
    mats: dict[str, dict] = {}
    cur: dict | None = None
    try:
        with open(path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                if parts[0] == "newmtl" and len(parts) > 1:
                    cur = {}
                    mats[parts[1]] = cur
                elif cur is not None and parts[0] in ("Kd", "Ks", "Ka"):
                    cur[parts[0]] = tuple(float(x) for x in parts[1:4])
                elif cur is not None and parts[0] in ("Ns", "d", "Ni"):
                    cur[parts[0]] = float(parts[1])
    except OSError:
        pass
    return mats


def load_obj(path: str, backend: str = "auto") -> dict:
    """-> dict(vertices [V,3] float64, indices [3*F] int64 flat,
    face_materials [F] int32 (-1 if none), materials list[dict],
    material_names list[str]).

    The flat `indices` layout mirrors the reference Model's storage
    (Shape.h:251-252: flat vector<int> of vertex indices, 3 per triangle).

    backend: 'auto' uses the native C++ parser when built (identical
    output except .mtl property parsing, which stays in Python since the
    reference discards materials anyway), 'native' requires it, 'python'
    forces the pure-Python path.
    """
    if backend in ("auto", "native"):
        from raytracingengine import native_bridge

        native = native_bridge.load_obj_native(path)
        if native is not None:
            # Native parser skips .mtl property parsing; graft it on so
            # callers that *do* want materials still get them.
            native["materials"] = _materials_for(path, native["material_names"])
            return native
        if backend == "native":
            raise RuntimeError("native OBJ parser not built (make -C native)")
    verts: list[tuple[float, float, float]] = []
    tris: list[int] = []
    face_mats: list[int] = []
    mat_names: list[str] = []  # usemtl names, first-seen order
    mat_lookup: dict[str, int] = {}
    cur_mat = -1

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                # Fan triangulation (tinyobj's triangulate=true behavior
                # for convex polygons).
                for k in range(1, len(idx) - 1):
                    tris.extend((idx[0], idx[k], idx[k + 1]))
                    face_mats.append(cur_mat)
            elif tag == "usemtl" and len(parts) > 1:
                name = parts[1]
                if name not in mat_lookup:
                    mat_lookup[name] = len(mat_names)
                    mat_names.append(name)
                cur_mat = mat_lookup[name]

    vertices = np.asarray(verts, np.float64).reshape(-1, 3)
    indices = np.asarray(tris, np.int64)
    if indices.size and (indices.min() < 0 or indices.max() >= len(vertices)):
        raise ValueError("OBJ face index out of range")
    return {
        "vertices": vertices,
        "indices": indices,
        "face_materials": np.asarray(face_mats, np.int32),
        "materials": _materials_for(path, mat_names),
        "material_names": mat_names,
    }
