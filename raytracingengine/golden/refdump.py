"""Reader for HDR dumps produced by the real reference engine.

`refbuild/parity_main.cpp` links the UNMODIFIED reference headers
(/root/reference/RaytracingEngine/Scene.h et al.), renders deterministic
spp=1 frames (Camera::antiAliasingAmount=1 disables the jitter branch at
Scene.h:292), and writes raw fp64 HDR as:

    b"RTEHDR1\\n"  int32 width  int32 height  width*height*3 float64 (RGB)

row-major with idx = y*width + x (the engine's pixel order, Scene.h:321-324).
These files are the strongest available correctness oracle: they come from
the actual C++ engine, not a re-derivation.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"RTEHDR1\n"

#: Default location of the out-of-tree reference build (see refbuild/build.sh).
REFBUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "refbuild")


def read_hdr64(path: str) -> np.ndarray:
    """-> float64 [H, W, 3] HDR image."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 3 * 8), dtype="<f8")
    if data.size != w * h * 3:
        raise ValueError(f"{path}: truncated ({data.size} != {w*h*3})")
    return data.reshape(h, w, 3)


def dump_path(name: str) -> str:
    return os.path.abspath(os.path.join(REFBUILD_DIR, f"{name}.hdr64"))


def have_dump(name: str) -> bool:
    return os.path.exists(dump_path(name))


def load_dump(name: str) -> np.ndarray:
    return read_hdr64(dump_path(name))


def ldr_bytes(img: np.ndarray) -> np.ndarray:
    """HDR -> the 8-bit value a plain clamp-and-scale tonemap writes."""
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.int32)


def parity_stats(img: np.ndarray, ref: np.ndarray) -> dict:
    """How far a render is from a dump: the 99.9th percentile of the HDR
    difference, and the share of subpixels more than 1 LDR byte apart."""
    img = np.asarray(img, np.float64)
    if img.shape != ref.shape:
        raise ValueError(f"shape {img.shape} != dump {ref.shape}")
    byte_diff = np.abs(ldr_bytes(img) - ldr_bytes(ref))
    return {
        "p999_hdr_diff": float(np.percentile(np.abs(img - ref), 99.9)),
        "bad_subpixel_frac": float((byte_diff > 1).mean()),
        "max_byte_diff": int(byte_diff.max()),
    }


def parity_failures(stats: dict, max_bad_frac: float, p999: float = 5e-5) -> list:
    """The parity gate: fp32-vs-fp64 noise is ~1e-5 in HDR, so the 99.9th
    percentile stays under `p999`; a few subpixels per million sit on exact
    closest-hit ties (plane seams, silhouettes) where fp32 flips the
    discrete winner, so those are bounded by a count (`max_bad_frac`), not
    by an elementwise tolerance. -> list of violated bounds (empty = pass)."""
    out = []
    if not stats["p999_hdr_diff"] < p999:
        out.append(f"p99.9 HDR diff {stats['p999_hdr_diff']:.2e} >= {p999:.0e}")
    if not stats["bad_subpixel_frac"] <= max_bad_frac:
        out.append(
            f"{stats['bad_subpixel_frac']:.2e} of subpixels differ by >1 LDR "
            f"byte (budget {max_bad_frac:.2e}); max byte diff "
            f"{stats['max_byte_diff']}"
        )
    return out
