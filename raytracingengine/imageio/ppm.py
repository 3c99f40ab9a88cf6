"""Binary PPM (P6) writer/reader.

Byte-compatible with the reference writer (Image.cpp:11-31): header
"P6\\n{W} {H}\\n255\\n" followed by raw RGB byte triples in row-major
order. The reader also parses the reference's checked-in golden
`output.ppm` (which uses the same header layout).
"""

from __future__ import annotations

import numpy as np


def write_ppm(path: str, rgb_u8: np.ndarray, backend: str = "auto") -> None:
    """rgb_u8: [H, W, 3] uint8. backend: 'auto' prefers the native C++
    writer when built; 'python' forces the pure-Python path."""
    arr = np.asarray(rgb_u8)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {arr.shape} {arr.dtype}")
    if backend == "auto":
        from raytracingengine import native_bridge

        if native_bridge.write_ppm_native(path, arr):
            return
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode("ascii"))
        f.write(arr.tobytes())


def ppm_bytes(rgb_u8: np.ndarray) -> bytes:
    arr = np.asarray(rgb_u8)
    h, w = arr.shape[:2]
    return f"P6\n{w} {h}\n255\n".encode("ascii") + arr.astype(np.uint8).tobytes()


def read_ppm(path: str) -> np.ndarray:
    """-> [H, W, 3] uint8. Handles P6 with whitespace/comment-tolerant
    header parsing (the format allows comments starting with '#')."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        raise ValueError("not a binary P6 PPM")
    # Tokenize header: magic, width, height, maxval; then a single
    # whitespace byte precedes the raster.
    pos = 2
    fields: list[int] = []
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # the single whitespace after maxval
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"unsupported maxval {maxval}")
    raster = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos)
    return raster.reshape(h, w, 3).copy()
