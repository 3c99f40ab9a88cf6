"""Generate pinned golden images (the reference's golden-image practice,
/root/reference/README.md:5-24 — it checks in output.ppm + 7 tonemap PNGs).

Renders each scene with the fp64 CPU oracle (golden/reference.py — the
same semantics the real C++ engine was verified against at full
resolution in tests/test_reference_parity.py), tonemaps, and writes the
LDR PPMs checked into goldens/. Future rounds diff the production
pipeline against these pinned bytes (tests/test_golden_artifacts.py), so
a regression in any layer — intersection, shading, integrator, tonemap,
quantization — shows up as a byte diff.

Run: JAX_PLATFORMS=cpu python goldens/generate.py
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytracingengine.golden.reference import (  # noqa: E402
    GOLDEN_OPERATORS,
    g_to_uint8,
    golden_from_scene,
)
from raytracingengine.imageio import write_ppm  # noqa: E402
from raytracingengine.scenes.builders import (  # noqa: E402
    baseline_sphere_scene,
    glass_sphere_scene,
    head_box_scene,
)

SIZE = 128
SCENES = {
    "head_box": lambda: head_box_scene(width=SIZE, height=SIZE, spp=1),
    "baseline_spheres": lambda: baseline_sphere_scene(
        width=SIZE, height=SIZE, spp=1, n_lights=2
    ),
    "glass": lambda: glass_sphere_scene(width=SIZE, height=SIZE, spp=1),
}
OPS = ("aces", "simple")


def main() -> None:
    out_dir = os.path.dirname(os.path.abspath(__file__))
    for name, build in SCENES.items():
        scene, camera = build()
        g = golden_from_scene(scene, camera)
        hdr = g.render()
        for op in OPS:
            u8 = g_to_uint8(GOLDEN_OPERATORS[op](hdr))
            path = os.path.join(out_dir, f"{name}_{SIZE}_{op}.ppm")
            write_ppm(path, u8)
            print(f"wrote {path}")


if __name__ == "__main__":
    main()
