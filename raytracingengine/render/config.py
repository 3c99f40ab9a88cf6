"""Static render configuration.

The reference hard-codes all of this at compile time: maxRecursion=10
(Scene.h:24), bias=1e-3 (Scene.h:291), shadow-march safety=64 and
min-transmittance 1e-4 (Scene.h:39-42), spp=32 (Math.h:94 — lives on
Camera here too). `RenderConfig` is hashable and passed as a static jit
argument, so every field change is an intentional recompile.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    #: Whitted recursion limit (depth >= max_depth returns sky, Scene.h:132-134).
    max_depth: int = 10
    #: Shadow/secondary-ray offset bias (Scene.h:291).
    bias: float = 1e-3
    #: Transmittance march: max steps (Scene.h:39) and early-exit threshold
    #: (Scene.h:42: loop continues while T > 1e-4).
    shadow_max_steps: int = 64
    shadow_min_t: float = 1e-4
    #: Integrator: 'auto' picks 'chain' for opaque scenes and 'wavefront'
    #: when any material transmits; either can be forced.
    mode: str = "auto"
    #: Wavefront mode: max nodes of the recursion tree processed per pixel.
    #: The loop exits as soon as every pixel's ray stack is empty, so this
    #: is a safety cap, not a fixed cost. None -> min(2^(max_depth+1), 4096)
    #: (the exact full-binary-tree node count, i.e. lossless).
    wavefront_budget: int | None = None
    #: Shadow visibility:
    #:   'march'  — the reference's transmittance march (Scene.h:35-77),
    #:              exact parity; reverse-mode differentiable only when
    #:              `differentiable=True` (fixed-trip scan).
    #:   'binary' — one any-hit pass: V = 0 iff any surface lies at
    #:              bias < t < max_dist. Identical to the march for fully
    #:              opaque scenes (the march multiplies T by 0 at the first
    #:              such hit) and differentiable at march cost / 64.
    #:   'soft'   — sigmoid visibility over sphere clearance; smooth
    #:              gradients for inverse rendering.
    shadow_mode: str = "march"
    #: Soft-shadow smoothing width (world units).
    soft_sigma: float = 0.05
    #: Differentiable sphere silhouettes on the primary bounce
    #: (render/soft_primary.py): coverage-blended edges so image loss has
    #: usable gradients w.r.t. sphere centers/radii. Chain mode only.
    soft_primary: bool = False
    #: Replace while_loops (shadow march, wavefront) with fixed-trip scans
    #: so reverse-mode autodiff works. Costs the full trip count every
    #: call — prefer shadow_mode='binary'/'soft' plus the chain integrator
    #: for training, which need no loops at all.
    differentiable: bool = False
    #: Terminate secondary chains whose accumulated path weight falls
    #: below this. The reference traces every spawned ray to depth 10
    #: regardless of weight (Scene.h:131-198); a child with weight w can
    #: change the pixel by at most w * max(local radiance), so pruning at
    #: 1e-8 keeps HDR output within ~3e-6 of the reference (far below the
    #: parity gates) while cutting typical chain length on the HEAD scene
    #: from 10 to ~4 (plane specular = 0.01 decays weight 100x per
    #: bounce). Set to 0.0 for the reference's exact trace-everything
    #: behavior.
    min_weight: float = 1e-8
    #: Rays per chunk (`lax.map` step). Bounds device memory: the XLA
    #: intersection holds several [prims, chunk] fp32 matrices at once.
    chunk_size: int = 16384
    #: Run closest-hit and any-hit through the Triton kernel
    #: (geometry/hit_kernel.py) instead of the XLA all-pairs matrices, in
    #: both integrators and the 'march' and 'binary' shadow modes ('soft'
    #: shadows and the soft primary bounce stay on XLA). Needs a CUDA GPU;
    #: elsewhere it raises. GSPMD (render_hdr with a mesh) cannot
    #: partition it; the shard_map paths in parallel/sharded.py can.
    use_pallas: bool = False

    def budget(self) -> int:
        if self.wavefront_budget is not None:
            return self.wavefront_budget
        return min(2 ** (self.max_depth + 1), 4096)
