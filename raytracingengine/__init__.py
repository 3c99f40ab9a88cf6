"""raytracingengine — a differentiable Whitted ray tracer in JAX.

A from-scratch JAX re-design of the capabilities of the reference C++20
engine (Sorax5/RaytracingEngine): pinhole camera, analytic
sphere/plane/triangle intersection with closest-hit selection, point-light
shading with transmittance shadow marching, Whitted-style recursive
reflection/refraction (re-expressed as a masked wavefront), the 7-operator
tonemap family, PPM/PNG/OBJ I/O — all differentiable end-to-end and sharded
over device meshes.

Design stance (vs the reference's per-pixel recursive C++):
  * rays are the batch axis; every intersection test is an all-pairs
    [primitives, rays] computation built from [N,3]x[R,3] contractions
    (geometry/intersect.py), or a Triton kernel that scans primitives
    without writing the pair matrix (geometry/hit_kernel.py, CUDA GPUs),
  * recursion becomes a bounded masked wavefront (render/integrator.py),
  * parallelism is a jax.sharding.Mesh with rays sharded and the scene
    replicated (or primitive-sharded for huge scenes) — parallel/.
"""

__version__ = "0.1.0"

from raytracingengine.core.camera import Camera
from raytracingengine.scene import Scene
from raytracingengine.render.config import RenderConfig

__all__ = ["Camera", "Scene", "RenderConfig", "__version__"]
