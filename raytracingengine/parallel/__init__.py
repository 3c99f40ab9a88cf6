from raytracingengine.parallel.mesh import PRIM_AXIS, RAY_AXIS, make_mesh
from raytracingengine.parallel.sharded import (
    render_hdr_auto,
    render_hdr_sharded,
)

__all__ = [
    "PRIM_AXIS",
    "RAY_AXIS",
    "make_mesh",
    "render_hdr_auto",
    "render_hdr_sharded",
]
