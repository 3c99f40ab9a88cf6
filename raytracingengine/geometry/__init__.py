from raytracingengine.geometry.materials import Material, Materials
from raytracingengine.geometry.primitives import (
    Spheres,
    Planes,
    Triangles,
    Lights,
)
from raytracingengine.geometry.intersect import (
    FlatScene,
    Hit,
    flatten_scene,
    closest_hit,
    intersect_spheres,
    intersect_planes,
    intersect_triangles,
)

__all__ = [
    "Material",
    "Materials",
    "Spheres",
    "Planes",
    "Triangles",
    "Lights",
    "FlatScene",
    "Hit",
    "flatten_scene",
    "closest_hit",
    "intersect_spheres",
    "intersect_planes",
    "intersect_triangles",
]
