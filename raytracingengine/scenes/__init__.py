from raytracingengine.scenes.builders import (
    baseline_sphere_scene,
    glass_sphere_scene,
    head_box_scene,
    stress_scene,
)
from raytracingengine.scenes.assets import cube_mesh

__all__ = [
    "baseline_sphere_scene",
    "glass_sphere_scene",
    "head_box_scene",
    "stress_scene",
    "cube_mesh",
]
