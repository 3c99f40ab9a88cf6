from raytracingengine.core import vecmath
from raytracingengine.core.camera import Camera

__all__ = ["vecmath", "Camera"]
