from raytracingengine.imageio.obj import load_obj
from raytracingengine.imageio.png import png_bytes, read_png, write_png
from raytracingengine.imageio.ppm import ppm_bytes, read_ppm, write_ppm

__all__ = [
    "load_obj",
    "png_bytes",
    "read_png",
    "write_png",
    "ppm_bytes",
    "read_ppm",
    "write_ppm",
]
