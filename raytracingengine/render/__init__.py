from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr, render_rays

__all__ = ["RenderConfig", "render_hdr", "render_rays"]
