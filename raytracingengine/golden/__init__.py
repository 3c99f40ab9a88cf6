from raytracingengine.golden.reference import GoldenScene, golden_from_scene

__all__ = ["GoldenScene", "golden_from_scene"]
