from raytracingengine.tonemap.operators import (
    OPERATORS,
    aces_approx,
    reinhard_extended,
    reinhard_extended_luminance,
    reinhard_jodie,
    reinhard_simple,
    simple,
    to_uint8,
    tonemap,
    tonemap_all,
    uncharted2,
)

__all__ = [
    "OPERATORS",
    "simple",
    "reinhard_simple",
    "reinhard_extended",
    "reinhard_extended_luminance",
    "reinhard_jodie",
    "uncharted2",
    "aces_approx",
    "tonemap",
    "tonemap_all",
    "to_uint8",
]
