"""Tonemap family: JAX fp32 vs golden fp64, plus differentiability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingengine.golden.reference import GOLDEN_OPERATORS, g_to_uint8
from raytracingengine.tonemap.operators import OPERATORS, to_uint8, tonemap_all


def _hdr_samples():
    rng = np.random.default_rng(0)
    vals = rng.uniform(0.0, 8.0, (128, 3))
    vals[0] = [0.01, 0.01, 0.01]
    vals[1] = [20.0, 20.0, 20.0]  # way over white point
    vals[2] = [1.0, 0.0, 0.0]
    return vals


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_matches_golden(name):
    hdr = _hdr_samples()
    ours = np.asarray(OPERATORS[name](jnp.asarray(hdr, jnp.float32)), np.float64)
    gold = GOLDEN_OPERATORS[name](hdr)
    np.testing.assert_allclose(ours, gold, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_differentiable(name):
    hdr = jnp.asarray(_hdr_samples(), jnp.float32)
    grad = jax.grad(lambda x: jnp.sum(OPERATORS[name](x)))(hdr)
    # clip kills gradients at the saturated samples; check a mid-range one
    assert np.isfinite(np.asarray(grad)).all()
    assert np.abs(np.asarray(grad[0])).max() > 0


def test_to_uint8_truncates():
    # toColor truncates (static_cast<uint8_t>), it does not round
    # (RaytracingEngine.cpp:113-121).
    v = jnp.asarray([[0.9999, 0.5, 1.0], [0.0039, 0.0, 2.0]], jnp.float32)
    out = np.asarray(to_uint8(v))
    gold = g_to_uint8(np.asarray(v, np.float64))
    np.testing.assert_array_equal(out, gold)
    assert out[0, 0] == 254  # 0.9999*255 = 254.97 -> 254
    assert out[1, 2] == 255  # clamped then 255


def test_tonemap_all_names_and_order():
    hdr = jnp.ones((4, 3), jnp.float32)
    result = tonemap_all(hdr)
    assert list(result.keys()) == [
        "simple",
        "reinhard_simple",
        "reinhard_extended",
        "reinhard_extended_luminance",
        "reinhard_jodie",
        "uncharted2",
        "aces",
    ]
