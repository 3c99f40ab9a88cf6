"""Core vector math vs reference semantics (Math.h:9-71)."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracingengine.core import vecmath as vm


def test_dot_cross():
    a = jnp.array([[1.0, 2.0, 3.0], [0.0, 1.0, 0.0]])
    b = jnp.array([[4.0, 5.0, 6.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(vm.dot(a, b), [32.0, 0.0])
    np.testing.assert_allclose(vm.cross(a, b)[1], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(
        vm.cross(a, b)[0], np.cross(np.array(a[0]), np.array(b[0]))
    )


def test_normalize_safe_zero():
    # Math.h:31-37: length <= 1e-12 -> zero vector
    v = jnp.array([[0.0, 0.0, 0.0], [3.0, 0.0, 4.0]])
    n = vm.normalize(v)
    np.testing.assert_allclose(n[0], [0.0, 0.0, 0.0])
    np.testing.assert_allclose(n[1], [0.6, 0.0, 0.8], rtol=1e-6)


def test_reflect():
    v = jnp.array([[1.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(vm.reflect(v, n)[0], [1.0, 1.0, 0.0])


def test_refract_straight_through():
    # eta=1 -> direction unchanged (normalized)
    v = jnp.array([[0.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    out = vm.refract(v, n, jnp.array(1.0))
    np.testing.assert_allclose(out[0], [0.0, -1.0, 0.0], atol=1e-7)


def test_refract_tir_zero_vector():
    # Grazing entry from dense to sparse medium -> TIR -> zero vector
    # (Math.h:48-50)
    v = jnp.array([[0.99, -0.14106736, 0.0]])
    v = v / jnp.linalg.norm(v)
    n = jnp.array([[0.0, 1.0, 0.0]])
    out = vm.refract(v, n, jnp.array(1.5))  # eta_i/eta_t = 1.5 (exiting glass)
    np.testing.assert_allclose(out[0], [0.0, 0.0, 0.0], atol=1e-7)


def test_refract_snell_angle():
    # 45 degrees into glass (eta = 1/1.5): sin(theta_t) = sin(45)/1.5
    s = np.sqrt(0.5)
    v = jnp.array([[s, -s, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    out = np.asarray(vm.refract(v, n, jnp.array(1.0 / 1.5)))[0]
    sin_t = abs(out[0]) / np.linalg.norm(out)
    np.testing.assert_allclose(sin_t, s / 1.5, rtol=1e-5)


@pytest.mark.parametrize("t", [0.0, 0.25, 1.0])
def test_lerp(t):
    a = jnp.array([0.0, 0.0, 0.0])
    b = jnp.array([1.0, 2.0, 4.0])
    np.testing.assert_allclose(vm.lerp(a, b, t), np.array(b) * t)
