"""Batched 3-vector math on arrays of shape [..., 3].

Semantics re-derived from the reference engine's Vec3
(/root/reference/RaytracingEngine/Math.h:9-71), but expressed as batched
array ops so that every call vectorizes over the ray axis:

  * ``normalize`` is *safe*: vectors with length <= 1e-12 map to the zero
    vector (Math.h:31-37). This matters for the reference's TIR handling,
    where ``refract`` returns the zero vector and downstream code tests its
    length (Scene.h:178-186).
  * ``refract`` normalizes both arguments, clamps cos(theta_i) into [-1, 1]
    and returns the zero vector on total internal reflection (Math.h:43-52).
  * ``reflect`` is v - 2 (v.n) n (Math.h:39-41) — note the reference does
    NOT normalize its arguments here.

All functions are dtype-polymorphic; the renderer runs them in float32
while the golden oracle (golden/reference.py) re-derives the same
formulas in numpy float64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: Length threshold below which `normalize` returns the zero vector
#: (Math.h:33 uses 1e-12).
SAFE_NORMALIZE_EPS = 1e-12


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis: [..., 3] -> [...]."""
    return jnp.sum(a * b, axis=-1)


@jax.custom_jvp
def sqrt_grad_safe(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt with a bounded derivative.

    Value is exactly jnp.sqrt(x); the derivative is clamped to
    0.5/sqrt(max(x, 1e-12)) so tangent-grazing configurations (sphere
    discriminant == 0, refraction k == 0 — both reachable during
    inverse-rendering descent) produce large-but-finite gradients instead
    of inf -> NaN. The true derivative there IS unbounded; clamping keeps
    the descent direction and drops only the unusable magnitude.
    """
    return jnp.sqrt(x)


@sqrt_grad_safe.defjvp
def _sqrt_grad_safe_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    y = jnp.sqrt(x)
    return y, dx * 0.5 * jax.lax.rsqrt(jnp.maximum(x, 1e-12))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product over the trailing axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def normalize(a: jnp.ndarray, eps: float = SAFE_NORMALIZE_EPS) -> jnp.ndarray:
    """Safe normalize: zero vector out when |a| <= eps (Math.h:31-37).

    Implemented on the *squared* length so the backward pass never sees
    sqrt'(0) = inf (0 * inf = NaN would otherwise leak through the
    zero-vector branch of the jnp.where).
    """
    d2 = dot(a, a)
    small = d2 <= eps * eps
    inv = jax.lax.rsqrt(jnp.where(small, 1.0, d2))
    return jnp.where(small[..., None], 0.0, a * inv[..., None])


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """v - 2 (v.n) n (Math.h:39-41); no normalization of inputs."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(v: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction with TIR -> zero vector (Math.h:43-52).

    Both arguments are safe-normalized first, matching the reference. `eta`
    is eta_i/eta_t and may be batched [...].
    """
    eta = jnp.asarray(eta)
    i = normalize(v)
    nn = normalize(n)
    cosi = jnp.clip(dot(i, nn), -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    k_safe = jnp.maximum(k, 0.0)
    out = i * eta[..., None] - nn * (eta * cosi + sqrt_grad_safe(k_safe))[..., None]
    return jnp.where(tir[..., None], 0.0, out)


def lerp(a: jnp.ndarray, b: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """a + (b - a) * t (Math.h:63-68); t broadcasts over the vector axis."""
    return a + (b - a) * t


def clamp01(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(a, 0.0, 1.0)
