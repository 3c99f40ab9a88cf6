"""Tonemap-composed gradient fidelity (BASELINE config #3, VERDICT r01 #9).

test_grad_fd.py validates renderer gradients pre-tonemap; this suite
composes the full user-facing pipeline — render -> tonemap operator ->
per-pixel image — and checks the autodiff directional derivative against
central finite differences of the fp64 golden oracle with an fp64 numpy
mirror of the operator (the jnp operators in tonemap/operators.py compute
in fp32; FD needs the full-precision composition).

Operators chosen to cover the family's structure: a rational per-channel
curve (reinhard_simple), a clamped rational fit (aces, zero-derivative in
the clipped region), and the luminance-space log map (reinhard_jodie,
exercises the change_luminance division).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingengine.golden.reference import golden_from_scene
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scenes.builders import baseline_sphere_scene
from raytracingengine.tonemap.operators import OPERATORS

W = H = 24
CFG = RenderConfig(chunk_size=W * H, shadow_mode="binary")
_F32 = lambda x: float(np.float32(x))


def _np_reinhard_simple(c):
    return c / (c + 1.0)


def _np_aces(c):
    v = c * _F32(0.6)
    a, b, cc, d, e = _F32(2.51), _F32(0.03), _F32(2.43), _F32(0.59), _F32(0.14)
    return np.clip((v * (a * v + b)) / (v * (cc * v + d) + e), 0.0, 1.0)


def _np_reinhard_jodie(c, a=0.18):
    l = c @ np.asarray([0.2126, 0.7152, 0.0722])
    l_mapped = (a / np.log(2.0 + (l / 0.85) ** 1.7)) * np.log(1.0 + l)
    return c * (l_mapped / l)[..., None]


NP_OPS = {
    "reinhard_simple": _np_reinhard_simple,
    "aces": _np_aces,
    "reinhard_jodie": _np_reinhard_jodie,
}

#: (operator, perturbed scene path, FD step)
CASES = [
    ("reinhard_simple", "lights.intensities", 1e-2),
    ("aces", "spheres.centers", 2e-3),
    ("reinhard_jodie", "spheres.materials.color", 2e-3),
]


def _apply(scene, path, delta):
    def upd(obj, parts):
        name = parts[0]
        child = getattr(obj, name)
        if len(parts) == 1:
            return dataclasses.replace(obj, **{name: child + delta})
        return dataclasses.replace(obj, **{name: upd(child, parts[1:])})

    return upd(scene, path.split("."))


def _direction_like(scene, path):
    obj = scene
    for p in path.split("."):
        obj = getattr(obj, p)
    d = np.zeros(obj.shape, np.float64)
    d.reshape(-1)[0] = 1.0
    return d


@pytest.mark.parametrize("op,path,h", CASES)
def test_tonemap_composed_ad_matches_fd(op, path, h):
    scene, camera = baseline_sphere_scene(width=W, height=H, spp=1)
    direction = _direction_like(scene, path)
    tm = OPERATORS[op]
    tm64 = NP_OPS[op]

    def f(eps):
        s = _apply(scene, path, eps * jnp.asarray(direction, jnp.float32))
        return tm(render_hdr(s, camera, CFG))

    _, ad = jax.jvp(f, (jnp.float32(0.0),), (jnp.float32(1.0),))
    ad = np.asarray(ad, np.float64)

    def fd(step):
        sp = _apply(scene, path, step * direction)
        sm = _apply(scene, path, -step * direction)
        ip = tm64(golden_from_scene(sp, camera, CFG.max_depth, CFG.bias).render())
        im = tm64(golden_from_scene(sm, camera, CFG.max_depth, CFG.bias).render())
        return (ip - im) / (2.0 * step)

    fd1 = fd(h)
    fd2 = fd(h / 2)

    # Luminance-space operators divide by the input luminance with no
    # zero guard, exactly like the reference (RaytracingEngine.cpp:106-110)
    # — a pure-black (fully shadowed) pixel is non-finite in BOTH
    # implementations; exclude it from the comparison.
    finite = (
        np.isfinite(fd1).all(axis=-1)
        & np.isfinite(fd2).all(axis=-1)
        & np.isfinite(ad).all(axis=-1)
    )
    scale = np.abs(np.where(finite[..., None], fd1, 0.0)).max() + 1e-6
    stable = finite & (
        np.abs(np.where(finite[..., None], fd1 - fd2, 0.0)).max(axis=-1)
        < 0.05 * scale + 1e-4
    )
    frac = stable.mean()
    assert frac > 0.8, f"{op}/{path}: only {frac:.0%} of pixels FD-stable"

    err = np.abs(ad - fd2)[stable]
    rel = err.max() / scale
    assert rel < 0.02, f"{op}/{path}: max rel err {rel:.4f} (scale {scale:.4g})"
    assert np.abs(fd2[stable]).max() > 0
