"""Gradient fidelity (BASELINE config #3): autodiff pixel gradients vs
central finite differences on the fp64 golden oracle.

For each target parameter (sphere center/radius, albedo, light
position/intensity, plane point) we:
  * compute the per-pixel directional derivative with jax.jvp (forward
    mode — exact, works through every integrator path),
  * compute a central finite difference of the *golden fp64* renderer
    along the same direction,
  * compare on the stable-pixel mask: pixels whose FD estimate is
    Richardson-consistent between h and h/2. Hard visibility and
    silhouette edges are genuinely discontinuous — FD there measures the
    jump, not a derivative — so those pixels are excluded; the mask must
    still cover most of the image.
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

W = H = 24
CFG = RenderConfig(chunk_size=W * H, shadow_mode="binary")


def _scene():
    return baseline_sphere_scene(width=W, height=H, spp=1)


def _apply(scene, path, delta):
    """Add delta at scene.<path> (dot path, supports [i,j] leaf offsets)."""

    def upd(obj, parts):
        name = parts[0]
        child = getattr(obj, name)
        if len(parts) == 1:
            return dataclasses.replace(obj, **{name: child + delta})
        return dataclasses.replace(obj, **{name: upd(child, parts[1:])})

    return upd(scene, path.split("."))


def _direction_like(scene, path):
    """Unit perturbation array matching scene.<path>'s leaf shape."""
    obj = scene
    for p in path.split("."):
        obj = getattr(obj, p)
    d = np.zeros(obj.shape, np.float64)
    flat = d.reshape(-1)
    flat[0] = 1.0  # perturb the first component
    return d


PARAMS = [
    ("spheres.centers", 2e-3),
    ("spheres.radii", 2e-3),
    ("spheres.materials.color", 2e-3),
    ("lights.positions", 2e-3),
    ("lights.intensities", 1e-2),
    ("planes.points", 2e-3),
]


def _golden_render(scene, camera):
    g = golden_from_scene(scene, camera, CFG.max_depth, CFG.bias)
    return g.render()


@pytest.mark.parametrize("path,h", PARAMS)
def test_ad_matches_fd(path, h):
    scene, camera = _scene()
    direction = _direction_like(scene, path)

    # AD: directional derivative via jvp
    def f(eps):
        s = _apply(scene, path, eps * jnp.asarray(direction, jnp.float32))
        return render_hdr(s, camera, CFG)

    _, ad = jax.jvp(f, (jnp.float32(0.0),), (jnp.float32(1.0),))
    ad = np.asarray(ad, np.float64)

    # FD on the fp64 golden, h and h/2
    def fd(step):
        sp = _apply(scene, path, step * direction)
        sm = _apply(scene, path, -step * direction)
        ip = _golden_render(sp, camera)
        im = _golden_render(sm, camera)
        return (ip - im) / (2.0 * step)

    fd1 = fd(h)
    fd2 = fd(h / 2)

    scale = np.abs(fd1).max() + 1e-6
    stable = np.abs(fd1 - fd2).max(axis=-1) < 0.05 * scale + 1e-4
    frac = stable.mean()
    assert frac > 0.8, f"{path}: only {frac:.0%} of pixels FD-stable"

    err = np.abs(ad - fd2)[stable]
    rel = err.max() / scale
    assert rel < 0.02, f"{path}: max rel err {rel:.4f} (scale {scale:.4g})"
    # And the derivative must be nontrivial somewhere
    assert np.abs(fd2[stable]).max() > 0 or np.abs(ad).max() == 0
