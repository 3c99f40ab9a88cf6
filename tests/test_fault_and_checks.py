"""Fault-tolerant tiled rendering + checkify guards."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracingengine.parallel.fault import render_hdr_faulttolerant
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scenes.builders import baseline_sphere_scene
from raytracingengine.utils.checks import assert_finite, checked


def test_faulttolerant_matches_plain():
    scene, camera = baseline_sphere_scene(width=24, height=20, spp=1)
    cfg = RenderConfig(chunk_size=480)
    plain = np.asarray(render_hdr(scene, camera, cfg))
    events = []
    ft = render_hdr_faulttolerant(
        scene, camera, cfg, tile_rows=4,
        on_event=lambda e, f: events.append((e, f)),
    )
    np.testing.assert_allclose(ft, plain, rtol=1e-5, atol=1e-6)
    assert sum(1 for e, _ in events if e == "band_ok") == 4


def test_faulttolerant_retries_transient_failure(monkeypatch):
    scene, camera = baseline_sphere_scene(width=16, height=16, spp=1)
    cfg = RenderConfig(chunk_size=256)
    calls = {"n": 0}
    import raytracingengine.parallel.fault as fault_mod

    real = fault_mod._render_chunk

    def flaky(*args, **kwargs):
        calls["n"] += 1
        # Fail at first trace: later bands reuse the compiled function and
        # never re-enter Python, so the injection must hit trace time.
        if calls["n"] == 1:
            raise RuntimeError("injected device fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(fault_mod, "_render_chunk", flaky)
    events = []
    img = render_hdr_faulttolerant(
        scene, camera, cfg, tile_rows=2, max_retries=2,
        on_event=lambda e, f: events.append(e),
    )
    assert np.isfinite(img).all()
    assert "band_retry" in events and events.count("band_ok") == 2


def test_checkify_flags_nan():
    f = checked(lambda x: jnp.log(x) * 2.0)
    err, out = f(jnp.asarray(-1.0))
    try:
        err.throw()
        raised = False
    except Exception:
        raised = True
    assert raised

    err2, out2 = f(jnp.asarray(2.0))
    err2.throw()  # no error


def test_assert_finite():
    assert_finite({"a": jnp.ones(3)}, "ok")
    try:
        assert_finite({"a": jnp.asarray([1.0, jnp.nan])}, "bad")
        raised = False
    except FloatingPointError:
        raised = True
    assert raised
