"""Gradient-descent inverse rendering (BASELINE config #4).

Builds a jitted train step: render the current scene, L2 against a target
image, backprop through the whole differentiable pipeline (camera rays ->
intersection -> shading -> integrator -> optional tonemap), optax update.
With a mesh, the render is GSPMD-sharded over rays and scene-parameter
gradients psum across the mesh inside the backward pass.

Use a differentiable config (chain integrator on opaque scenes +
shadow_mode 'binary'/'soft', or differentiable=True for the march).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from raytracingengine.core.camera import Camera
from raytracingengine.inverse.loss import l2_image_loss
from raytracingengine.inverse.params import combine, partition
from raytracingengine.render.config import RenderConfig
from raytracingengine.render.pipeline import render_hdr
from raytracingengine.scene import Scene


def masked_optimizer(
    inner: optax.GradientTransformation, mask
) -> optax.GradientTransformation:
    """Apply `inner` where mask is True; freeze (zero-update) elsewhere.

    (Note optax.masked alone is wrong for freezing: it passes the
    complement's raw gradients through as updates.)
    """
    labels = jax.tree.map(
        lambda m: "train" if m else "freeze",
        mask,
        is_leaf=lambda x: x is None or isinstance(x, bool),
    )
    return optax.multi_transform(
        {"train": inner, "freeze": optax.set_to_zero()}, labels
    )


@dataclasses.dataclass
class TrainState:
    params: Any
    static: Any
    opt_state: Any
    step: int = 0


def make_train_step(
    camera: Camera,
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    mesh=None,
    loss_fn: Callable = l2_image_loss,
    tonemap: Callable | None = None,
    mode: str | None = None,
):
    """-> jitted (params, static, opt_state, target, key) ->
    (params, opt_state, loss, grads)."""

    def loss_of(params, static, target, key):
        scene = combine(params, static)
        img = render_hdr(scene, camera, cfg, key=key, mode=mode, mesh=mesh)
        if tonemap is not None:
            img = tonemap(img)
        return loss_fn(img, target)

    @jax.jit
    def step(params, static, opt_state, target, key):
        loss, grads = jax.value_and_grad(loss_of)(params, static, target, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grads

    return step


def fit(
    scene_init: Scene,
    camera: Camera,
    cfg: RenderConfig,
    target: jnp.ndarray,
    steps: int = 200,
    learning_rate: float = 1e-2,
    optimizer: optax.GradientTransformation | None = None,
    mesh=None,
    key: jnp.ndarray | None = None,
    mode: str | None = None,
    callback: Callable[[int, float], None] | None = None,
) -> tuple[Scene, list[float]]:
    """Run the full optimization loop; returns (fitted scene, loss curve)."""
    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    if key is None:
        key = jax.random.PRNGKey(0)
    params, static = partition(scene_init)
    opt_state = optimizer.init(params)
    train_step = make_train_step(camera, cfg, optimizer, mesh=mesh, mode=mode)
    losses = []
    for i in range(steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss, _ = train_step(
            params, static, opt_state, target, sub
        )
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])
    return combine(params, static), losses
