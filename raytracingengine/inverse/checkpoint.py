"""Checkpoint/resume for the inverse-rendering loop (orbax).

orbax-checkpoint is an optional dependency (`pip install .[checkpoint]`),
imported only when a checkpoint is saved or restored. The reference has no
checkpointing (its render is one-shot; SURVEY.md §5); this is for long
optimizations: scene params +
optimizer state + step counter, atomically saved and restorable.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def _drop_empty(tree):
    """Orbax cannot serialize zero-size arrays (empty primitive blocks);
    replace them with None and restore them from the `like` template."""
    return jax.tree.map(lambda x: None if np.asarray(x).size == 0 else x, tree)


def save_checkpoint(path: str, params: Any, opt_state: Any, step: int) -> None:
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    state = {
        "params": _drop_empty(params),
        "opt_state": _drop_empty(opt_state),
        "step": np.asarray(step, np.int64),
    }
    ckpt.save(path, state, force=True)
    ckpt.wait_until_finished()


def restore_checkpoint(path: str, like: dict) -> dict:
    """`like` is a matching-structure pytree of abstract or concrete values
    (e.g. {"params": params0, "opt_state": opt_state0, "step": 0})."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    like = dict(like)
    like.setdefault("step", np.asarray(0, np.int64))
    slim = {
        "params": _drop_empty(like["params"]),
        "opt_state": _drop_empty(like["opt_state"]),
        "step": like["step"],
    }
    restored = ckpt.restore(path, slim)

    def refill(r, l):
        return jax.tree.map(
            lambda a, b: b if a is None else a, r, l,
            is_leaf=lambda x: x is None,
        )

    return {
        "params": refill(restored["params"], like["params"]),
        "opt_state": refill(restored["opt_state"], like["opt_state"]),
        "step": restored["step"],
    }
