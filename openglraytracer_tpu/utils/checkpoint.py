"""Checkpoints for the inverse-rendering fit (params + optimizer state +
step): one ``np.savez`` of the flattened pytree per save. The forward
renderer itself needs no checkpoints — it is a pure function of (scene,
time), preserving the reference's statelessness (SURVEY.md §5)."""

from __future__ import annotations

import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger(__name__)

KEEP = 3


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.npz")


def _steps(directory: str) -> list[int]:
    names = glob.glob(os.path.join(directory, "step_*.npz"))
    return sorted(int(os.path.basename(n)[5:-4]) for n in names)


def save(directory: str, state, step: int) -> None:
    """Write `state`'s leaves to <directory>/step_<step>.npz (atomically:
    a temporary file renamed into place) and keep the KEEP newest."""
    os.makedirs(directory, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(state)
    tmp = os.path.join(directory, f".tmp_step_{step}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, *[np.asarray(x) for x in leaves])
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-KEEP]:
        os.remove(_path(directory, old))


def restore_latest(directory: str, abstract_state):
    """Restore the newest checkpoint into the structure of abstract_state,
    or None if none exists."""
    steps = _steps(directory) if os.path.isdir(directory) else []
    if not steps:
        return None
    leaves, treedef = jax.tree_util.tree_flatten(abstract_state)
    with np.load(_path(directory, steps[-1])) as data:
        saved = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint step {steps[-1]} in {directory} holds "
                         f"{len(saved)} arrays, the state has {len(leaves)}")
    restored = [type(ref)(x) if isinstance(ref, (int, float))
                else jnp.asarray(x, dtype=jnp.asarray(ref).dtype)
                for ref, x in zip(leaves, saved)]
    log.info("restored checkpoint step %d from %s", steps[-1], directory)
    return jax.tree_util.tree_unflatten(treedef, restored)
