"""Device-mesh construction for tile-sharded rendering.

The reference's only parallelism is one GL workgroup per pixel on a single GPU
(main.cpp:229-235). The JAX analog: shard the (H, W) pixel grid over a
2-D ``jax.sharding.Mesh`` with axes ('dx', 'dy'), scene parameters replicated.
Forward rendering is communication-free (rays are independent); only gradient
all-reduce and the final image gather cross devices (NVLink between the
cards of a host; SURVEY.md §2 parallelism). Every card reaches every other
at the same rate, so the mesh shape follows the image, not a topology.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_X = "dx"  # image rows
AXIS_Y = "dy"  # image cols


def _factor2(n: int) -> tuple[int, int]:
    """Near-square factorization of n (prefers more row shards)."""
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def make_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """A 2-D ('dx', 'dy') mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = _factor2(n)
    assert shape[0] * shape[1] == n, f"mesh {shape} != {n} devices"
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (AXIS_X, AXIS_Y))


def tile_spec() -> P:
    """PartitionSpec for (H, W, ...) image/ray arrays: tiles over the mesh."""
    return P(AXIS_X, AXIS_Y)


def replicated_spec() -> P:
    return P()


def image_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(AXIS_X, AXIS_Y, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
