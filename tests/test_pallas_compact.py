"""Survivor compaction (accel.compact_mask, cumsum-rank stream compaction)
against a lax.top_k reference: identical (idx-where-valid, valid, count) on
every mask shape class the broad phase produces — random, empty tiles, full
tiles, overflow — plus whole-engine equality with either compaction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openglraytracer_tpu.ops import accel
from openglraytracer_tpu.ops.accel import compact_mask


def _topk_reference(mask, k):
    n = mask.shape[-1]
    key = jnp.where(mask, jnp.arange(n, 0, -1, dtype=jnp.int32)[None, :], 0)
    vals, idx = jax.lax.top_k(key, min(k, n))
    return idx.astype(jnp.int32), vals > 0, jnp.sum(mask, axis=-1,
                                                    dtype=jnp.int32)


def _assert_same(mask, k):
    ia, va, ca = _topk_reference(mask, k)
    ib, vb, cb = compact_mask(mask, k)
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
    np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
    # idx is unspecified where ~valid in both implementations
    np.testing.assert_array_equal(np.asarray(ia * va), np.asarray(ib * vb))


@pytest.mark.parametrize("t,n,k,p", [
    (4, 128, 8, 0.05),
    (7, 300, 16, 0.1),      # unaligned T and N
    (16, 1024, 32, 0.02),
    (8, 256, 4, 0.5),       # heavy overflow (count >> k)
    (3, 64, 64, 0.9),       # k == n, nearly full
])
def test_matches_topk_random(t, n, k, p):
    rng = np.random.default_rng(t * 1000 + n)
    mask = jnp.asarray(rng.random((t, n)) < p)
    _assert_same(mask, k)


def test_empty_and_full_tiles():
    t, n, k = 6, 256, 16
    mask = np.zeros((t, n), bool)
    mask[1] = True                      # full tile: count n >> k, overflow
    mask[3, ::7] = True
    _assert_same(jnp.asarray(mask), k)


def test_single_survivor_positions():
    # the ascending-order contract: survivor j emitted at slot rank(j)
    t, n, k = 4, 512, 8
    mask = np.zeros((t, n), bool)
    mask[0, [5, 100, 511]] = True
    mask[2, [0]] = True
    idx, valid, count = compact_mask(jnp.asarray(mask), k)
    np.testing.assert_array_equal(np.asarray(idx[0, :3]), [5, 100, 511])
    assert bool(valid[0, 2]) and not bool(valid[0, 3])
    np.testing.assert_array_equal(np.asarray(idx[2, :1]), [0])
    np.testing.assert_array_equal(np.asarray(count), [3, 0, 1, 0])


def test_under_jit_and_gridless_shapes():
    mask = jnp.asarray(np.random.default_rng(0).random((5, 200)) < 0.1)
    f = jax.jit(lambda m: compact_mask(m, 12))
    ia, va, ca = f(mask)
    ib, vb, cb = _topk_reference(mask, 12)
    np.testing.assert_array_equal(np.asarray(ia * va), np.asarray(ib * vb))
    np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))


@pytest.mark.smoke
def test_engine_equality_forced_both_impls(monkeypatch):
    """The whole culled engine renders identically with the compaction
    swapped for the top_k reference (the real integration contract)."""
    from openglraytracer_tpu.models.builders import sphere_grid_scene
    from openglraytracer_tpu.ops.accel import suggest_cull_config
    from openglraytracer_tpu.ops.render import render

    scene, cam = sphere_grid_scene(4)
    spec = suggest_cull_config(scene, cam, 64, 64, (16, 16))
    imgs = {}
    for impl in ("topk", "cumsum"):
        if impl == "topk":
            monkeypatch.setattr(accel, "compact_mask", _topk_reference)
        else:
            monkeypatch.undo()
        jax.clear_caches()      # the compaction is chosen at trace time
        imgs[impl] = np.asarray(render(scene, cam, 64, 64, engine="culled",
                                       cull=spec))
    np.testing.assert_array_equal(imgs["topk"], imgs["cumsum"])
