"""Culled Pallas engine (ops/pallas_culled.py): the broad phase is shared
with ops/accel.py verbatim, so the contract here is that the Triton narrow
phases reproduce the culled engine's outputs — discrete records identical,
continuous fields to fp tolerance — and that the shared analytic VJP makes
engine='culled_pallas' exactly as differentiable as engine='culled'.

On CPU (this test environment) the kernels run in interpret mode;
chip_smoke.py compiles them through Triton on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops.accel import (
    culled_geometry,
    suggest_cull_config,
    suggest_cull_sizes,
    tile_image,
)
from openglraytracer_tpu.ops.geometry import geometry_op
from openglraytracer_tpu.ops.pallas_culled import culled_geometry_pallas
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import render, trace_rays_fast
from openglraytracer_tpu.train.inverse import apply_params, extract_params

TILE = (16, 16)          # tile_p = 256: one program of BLOCK_RAYS rays
TILE_P = TILE[0] * TILE[1]
H = W = 64


def _tiled_rays(cam, h=H, w=W):
    origins, dirs = generate_rays(cam, h, w)
    o = tile_image(origins, *TILE).reshape(-1, 3)
    d = tile_image(dirs, *TILE).reshape(-1, 3)
    return o, d


def _animated_scene():
    from openglraytracer_tpu.models.animated import reference_frame
    return reference_frame(1.2)


def _assert_matches_culled(scene, o, d, kp, ks, hot_m=0, kb=0, ksb=0,
                           shadow_lights=None):
    hit_p, occ_p, aux_p = culled_geometry_pallas(
        scene, o, d, TILE_P, kp, ks, shadow_lights, hot_m, kb, ksb)
    hit_c, occ_c, aux_c = culled_geometry(
        scene, o, d, TILE_P, kp, ks, shadow_lights, hot_m, kb, ksb)

    # discrete record identical
    np.testing.assert_array_equal(np.asarray(hit_p.hit),
                                  np.asarray(hit_c.hit))
    np.testing.assert_array_equal(np.asarray(hit_p.obj_id),
                                  np.asarray(hit_c.obj_id))
    np.testing.assert_array_equal(np.asarray(hit_p.material_id),
                                  np.asarray(hit_c.material_id))
    np.testing.assert_array_equal(np.asarray(hit_p.inside),
                                  np.asarray(hit_c.inside))
    # occlusion identical everywhere the primary ray hit
    hm = np.asarray(hit_c.hit)[:, None]
    np.testing.assert_array_equal(np.asarray(occ_p) & hm,
                                  np.asarray(occ_c) & hm)
    # continuous fields: same formulas, but per-survivor scalar layout =>
    # different FMA contraction => allclose, not bit-equal. Normals/points
    # are compared on hits only: for t beyond the 10000 miss bound the
    # culled path leaves a stale (gated-off) plane normal where the kernel
    # writes zero — both are dead values, shading gates on hit.hit.
    np.testing.assert_allclose(np.asarray(hit_p.t), np.asarray(hit_c.t),
                               rtol=5e-5, atol=1e-4)
    hm3 = np.asarray(hit_c.hit)[:, None]
    np.testing.assert_allclose(np.asarray(hit_p.n) * hm3,
                               np.asarray(hit_c.n) * hm3,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(hit_p.p) * hm3,
                               np.asarray(hit_c.p) * hm3,
                               rtol=5e-4, atol=5e-4)
    # aux (the VJP routing structure + overflow contract) identical
    np.testing.assert_array_equal(np.asarray(aux_p.p_idx),
                                  np.asarray(aux_c.p_idx))
    np.testing.assert_array_equal(np.asarray(aux_p.p_count),
                                  np.asarray(aux_c.p_count))
    np.testing.assert_array_equal(np.asarray(aux_p.s_count),
                                  np.asarray(aux_c.s_count))
    np.testing.assert_array_equal(np.asarray(aux_p.s_overflow),
                                  np.asarray(aux_c.s_overflow))
    np.testing.assert_array_equal(np.asarray(aux_p.j_local),
                                  np.asarray(aux_c.j_local))
    np.testing.assert_array_equal(np.asarray(aux_p.jb_local),
                                  np.asarray(aux_c.jb_local))
    np.testing.assert_array_equal(np.asarray(aux_p.b_count),
                                  np.asarray(aux_c.b_count))
    return hit_p, occ_p, aux_p


def test_culled_pallas_matches_culled_spheres():
    scene, cam = sphere_grid_scene(8)
    kp, ks = suggest_cull_sizes(scene, cam, H, W, TILE)
    o, d = _tiled_rays(cam)
    _assert_matches_culled(scene, o, d, kp, ks)


@pytest.mark.smoke
def test_culled_pallas_matches_exact():
    """Transitivity check straight against the dense XLA scan."""
    scene, cam = sphere_grid_scene(8)
    kp, ks = suggest_cull_sizes(scene, cam, H, W, TILE)
    o, d = _tiled_rays(cam)
    hit_p, occ_p, _ = culled_geometry_pallas(scene, o, d, TILE_P, kp, ks)
    hit_x, occ_x = geometry_op(scene, o, d, "xla", 512)
    np.testing.assert_array_equal(np.asarray(hit_p.obj_id),
                                  np.asarray(hit_x.obj_id))
    np.testing.assert_array_equal(np.asarray(hit_p.hit),
                                  np.asarray(hit_x.hit))
    hm = np.asarray(hit_x.hit)[:, None]
    np.testing.assert_array_equal(np.asarray(occ_p) & hm,
                                  np.asarray(occ_x) & hm)
    np.testing.assert_allclose(np.asarray(hit_p.t), np.asarray(hit_x.t),
                               rtol=5e-5, atol=1e-4)


def test_culled_pallas_hot_tiles():
    """hot_m > 0: the dense hot-tile shadow override must compose with the
    kernel's cold-tile survivor scan exactly as in accel.py."""
    scene, cam = sphere_grid_scene(8)
    kp, ks = suggest_cull_sizes(scene, cam, H, W, TILE)
    o, d = _tiled_rays(cam)
    # shrink ks to force real cold/hot divergence, hot pass covers the top 4
    _assert_matches_culled(scene, o, d, kp, max(2, ks // 2), hot_m=4)


def test_culled_pallas_obb_scene():
    """The reference's 5-object world (4 OBBs + 1 sphere + planes-free):
    box slab narrow phase in-kernel, merged with sphere winners in
    global-id order."""
    scene, cam = _animated_scene()
    assert scene.boxes.count > 0 and scene.spheres.count > 0
    from openglraytracer_tpu.ops.accel import parse_cull_spec
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    o, d = _tiled_rays(cam)
    _assert_matches_culled(scene, o, d, kp, ks, hot_m, kb, ksb)


def test_culled_pallas_render_image():
    scene, cam = sphere_grid_scene(8)
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    a = render(scene, cam, H, W, engine="culled", cull=spec)
    b = render(scene, cam, H, W, engine="culled_pallas", cull=spec)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5)
    x = render(scene, cam, H, W, engine="xla")
    np.testing.assert_allclose(np.asarray(b), np.asarray(x), atol=1e-5)


def test_culled_pallas_obb_render_image():
    scene, cam = _animated_scene()
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    a = render(scene, cam, H, W, engine="culled", cull=spec)
    b = render(scene, cam, H, W, engine="culled_pallas", cull=spec)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5)


def test_culled_pallas_gradients_match_culled():
    """The VJP is accel.py's tile-structured backward reused verbatim; with
    identical (hit, aux) residuals the gradients must agree to fp noise."""
    scene, cam = _animated_scene()
    from openglraytracer_tpu.ops.accel import parse_cull_spec
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    o, d = _tiled_rays(cam)
    target = jnp.zeros((H * W, 3), jnp.float32)
    trainable = ("boxes.position", "boxes.angles", "spheres.center",
                 "spheres.radius", "materials.diffuse")
    params = extract_params(scene, trainable)
    cull = (TILE_P, kp, ks, hot_m, kb, ksb)

    def loss(params, engine):
        s = apply_params(scene, params)
        img = trace_rays_fast(s, o, d, 0, engine=engine, cull=cull)
        return jnp.mean(jnp.square(img - target))

    g_c = jax.grad(loss)(params, "culled")
    g_p = jax.grad(loss)(params, "culled_pallas")
    for k in params:
        a, b = np.asarray(g_c[k]), np.asarray(g_p[k])
        scale = max(np.abs(a).max(), 1e-8)
        np.testing.assert_allclose(b, a, atol=1e-4 * scale,
                                   err_msg=f"grad mismatch for {k}")


def test_culled_pallas_box_only_scene():
    from openglraytracer_tpu.models.scene import Spheres
    scene, cam = _animated_scene()
    empty_sph = Spheres(center=jnp.zeros((0, 3), jnp.float32),
                        radius=jnp.zeros((0,), jnp.float32),
                        material_id=jnp.zeros((0,), jnp.int32))
    scene = scene._replace(spheres=empty_sph)
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    a = render(scene, cam, H, W, engine="culled", cull=spec)
    b = render(scene, cam, H, W, engine="culled_pallas", cull=spec)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5)


def test_culled_pallas_overflow_reporting():
    """Undersized K lists must report the same nonzero overflow scalar as
    the culled engine (never-silent contract)."""
    from openglraytracer_tpu.ops.accel import cull_overflow_count
    scene, cam = sphere_grid_scene(8)
    o, d = _tiled_rays(cam)
    _, _, aux_p = culled_geometry_pallas(scene, o, d, TILE_P, 2, 2)
    _, _, aux_c = culled_geometry(scene, o, d, TILE_P, 2, 2)
    assert int(cull_overflow_count(aux_p)) == int(cull_overflow_count(aux_c))
    assert int(cull_overflow_count(aux_p)) > 0


@pytest.mark.parametrize("tile_p,expect", [
    (4096, (256, 4096)),    # c3: 16 programs per tile
    (1024, (256, 1024)),    # c5: 4 programs per tile
    (256, (256, 256)),
    (144, (256, 256)),      # 12x12 tile: one program, 112 padding rays
    (300, (256, 512)),      # two programs, 212 padding rays
    (64, (64, 64)),         # small tile: one program of the whole tile
])
def test_ray_block_split_and_padding(tile_p, expect):
    from openglraytracer_tpu.ops.pallas_culled import ray_block
    assert ray_block(tile_p) == expect


def test_culled_pallas_pads_unaligned_tile():
    """A 12x12 tile (144 rays) runs in one 256-ray program: the padding
    rays are sliced off and the result matches the culled engine."""
    scene, cam = sphere_grid_scene(4)
    tile = (12, 12)
    origins, dirs = generate_rays(cam, 48, 48)
    o = tile_image(origins, *tile).reshape(-1, 3)
    d = tile_image(dirs, *tile).reshape(-1, 3)
    kp, ks = suggest_cull_sizes(scene, cam, 48, 48, tile)
    hit_p, occ_p, aux_p = culled_geometry_pallas(scene, o, d, 144, kp, ks)
    hit_c, occ_c, aux_c = culled_geometry(scene, o, d, 144, kp, ks)
    np.testing.assert_array_equal(np.asarray(hit_p.obj_id),
                                  np.asarray(hit_c.obj_id))
    np.testing.assert_array_equal(np.asarray(occ_p), np.asarray(occ_c))
    np.testing.assert_array_equal(np.asarray(aux_p.j_local),
                                  np.asarray(aux_c.j_local))
    np.testing.assert_allclose(np.asarray(hit_p.t), np.asarray(hit_c.t),
                               rtol=5e-5, atol=1e-4)


def test_culled_pallas_splits_tile_into_programs(monkeypatch):
    """BLOCK_RAYS below the tile size: each tile runs as several programs
    (grid (T, tile_p / BR)), each reading the same survivor rows."""
    from openglraytracer_tpu.ops import pallas_culled
    monkeypatch.setattr(pallas_culled, "BLOCK_RAYS", 64)
    assert pallas_culled.ray_block(TILE_P) == (64, TILE_P)
    scene, cam = _animated_scene()
    from openglraytracer_tpu.ops.accel import parse_cull_spec
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    o, d = _tiled_rays(cam)
    _assert_matches_culled(scene, o, d, kp, ks, hot_m, kb, ksb)


@pytest.mark.parametrize("platform,expect", [("cpu", True), ("gpu", False)])
def test_interpret_mode(platform, expect):
    from openglraytracer_tpu.ops.pallas_culled import interpret_mode
    assert interpret_mode(platform) is expect


@pytest.mark.parametrize("platform", ["tpu", "rocm", "metal"])
def test_interpret_mode_rejects_other_platforms(platform):
    from openglraytracer_tpu.ops.pallas_culled import interpret_mode
    with pytest.raises(RuntimeError, match=platform):
        interpret_mode(platform)


def test_box_rows_padded_and_origin_local():
    """Primary box rows: 21 used columns padded to 24 with zeros; slots 6:9
    hold R^T (o0 - pos), computed at full float32 precision."""
    from openglraytracer_tpu.ops.accel import _box_table
    from openglraytracer_tpu.ops.pallas_culled import _primary_box_rows
    scene, _ = _animated_scene()
    m = scene.boxes.count
    o0 = jnp.asarray([0.3, -1.2, 4.0], jnp.float32)
    idx = jnp.arange(m, dtype=jnp.int32)[None, :]
    rows = np.asarray(_primary_box_rows(scene, o0, idx,
                                        jnp.ones((1, m), bool)))
    assert rows.shape == (1, m, 24)
    np.testing.assert_array_equal(rows[..., 21:], 0.0)
    np.testing.assert_array_equal(rows[..., 20], 1.0)
    tab = np.asarray(_box_table(scene), np.float64)
    rot = tab[:, 9:18].reshape(m, 3, 3)
    ro = np.einsum("kij,ki->kj", rot, np.asarray(o0, np.float64) - tab[:, 6:9])
    np.testing.assert_allclose(rows[0, :, 6:9], ro, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Trip counts: each tile's survivor loop runs its measured survivor count
# (read from a global int32 table). Rows past the count are invalid padding,
# so scanning every row of every list must give the identical result —
# "full" forces that, "dynamic" is the shipped trip count.
# ---------------------------------------------------------------------------

@pytest.fixture(params=["dynamic", "full"])
def trip_mode(request, monkeypatch):
    if request.param == "full":
        from openglraytracer_tpu.ops import pallas_culled
        monkeypatch.setattr(
            pallas_culled, "_trip_counts",
            lambda count, k: jnp.full(count.shape, k, jnp.int32))
    return request.param


def test_dynamic_counts_match_culled_spheres(trip_mode):
    scene, cam = sphere_grid_scene(8)
    kp, ks = suggest_cull_sizes(scene, cam, H, W, TILE)
    o, d = _tiled_rays(cam)
    _assert_matches_culled(scene, o, d, kp, ks)


def test_dynamic_counts_match_culled_obb(trip_mode):
    scene, cam = _animated_scene()
    from openglraytracer_tpu.ops.accel import parse_cull_spec
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    o, d = _tiled_rays(cam)
    _assert_matches_culled(scene, o, d, kp, ks, hot_m, kb, ksb)


def test_dynamic_counts_hot_tiles(trip_mode):
    """Hot tiles' sphere counts are zeroed (the dense pass overrides their
    occlusion) — the composition must still match accel.py exactly."""
    scene, cam = sphere_grid_scene(8)
    kp, ks = suggest_cull_sizes(scene, cam, H, W, TILE)
    o, d = _tiled_rays(cam)
    _assert_matches_culled(scene, o, d, kp, max(2, ks // 2), hot_m=4)


def test_dynamic_counts_gradients(trip_mode):
    scene, cam = sphere_grid_scene(4)
    kp, ks = suggest_cull_sizes(scene, cam, H, W, TILE)
    o, d = _tiled_rays(cam)
    target = jnp.zeros((H * W, 3), jnp.float32)
    params = extract_params(scene, ("spheres.center", "materials.diffuse"))
    cull = (TILE_P, kp, ks)

    def loss(params, engine):
        s = apply_params(scene, params)
        img = trace_rays_fast(s, o, d, 0, engine=engine, cull=cull)
        return jnp.mean(jnp.square(img - target))

    g_c = jax.grad(loss)(params, "culled")
    g_p = jax.grad(loss)(params, "culled_pallas")
    for k in params:
        a, b = np.asarray(g_c[k]), np.asarray(g_p[k])
        scale = max(np.abs(a).max(), 1e-8)
        # 3e-4: the kernel's per-survivor scalar contraction rounds hit.p/t
        # differently from the culled engine's vector layout; the shared VJP
        # then replays those slightly-different residuals
        np.testing.assert_allclose(b, a, atol=3e-4 * scale,
                                   err_msg=f"grad mismatch for {k}")
