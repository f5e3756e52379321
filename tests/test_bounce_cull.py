"""Secondary-ray culling (VERDICT r2 next #4): bounce children of a culled
trace previously fell back to the dense O(rays x N) scan — mirror scenes
could not scale past ~64 objects. The bounce-cone broad phase
(accel.bounce_cones + the per-ray-origin narrow phase) must be a pure
acceleration: identical images, identical gradients, never-silent overflow,
matching the reflection push it accelerates (raytrace_compute.glsl:979-997).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.models.scene import make_camera
from openglraytracer_tpu.ops.accel import (
    bounce_cull_counts,
    parse_cull_spec,
    suggest_child_cull_config,
    suggest_cull_config,
    tile_image,
)
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import render, trace_rays_fast
from openglraytracer_tpu.ops.shading import static_bounce_mask
from openglraytracer_tpu.train.inverse import apply_params, extract_params

TILE = (16, 16)
H, W = 48, 64


def _mirror_scene():
    scene, _ = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    cam = make_camera((0.0, -10.0, 5.5), (-25.0, 0.0, 0.0), aspect=W / H)
    return scene, cam


def _specs(scene, cam):
    cull = suggest_cull_config(scene, cam, H, W, TILE, headroom=1.5)
    child = suggest_child_cull_config(scene, cam, H, W, cull, headroom=1.5)
    return cull, child


def _tiled_rays(cam):
    origins, dirs = generate_rays(cam, H, W)
    return (tile_image(origins, *TILE).reshape(-1, 3),
            tile_image(dirs, *TILE).reshape(-1, 3))


def test_child_cull_is_conservative():
    """Every object a reflected ray actually hits must survive the bounce
    cones of its tile (conservativeness = the correctness contract)."""
    from openglraytracer_tpu.ops.geometry import geometry_op
    from openglraytracer_tpu.ops.render import BOUNCE_EPS
    from openglraytracer_tpu.ops.transforms import reflect

    scene, cam = _mirror_scene()
    cull, _ = _specs(scene, cam)
    o, d = _tiled_rays(cam)
    hit, _ = geometry_op(scene, o, d, "xla", 512)
    refl = scene.materials.reflectivity[hit.material_id]
    active = hit.hit & (refl > 0.0)
    co = hit.p + hit.n * BOUNCE_EPS
    cd = reflect(d, hit.n)
    child_hit, _ = geometry_op(scene, co, cd, "xla", 512)

    from openglraytracer_tpu.ops.accel import bounce_cones, sphere_vs_cone
    tile_p = TILE[0] * TILE[1]
    t_tiles = o.shape[0] // tile_p
    act_t = active.reshape(t_tiles, tile_p)
    apex, axis, cos_half, rho, empty = bounce_cones(
        co.reshape(t_tiles, tile_p, 3), cd.reshape(t_tiles, tile_p, 3),
        act_t)
    mask = np.asarray(sphere_vs_cone(apex, axis, cos_half,
                                     scene.spheres.center,
                                     scene.spheres.radius, expand=rho))
    obj = np.asarray(child_hit.obj_id).reshape(t_tiles, tile_p)
    hm = (np.asarray(child_hit.hit & active).reshape(t_tiles, tile_p)
          & (obj >= 0) & (obj < int(scene.spheres.count)))
    for t in range(t_tiles):
        for gid in np.unique(obj[t][hm[t]]):
            assert mask[t, gid], f"tile {t}: hit sphere {gid} was culled"


def test_child_culled_discrete_matches_dense():
    """The child narrow phase mirrors the exact ops: hit t / obj / normals /
    occlusion of the bounce-culled pass are BIT-identical to the dense
    scan's wherever the child ray is live."""
    from openglraytracer_tpu.ops.accel import bounce_culled_geometry_op
    from openglraytracer_tpu.ops.geometry import geometry_op
    from openglraytracer_tpu.ops.render import BOUNCE_EPS
    from openglraytracer_tpu.ops.transforms import reflect

    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    o, d = _tiled_rays(cam)
    hit, _ = geometry_op(scene, o, d, "xla", 512)
    active = hit.hit & (scene.materials.reflectivity[hit.material_id] > 0.0)
    co = hit.p + hit.n * BOUNCE_EPS
    cd = reflect(d, hit.n)
    hx, ox = geometry_op(scene, co, cd, "xla", 512)
    tile_p = TILE[0] * TILE[1]
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(child)
    hc, oc, _ = bounce_culled_geometry_op(scene, co, cd, active, tile_p,
                                          kp, ks, None, hot_m, kb, ksb)
    act = np.asarray(active)
    for name, a, b in (("t", hx.t, hc.t), ("obj_id", hx.obj_id, hc.obj_id),
                       ("hit", hx.hit, hc.hit)):
        np.testing.assert_array_equal(np.asarray(a)[act],
                                      np.asarray(b)[act], err_msg=name)
    np.testing.assert_array_equal(np.asarray(hx.n)[act],
                                  np.asarray(hc.n)[act])
    live = act & np.asarray(hx.hit)
    np.testing.assert_array_equal(np.asarray(ox)[live], np.asarray(oc)[live])


def test_child_culled_image_matches_dense():
    """Mirror scene at depth 1: the bounce-culled image equals the dense
    child scan's to float32 reassociation noise (discrete state is
    bit-identical — see test_child_culled_discrete_matches_dense; the
    last-ulp image residue is XLA fusing the same shading math differently
    in the two program shapes)."""
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    img_dense = render(scene, cam, H, W, depth=1, engine="culled", cull=cull)
    img_culled = render(scene, cam, H, W, depth=1, engine="culled",
                        cull=cull, child_cull=child)
    np.testing.assert_allclose(np.asarray(img_culled),
                               np.asarray(img_dense), atol=1e-6)


def test_child_culled_depth2_matches_dense():
    """Depth 2 recurses _trace_child_culled into itself (children of
    children reuse the bounce-cone path)."""
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    img_dense = render(scene, cam, H, W, depth=2, engine="culled", cull=cull)
    img_culled = render(scene, cam, H, W, depth=2, engine="culled",
                        cull=cull, child_cull=child)
    np.testing.assert_allclose(np.asarray(img_culled),
                               np.asarray(img_dense), atol=1e-6)


def test_child_culled_gradients_match_dense():
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    trainable = ("spheres.center", "spheres.radius", "materials.diffuse")
    params = extract_params(scene, trainable)

    def loss(params, child_cull):
        s = apply_params(scene, params)
        img = render(s, cam, H, W, depth=1, engine="culled", cull=cull,
                     child_cull=child_cull,
                     bounce_mask=static_bounce_mask(scene))
        return jnp.mean(jnp.square(img - 0.25))

    g_dense = jax.grad(loss)(params, None)
    g_culled = jax.grad(loss)(params, child)
    for k in params:
        np.testing.assert_allclose(np.asarray(g_culled[k]),
                                   np.asarray(g_dense[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_child_cull_overflow_is_counted():
    """A child Kp too small for the bounce bundles must be LOUD: the
    overflow scalar from with_cull_stats counts the dropped slots."""
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    o, d = _tiled_rays(cam)
    tile, kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    tile_p = TILE[0] * TILE[1]
    bm = static_bounce_mask(scene)

    _, ovf_ok = trace_rays_fast(
        scene, o, d, 1, engine="culled",
        cull=(tile_p,) + parse_cull_spec(cull)[1:],
        with_cull_stats=True, bounce_mask=bm,
        child_cull=(tile_p,) + parse_cull_spec(child)[1:])
    assert int(ovf_ok) == 0

    starved = (tile_p, 1, 1, 0, 0, 0)   # child lists far too small
    _, ovf_bad = trace_rays_fast(
        scene, o, d, 1, engine="culled",
        cull=(tile_p,) + parse_cull_spec(cull)[1:],
        with_cull_stats=True, bounce_mask=bm, child_cull=starved)
    assert int(ovf_bad) > 0


def test_bounce_counts_cover_observed():
    """bounce_cull_counts' maxima really bound what the child pass uses."""
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    p_count, s_count, _, _, w_count, _ = bounce_cull_counts(
        scene, cam, H, W, cull)
    _, kp_c, ks_c, _, _, _ = parse_cull_spec(child)
    # r5: Kp is a quantile cap; tiles over it must fit the hot-primary
    # budget (dense global-table pass), and the posthoc winner lists the
    # hot pass rebuilds must fit Kp (measured distinct winners)
    from openglraytracer_tpu.ops.accel import cull_hot_p
    over = int(np.sum(np.asarray(p_count) > kp_c))
    assert over <= cull_hot_p(child)
    assert int(np.max(np.asarray(w_count))) <= kp_c
    assert int(np.max(np.asarray(s_count))) <= ks_c


def test_child_culled_obb_matches_dense():
    """Reflective world with OBBs: the box bounce path (bounding-sphere cull
    + per-ray-origin slab narrow phase) must match the dense scan."""
    from openglraytracer_tpu.models.animated import reference_frame

    scene, cam = reference_frame(0.7)
    # make the world reflective so depth 1 has live children off the boxes
    scene = scene._replace(materials=scene.materials._replace(
        reflectivity=jnp.full_like(scene.materials.reflectivity, 0.4),
        transparency=jnp.zeros_like(scene.materials.transparency)))
    cull = suggest_cull_config(scene, cam, H, W, TILE, headroom=1.5)
    child = suggest_child_cull_config(scene, cam, H, W, cull, headroom=1.5)
    img_dense = render(scene, cam, H, W, depth=1, engine="culled", cull=cull)
    img_culled = render(scene, cam, H, W, depth=1, engine="culled",
                        cull=cull, child_cull=child)
    np.testing.assert_allclose(np.asarray(img_culled),
                               np.asarray(img_dense), atol=1e-6)


# ---------------------------------------------------------------------------
# Per-ray-origin Triton kernels for bounce children
# ---------------------------------------------------------------------------

def test_bounce_pallas_matches_xla_bounce():
    """The per-ray Triton narrow phase == the XLA secondary culled pass.

    Tolerance note: unlike the SHARED-origin kernels (whose per-survivor
    scalars pin the expression shape and match XLA bit-exactly in
    interpret mode), per-ray mode computes oc/qc per ray in both programs
    and XLA:CPU contracts the two differently-shaped graphs with different
    FMA orders — measured 2-3 ulp on ~3% of hit t's, zero discrete flips.
    Discrete state stays exact; t/normals compare at 1e-5."""
    from openglraytracer_tpu.ops.accel import bounce_culled_geometry_op
    from openglraytracer_tpu.ops.geometry import geometry_op
    from openglraytracer_tpu.ops.pallas_culled import (
        bounce_culled_pallas_geometry_op)
    from openglraytracer_tpu.ops.render import BOUNCE_EPS
    from openglraytracer_tpu.ops.transforms import reflect

    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    o, d = _tiled_rays(cam)
    hit, _ = geometry_op(scene, o, d, "xla", 512)
    active = hit.hit & (scene.materials.reflectivity[hit.material_id] > 0.0)
    co = hit.p + hit.n * BOUNCE_EPS
    cd = reflect(d, hit.n)
    tile_p = TILE[0] * TILE[1]
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(child)
    hx, ox = bounce_culled_geometry_op(scene, co, cd, active, tile_p,
                                       kp, ks, None, hot_m, kb, ksb)[:2]
    hp, op_ = bounce_culled_pallas_geometry_op(scene, co, cd, active, tile_p,
                                               kp, ks, None, hot_m, kb,
                                               ksb)[:2]
    act = np.asarray(active)
    for name, a, b in (("obj_id", hx.obj_id, hp.obj_id),
                       ("hit", hx.hit, hp.hit),
                       ("material_id", hx.material_id, hp.material_id),
                       ("inside", hx.inside, hp.inside)):
        np.testing.assert_array_equal(np.asarray(a)[act],
                                      np.asarray(b)[act], err_msg=name)
    np.testing.assert_allclose(np.asarray(hx.t)[act & np.asarray(hx.hit)],
                               np.asarray(hp.t)[act & np.asarray(hx.hit)],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(hx.n)[act],
                               np.asarray(hp.n)[act], atol=1e-5)
    live = act & np.asarray(hx.hit)
    # occlusion bits can flip only where a shadow segment grazes an
    # occluder within the t ulp noise — none observed, assert exact
    np.testing.assert_array_equal(np.asarray(ox)[live],
                                  np.asarray(op_)[live])


def test_child_culled_pallas_image_matches_dense():
    """culled_pallas + child_cull: the full depth-1 mirror image through the
    per-ray Triton kernels equals the dense child scan's."""
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    img_dense = render(scene, cam, H, W, depth=1, engine="culled", cull=cull)
    img_k = render(scene, cam, H, W, depth=1, engine="culled_pallas",
                   cull=cull, child_cull=child)
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_dense),
                               atol=1e-5)


def test_child_culled_pallas_depth2_matches_dense():
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    img_dense = render(scene, cam, H, W, depth=2, engine="culled", cull=cull)
    img_k = render(scene, cam, H, W, depth=2, engine="culled_pallas",
                   cull=cull, child_cull=child)
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_dense),
                               atol=1e-5)


def test_child_culled_pallas_gradients_match_dense():
    scene, cam = _mirror_scene()
    cull, child = _specs(scene, cam)
    trainable = ("spheres.center", "spheres.radius", "materials.diffuse")
    params = extract_params(scene, trainable)

    def loss(params, engine, child_cull):
        s = apply_params(scene, params)
        img = render(s, cam, H, W, depth=1, engine=engine, cull=cull,
                     child_cull=child_cull,
                     bounce_mask=static_bounce_mask(scene))
        return jnp.mean(jnp.square(img - 0.25))

    g_dense = jax.grad(loss)(params, "culled", None)
    g_k = jax.grad(loss)(params, "culled_pallas", child)
    for k in params:
        np.testing.assert_allclose(np.asarray(g_k[k]),
                                   np.asarray(g_dense[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def test_child_culled_pallas_obb_scene():
    """Per-ray BOX narrow phase in the kernel (R^T (o - pos) computed per
    ray): the animated OBB world's reflective mirror cube at depth 1."""
    from openglraytracer_tpu.models.animated import reference_frame
    from openglraytracer_tpu.ops.accel import suggest_child_cull_config
    scene, cam = reference_frame(1.2)
    h, w = 32, 64
    cull = suggest_cull_config(scene, cam, h, w, TILE, headroom=1.5)
    child = suggest_child_cull_config(scene, cam, h, w, cull, headroom=1.5)
    img_dense = render(scene, cam, h, w, depth=1, engine="culled", cull=cull)
    img_k = render(scene, cam, h, w, depth=1, engine="culled_pallas",
                   cull=cull, child_cull=child)
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_dense),
                               atol=1e-5)
