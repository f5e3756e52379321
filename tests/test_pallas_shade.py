"""Triton shade kernels (ops/pallas_shade.py), in interpret mode here: the
forward must match shading.phong_core to fp tolerance, and the analytic
backward kernel must match jax.vjp of phong_core on every cotangent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops.accel import suggest_cull_config, tile_image
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import render, trace_rays_fast
from openglraytracer_tpu.train.inverse import apply_params, extract_params

TILE = (16, 16)
H = W = 64


def test_fused_shade_image_matches_culled():
    scene, cam = sphere_grid_scene(8)
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    a = render(scene, cam, H, W, engine="culled", cull=spec)
    b = render(scene, cam, H, W, engine="culled_pallas", cull=spec)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-5)


def test_fused_shade_obb_scene():
    from openglraytracer_tpu.models.animated import reference_frame
    scene, cam = reference_frame(1.2)
    spec = suggest_cull_config(scene, cam, H, W, TILE)
    a = render(scene, cam, H, W, engine="culled", cull=spec)
    b = render(scene, cam, H, W, engine="culled_pallas", cull=spec)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-5)


def test_fused_shade_gradients_match():
    """Materials + lights gradients through the kernel path must equal the
    culled engine's (plain XLA shade) within the geometry fp noise."""
    scene, cam = sphere_grid_scene(4)
    from openglraytracer_tpu.ops.accel import suggest_cull_sizes
    kp, ks = suggest_cull_sizes(scene, cam, H, W, TILE)
    origins, dirs = generate_rays(cam, H, W)
    o = tile_image(origins, *TILE).reshape(-1, 3)
    d = tile_image(dirs, *TILE).reshape(-1, 3)
    target = jnp.zeros((H * W, 3), jnp.float32)
    trainable = ("spheres.center", "materials.diffuse", "materials.specular",
                 "lights.position", "lights.diffuse")
    params = extract_params(scene, trainable)
    cull = (TILE[0] * TILE[1], kp, ks)

    def loss(params, engine):
        s = apply_params(scene, params)
        img = trace_rays_fast(s, o, d, 0, engine=engine, cull=cull)
        return jnp.mean(jnp.square(img - target))

    g_c = jax.grad(loss)(params, "culled")
    g_p = jax.grad(loss)(params, "culled_pallas")
    for k in params:
        a, b = np.asarray(g_c[k]), np.asarray(g_p[k])
        scale = max(np.abs(a).max(), 1e-8)
        np.testing.assert_allclose(b, a, atol=3e-4 * scale,
                                   err_msg=f"grad mismatch for {k}")


@pytest.mark.parametrize("r_tot", [512, 300])   # 300: rays padded to BR
def test_analytic_backward_matches_xla_replay(r_tot):
    """The analytic backward kernel == jax.vjp of shading.phong_core on
    every cotangent (mat rows, all four light columns, dirs, p, n) — few
    ulp, generic data."""
    from openglraytracer_tpu.ops.pallas_shade import phong_kernel
    from openglraytracer_tpu.ops.shading import phong_core

    rng = np.random.default_rng(3)
    n_l = 3
    mat = rng.random((r_tot, 20))
    mat[:, 16] = 1.0 + 63.0 * mat[:, 16]        # Phong exponents 1..64
    mat = jnp.asarray(mat, jnp.float32)
    lpos = jnp.asarray(rng.normal(0, 5, (n_l, 3)), jnp.float32)
    lamb = jnp.asarray(rng.random((n_l, 4)), jnp.float32)
    ldiff = jnp.asarray(rng.random((n_l, 4)), jnp.float32)
    lspec = jnp.asarray(rng.random((n_l, 4)), jnp.float32)
    dirs = jnp.asarray(rng.normal(0, 1, (r_tot, 3)), jnp.float32)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    p = jnp.asarray(rng.normal(0, 3, (r_tot, 3)), jnp.float32)
    nrm = jnp.asarray(rng.normal(0, 1, (r_tot, 3)), jnp.float32)
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    occ = jnp.asarray(rng.random((r_tot, n_l)) < 0.3)
    tgt = jnp.asarray(rng.random((r_tot, 3)), jnp.float32)
    args = (mat, lpos, lamb, ldiff, lspec, dirs, p, nrm)

    def loss_k(*a):
        return jnp.mean(jnp.square(phong_kernel(*a, occ) - tgt))

    def loss_x(*a):
        return jnp.mean(jnp.square(phong_core(*a, occ) - tgt))

    np.testing.assert_allclose(np.asarray(phong_kernel(*args, occ)),
                               np.asarray(phong_core(*args, occ)),
                               rtol=2e-6, atol=1e-6)
    gk = jax.grad(loss_k, argnums=tuple(range(8)))(*args)
    gx = jax.grad(loss_x, argnums=tuple(range(8)))(*args)
    for name, a, b in zip(
            ("mat", "lpos", "lamb", "ldiff", "lspec", "dirs", "p", "n"),
            gk, gx):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
