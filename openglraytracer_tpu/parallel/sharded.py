"""Tile-sharded rendering over a device mesh via shard_map.

The render is embarrassingly parallel over pixels (each GLSL invocation wrote
one disjoint pixel, raytrace_compute.glsl:404); here each device traces its
(H/dx, W/dy) tile of rays against the replicated scene with ZERO communication
in the forward pass. The only collectives in the whole system are:

  * psum of scene-parameter gradients (training; XLA inserts it from the
    sharding annotations in train/inverse.py and overlaps it with backward),
  * the final image gather to the host (utils/distributed gather).

This mirrors the reference dispatch (glDispatchCompute over WxH workgroups,
main.cpp:229-238) with the mesh playing the role of the GPU grid — and the
``glFinish`` host sync disappears entirely; XLA dataflow replaces it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openglraytracer_tpu.models.scene import Camera, Scene
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import pick_tracer, trace_rays_mirror
from openglraytracer_tpu.parallel.mesh import AXIS_X, AXIS_Y


@partial(jax.jit,
         static_argnames=("height", "width", "depth", "chunk_size", "remat",
                          "mirror_only", "mesh", "engine", "cull",
                          "shadow_lights", "with_cull_stats",
                          "bounce_mask", "child_cull"))
def render_sharded(scene: Scene, camera: Camera, height: int, width: int,
                   *, mesh: Mesh, depth: int = 0, chunk_size: int = 512,
                   remat: bool = False, mirror_only: bool = False,
                   engine: str = "auto", cull: tuple | None = None,
                   shadow_lights: tuple | None = None,
                   with_cull_stats: bool = False,
                   bounce_mask: tuple = (True, True),
                   child_cull: tuple | None = None):
    """Render (H, W, 3), pixel tiles sharded over the mesh, scene replicated.

    Returns a global jax.Array with NamedSharding(mesh, P('dx','dy',None)).

    engine='culled' runs the tile-cone broad phase *per device shard*: each
    device culls against its own sub-image's cones — cull=((th,tw), kp, ks)
    as in ops/render.render, with (th, tw) dividing the per-device tile.

    with_cull_stats: also return a replicated int32 scalar — the psum over
    devices of culled-K overflow events (0 for exact engines).
    """
    origins, dirs = generate_rays(camera, height, width)   # (H, W, 3)

    tile_h = height // mesh.shape[AXIS_X]
    tile_w = width // mesh.shape[AXIS_Y]
    assert tile_h * mesh.shape[AXIS_X] == height, \
        f"height {height} not divisible by mesh dx={mesh.shape[AXIS_X]}"
    assert tile_w * mesh.shape[AXIS_Y] == width, \
        f"width {width} not divisible by mesh dy={mesh.shape[AXIS_Y]}"

    if engine in ("culled", "culled_pallas"):
        from openglraytracer_tpu.ops.accel import (parse_cull_spec,
                                                   tile_image, untile_image)
        from openglraytracer_tpu.ops.render import trace_rays_fast
        assert cull is not None, \
            f"engine='{engine}' needs cull=((th, tw), kp, ks[, hot_m[, kb, ksb]])"
        (cth, ctw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
        cc = None
        if child_cull is not None:
            # bounce children of the culled per-device trace go through the
            # secondary-ray cone path, same spec contract as ops/render.render
            # (ADVICE r3: previously unreachable from the sharded/fit path)
            from openglraytracer_tpu.ops.accel import cull_hot_p
            (xth, xtw), ckp, cks, chot, ckb, cksb = parse_cull_spec(child_cull)
            assert (xth, xtw) == (cth, ctw), \
                "child_cull tile must match cull tile"
            cc = (xth * xtw, ckp, cks, chot, ckb, cksb,
                  cull_hot_p(child_cull))

        def tile_fn(scene_rep, o_tile, d_tile):
            o = tile_image(o_tile, cth, ctw).reshape(-1, 3)
            d = tile_image(d_tile, cth, ctw).reshape(-1, 3)
            colors, ovf = trace_rays_fast(
                scene_rep, o, d, depth,
                chunk_size=chunk_size, engine=engine,
                cull=(cth * ctw, kp, ks, hot_m, kb, ksb),
                shadow_lights=shadow_lights, with_cull_stats=True,
                bounce_mask=bounce_mask, child_cull=cc)
            img = untile_image(colors, o_tile.shape[0], o_tile.shape[1],
                               cth, ctw)
            return img, jax.lax.psum(ovf, (AXIS_X, AXIS_Y))
    else:
        tracer = (trace_rays_mirror if mirror_only
                  else pick_tracer(scene, engine, shadow_lights,
                                   bounce_mask))

        def tile_fn(scene_rep, o_tile, d_tile):
            o = o_tile.reshape(-1, 3)
            d = d_tile.reshape(-1, 3)
            colors = tracer(scene_rep, o, d, depth, chunk_size=chunk_size,
                            remat=remat)
            return colors.reshape(o_tile.shape), jnp.zeros((), jnp.int32)

    # check_vma=False: the analytic-VJP scatter in the transpose defeats
    # static replication inference; the replicated-scene cotangent still gets
    # its psum from shard_map's transpose rule.
    shmapped = jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(AXIS_X, AXIS_Y, None), P(AXIS_X, AXIS_Y, None)),
        out_specs=(P(AXIS_X, AXIS_Y, None), P()),
        check_vma=False,
    )
    img, ovf = shmapped(scene, origins, dirs)
    return (img, ovf) if with_cull_stats else img


def constrain_tiles(x, mesh: Mesh):
    """Sharding-constrain an (H, W, ...) array to the image tiling."""
    spec = P(AXIS_X, AXIS_Y) if x.ndim == 2 else P(AXIS_X, AXIS_Y, None)
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
