"""The renderer: pure, jittable, differentiable ``render(scene, camera) -> image``.

Replaces the reference's per-pixel stack-machine recursion engine
(raytrace_compute.glsl:844-1105) with two idiomatic-XLA strategies:

  * ``trace_rays``  — a *static tree unroll*: at each depth the reflection and
    refraction children are traced for all rays (masked afterwards), exactly
    reproducing the reference's blend
    ``mix(mix(phong, reflected, reflectivity), refracted, transparency)``
    (:1042-1051). Cost is O(2^depth) ray casts but depth is small and static
    (the reference ships with MAX_RAYTRACE_DEPTH = 0, :22).
  * ``trace_rays_mirror`` — a linear ``lax.scan`` over bounce levels for
    reflection-only scenes: contribution_i = phong_i * (1 - rho_i) * prod(rho_j)
    with the final bounce contributing its full phong. Mathematically equal to
    the tree version when no object is transparent, at O(depth) cost — the
    fast path for deep mirror chains (benchmark config 4).

Reference quirks preserved:
  * A miss returns black — the stack element breaks at phase 0 and pops with
    final_color = 0 (:961-963, :1104).
  * A refraction child is traced whenever transparency > 0, even under total
    internal reflection where GLSL refract() returns the zero vector (:1023);
    a zero-direction ray misses everything here (qa guard) => black child,
    matching the GLSL's effective behavior.
  * Children spawned from *missed* parents don't contribute (masked), like
    rays never pushed on the stack.

No runaway-loop guard is needed: recursion depth is static, so the reference's
10,000-iteration red-pixel failsafe (:1096-1101) has no analog — termination
is guaranteed by construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from openglraytracer_tpu.models.scene import AIR_IOR, Camera, Scene
from openglraytracer_tpu.ops.intersect import closest_hit
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.shading import gather_materials, phong_shade
from openglraytracer_tpu.ops.transforms import reflect, refract

BOUNCE_EPS = 1.0e-3  # reflection/refraction origin offset (:989, :1011)


def _mix(a, b, w):
    """GLSL mix(a, b, w) = a*(1-w) + b*w."""
    return a * (1.0 - w) + b * w


def _apply_bounces(scene: Scene, dirs, hit, color, depth: int, recurse,
                   bounce_mask: tuple = (True, True), mat_rows=None):
    """Reflection (:979-997) and refraction (:1001-1030) child traces blended
    with mix(mix(phong, refl, reflectivity), refr, transparency) (:1042-1051).
    recurse(origins, dirs, depth, active) -> colors for the child rays;
    active marks rays whose child can contribute (parent hit with a
    positive branch weight) — exact engines ignore it, the culled child
    path uses it to build bounce cones (ops/accel.bounce_cones).

    bounce_mask: static (has_refl, has_refr) — a False entry skips that
    subtree entirely (shading.static_bounce_mask proves it contributes
    nothing for this scene's materials). mat_rows: packed (R, 20) material
    rows already routed through the cull survivor lists — avoids the O(R)
    global material gather on large material tables."""
    has_refl, has_refr = bounce_mask
    if mat_rows is not None:
        from openglraytracer_tpu.ops.shading import materials_from_rows
        mat = materials_from_rows(scene, mat_rows)
    else:
        mat = gather_materials(scene, hit.material_id)

    if has_refl:
        refl_org = hit.p + hit.n * BOUNCE_EPS
        refl_dir = reflect(dirs, hit.n)
        do_refl_1d = hit.hit & (mat.reflectivity > 0.0)
        refl_color = recurse(refl_org, refl_dir, depth - 1, do_refl_1d)
        do_refl = do_refl_1d[:, None]
        color = jnp.where(do_refl,
                          _mix(color, refl_color, mat.reflectivity[:, None]),
                          color)

    if has_refr:
        refr_org = hit.p - hit.n * BOUNCE_EPS
        ratio = jnp.where(hit.inside,
                          mat.refraction_index / AIR_IOR,
                          AIR_IOR / mat.refraction_index)
        refr_dir = refract(dirs, hit.n, ratio[:, None])
        do_refr_1d = hit.hit & (mat.transparency > 0.0)
        refr_color = recurse(refr_org, refr_dir, depth - 1, do_refr_1d)
        do_refr = do_refr_1d[:, None]
        color = jnp.where(do_refr,
                          _mix(color, refr_color, mat.transparency[:, None]),
                          color)
    return color


def trace_rays(scene: Scene, origins, dirs, depth: int = 0,
               chunk_size: int = 512, remat: bool = False,
               bounce_mask: tuple | None = None) -> jnp.ndarray:
    """Trace rays through the scene with full reflection+refraction tree
    (pure-XLA path; handles every primitive type).

    origins, dirs: (R, 3), dirs normalized. Returns colors (R, 3).
    bounce_mask: static (has_refl, has_refr); None auto-detects statically
    dead subtrees when the scene is concrete (output-identical elision).
    """
    if bounce_mask is None:
        from openglraytracer_tpu.ops.shading import static_bounce_mask
        bounce_mask = static_bounce_mask(scene)
    hit = closest_hit(scene, origins, dirs, chunk_size=chunk_size, remat=remat)
    color = phong_shade(scene, dirs, hit, chunk_size=chunk_size, remat=remat)

    if depth > 0:
        color = _apply_bounces(
            scene, dirs, hit, color, depth,
            lambda o, d, dd, _act: trace_rays(scene, o, d, dd,
                                              chunk_size=chunk_size,
                                              remat=remat,
                                              bounce_mask=bounce_mask),
            bounce_mask)

    return jnp.where(hit.hit[:, None], color, 0.0)


def trace_rays_fast(scene: Scene, origins, dirs, depth: int = 0,
                    chunk_size: int = 512, engine: str = "xla",
                    cull: tuple | None = None,
                    shadow_lights: tuple | None = None,
                    with_cull_stats: bool = False,
                    bounce_mask: tuple | None = None,
                    child_cull: tuple | None = None):
    """Trace with the analytic O(rays) geometry VJP (ops/geometry.py):
    forward identical to trace_rays; backward gathers each ray's winning
    object, replays one candidate computation, and scatter-adds — instead of
    autodiff re-scanning every object. All primitive types (spheres, OBBs,
    planes) on the 'xla' engine.

    engine: 'xla' (default), 'culled' (tile-cone broad phase,
    ops/accel.py — requires cull = (tile_p, kp, ks) and rays in tile-major
    order with a shared origin), or 'culled_pallas' (same broad phase +
    VJP, narrow phases as Triton kernels scanning each tile's survivor
    lists, ops/pallas_culled.py).

    child_cull: cull spec for the BOUNCE children of a culled trace
    (size with accel.suggest_child_cull_config). Children have no shared
    origin, so their broad phase uses bounce cones (origin-bbox apex +
    Minkowski-expanded objects, accel.bounce_cones) over the parent's tile
    structure — mirror scenes scale past 64 objects (VERDICT r2 next #4).
    None (the default) falls back to the dense 'xla' scan for children.

    with_cull_stats: also return a device int32 scalar counting (tile, list)
    slots that overflowed their static K this trace — including every
    bounce level's lists (0 for exact engines) — lets a training step
    observe dropped-object events EVERY step.
    """
    from openglraytracer_tpu.ops.geometry import geometry_op
    from openglraytracer_tpu.ops.shading import phong_shade_lit

    if bounce_mask is None:
        from openglraytracer_tpu.ops.shading import static_bounce_mask
        bounce_mask = static_bounce_mask(scene)
    mat_rows = None
    ovf = jnp.zeros((), jnp.int32)
    if engine in ("culled", "culled_pallas"):
        from openglraytracer_tpu.ops.accel import (cull_overflow_count,
                                                   culled_geometry_op,
                                                   culled_material_rows,
                                                   parse_cull_spec)
        assert cull is not None, \
            f"engine='{engine}' needs cull=(tile_p, kp, ks[, hot_m[, kb, ksb]])"
        if engine == "culled_pallas":
            from openglraytracer_tpu.ops.pallas_culled import (
                culled_pallas_geometry_op as geo_op)
        else:
            geo_op = culled_geometry_op
        tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
        hit, occ, aux = geo_op(scene, origins, dirs,
                               tile_p, kp, ks, shadow_lights,
                               hot_m, kb, ksb)
        mat_rows = culled_material_rows(scene, hit, aux, tile_p)
        ovf = cull_overflow_count(aux)

        def shade(hit, occ, mat_rows):
            with jax.named_scope("shade"):
                if engine == "culled_pallas":
                    # Triton forward + analytic backward kernels
                    from openglraytracer_tpu.ops import pallas_shade
                    return pallas_shade.shade(scene, dirs, hit, occ,
                                              mat_rows)
                return phong_shade_lit(scene, dirs, hit, occ,
                                       mat_rows=mat_rows)

        if depth > 0:
            ovf_acc = [ovf]
            if child_cull is not None:
                def recurse(o, d, dd, act):
                    c, child_ovf = _trace_child_culled(
                        scene, o, d, act, dd, child_cull, shadow_lights,
                        bounce_mask, pallas=(engine == "culled_pallas"))
                    ovf_acc.append(child_ovf)
                    return c
            else:
                def recurse(o, d, dd, _act):
                    return trace_rays_fast(scene, o, d, dd,
                                           chunk_size=chunk_size,
                                           engine="xla",
                                           shadow_lights=shadow_lights,
                                           bounce_mask=bounce_mask)
            color = shade(hit, occ, mat_rows)
            color = _apply_bounces(scene, dirs, hit, color, depth, recurse,
                                   bounce_mask, mat_rows=mat_rows)
            color = jnp.where(hit.hit[:, None], color, 0.0)
            ovf = sum(ovf_acc[1:], ovf_acc[0])
            return (color, ovf) if with_cull_stats else color
        color = shade(hit, occ, mat_rows)
    else:
        hit, occ = geometry_op(scene, origins, dirs, engine, chunk_size,
                               shadow_lights)
        color = phong_shade_lit(scene, dirs, hit, occ, mat_rows=mat_rows)
    if depth > 0:
        color = _apply_bounces(
            scene, dirs, hit, color, depth,
            lambda o, d, dd, _act: trace_rays_fast(
                scene, o, d, dd, chunk_size=chunk_size, engine=engine,
                shadow_lights=shadow_lights, bounce_mask=bounce_mask),
            bounce_mask, mat_rows=mat_rows)
    color = jnp.where(hit.hit[:, None], color, 0.0)
    return (color, ovf) if with_cull_stats else color


def _trace_child_culled(scene: Scene, origins, dirs, active, depth: int,
                        child_cull: tuple, shadow_lights: tuple | None,
                        bounce_mask: tuple, pallas: bool = False):
    """One bounce level through the secondary-ray culled path: bounce-cone
    broad phase + survivor-list narrow phase + survivor-routed materials,
    recursing into deeper levels with the same child spec. Returns
    (colors (R, 3), overflow scalar summed over this level and below).

    pallas=True: the narrow phase runs the per-ray-origin Triton kernels
    (pallas_culled.bounce_culled_pallas_geometry_op) instead of the XLA
    scan, so the culled_pallas parent engine's children stay on the kernel
    path."""
    from openglraytracer_tpu.ops.accel import (bounce_culled_geometry_op,
                                               cull_hot_p,
                                               cull_overflow_count,
                                               culled_material_rows,
                                               parse_cull_spec)
    from openglraytracer_tpu.ops.shading import phong_shade_lit

    tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(child_cull)
    if pallas:
        from openglraytracer_tpu.ops.pallas_culled import (
            bounce_culled_pallas_geometry_op)
        # hot-primary tiles: over-cap bounce tiles take the dense
        # global-table kernel pass — a kernel-path feature (the XLA child
        # path keeps max-sized lists)
        hp = cull_hot_p(child_cull)
        bounce_op = partial(bounce_culled_pallas_geometry_op, hot_p=hp)
    else:
        bounce_op = bounce_culled_geometry_op
    hit, occ, aux = bounce_op(scene, origins, dirs, active,
                              tile_p, kp, ks, shadow_lights,
                              hot_m, kb, ksb)
    mat_rows = culled_material_rows(scene, hit, aux, tile_p)
    ovf = cull_overflow_count(aux)
    color = phong_shade_lit(scene, dirs, hit, occ, mat_rows=mat_rows)
    if depth > 0:
        ovf_acc = [ovf]

        def recurse(o, d, dd, act):
            c, child_ovf = _trace_child_culled(scene, o, d, act, dd,
                                               child_cull, shadow_lights,
                                               bounce_mask, pallas=pallas)
            ovf_acc.append(child_ovf)
            return c

        color = _apply_bounces(scene, dirs, hit, color, depth, recurse,
                               bounce_mask, mat_rows=mat_rows)
        ovf = sum(ovf_acc[1:], ovf_acc[0])
    return jnp.where(hit.hit[:, None], color, 0.0), ovf


def pick_tracer(scene: Scene, engine: str = "auto",
                shadow_lights: tuple | None = None,
                bounce_mask: tuple | None = None):
    """Select the trace implementation by engine name:
      'auto'          -> 'xla' (all primitive types, analytic VJP)
      'xla'           -> XLA forward + analytic O(R) VJP (spheres, OBBs,
                         planes)
      'autodiff'      -> pure-XLA forward AND autodiff backward (the
                         gradient reference)
    """
    if engine == "auto":
        engine = "xla"
    if engine == "autodiff":
        return lambda s, o, d, depth=0, chunk_size=512, remat=False: \
            trace_rays(s, o, d, depth, chunk_size=chunk_size, remat=remat,
                       bounce_mask=bounce_mask)
    return lambda s, o, d, depth=0, chunk_size=512, remat=False: \
        trace_rays_fast(s, o, d, depth, chunk_size=chunk_size, engine=engine,
                        shadow_lights=shadow_lights, bounce_mask=bounce_mask)


def _dfs_schedule(depth: int):
    """Static preorder schedule for the full reflection/refraction binary
    tree of the given depth: one step per tree node, 2^(depth+1) - 1 total.

    Each step is (source_slot, level): source_slot = -1 means the node's ray
    is the previous step's reflection child (carried directly); source_slot
    = s >= 0 means it is the pending refraction frame stored at stack slot s
    (a node at level s stores its refraction child there). This is the
    reference's stack-machine DFS (raytrace_compute.glsl:844-1105) with the
    stack order precomputed at trace time — the GLSL pushes/pops dynamically
    per pixel; here the tree shape is static so the schedule is too.
    """
    steps = [(-1, 0)]
    sim_stack: list[int] = []
    level = 0
    total = 2 ** (depth + 1) - 1
    while len(steps) < total:
        if level < depth:
            sim_stack.append(level)
            level += 1
            steps.append((-1, level))       # descend the reflection child
        else:
            slot = sim_stack.pop()
            level = slot + 1
            steps.append((slot, level))     # pop the refraction child
    return steps


def trace_rays_stack(scene: Scene, origins, dirs, depth: int,
                     chunk_size: int = 512, engine: str = "xla",
                     shadow_lights: tuple | None = None,
                     bounce_mask: tuple | None = None,
                     cull: tuple | None = None,
                     with_cull_stats: bool = False):
    """Full reflection+refraction bounce tree at O(depth * rays) memory.

    ``trace_rays``'s static unroll materializes all 2^(depth+1)-1 node
    intermediates at once — depth >= 4 at high resolution blows HBM. This
    is the memory-bounded equivalent of the reference's 100-frame stack
    machine (raytrace_compute.glsl:873-874): a ``lax.scan`` over the static
    DFS schedule, one ray cast per step, carrying only a (depth+1)-slot
    stack of pending refraction rays.

    The blend chain mix(mix(phong, refl, rho), refr, tau) (:1042-1051)
    linearizes over the tree — each node contributes
    throughput * (1-rho')(1-tau') * phong with edge weights rho'(1-tau')
    (reflection) and tau' (refraction), where rho' = rho*[hit & rho>0] and
    tau' = tau*[hit & tau>0] and both are zero at leaf depth — so no
    child-into-parent harvesting state is needed (the GLSL's phases P2-P4
    become a running weighted sum). Bit-level quirks preserved: the
    total-internal-reflection zero-vector ray misses and contributes black
    (:1023), children of missed parents carry zero weight, miss = black.

    Identical output to ``trace_rays`` / ``trace_rays_fast`` (same geometry
    and shading ops; verified in tests); backward uses the same analytic
    geometry VJP per step, with the scan saving only O(depth * rays)
    carries per step instead of the tree's full residual set.

    cull (r5, VERDICT r4 next #5): a parse_cull_spec tuple switches every
    DFS step onto the SECONDARY-RAY culled path (bounce cones over the
    step's live bundle + survivor-list narrow phase; engine='culled' = XLA
    narrow phase, 'culled_pallas' = Triton per-ray kernels) — deep glass at
    4096 objects finally composes with culling. Rays must be TILE-MAJOR
    (accel.tile_image order, which the scan preserves level to level), the
    spec must cover every level's bundles (size with headroom; overflow is
    counted and returned, never silent), and with_cull_stats returns
    (image, overflow) summed across all 2^(depth+1)-1 steps.
    """
    from openglraytracer_tpu.ops.geometry import geometry_op
    from openglraytracer_tpu.ops.shading import phong_shade_lit

    if bounce_mask is None:
        from openglraytracer_tpu.ops.shading import static_bounce_mask
        bounce_mask = static_bounce_mask(scene)
    has_refl, has_refr = bounce_mask
    culled = cull is not None
    if culled:
        from openglraytracer_tpu.ops.accel import (cull_hot_p,
                                                   cull_overflow_count,
                                                   culled_material_rows,
                                                   parse_cull_spec)
        assert engine in ("culled", "culled_pallas"), \
            "trace_rays_stack with cull needs engine='culled'/'culled_pallas'"
        tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
        if isinstance(tile_p, tuple):
            tile_p = tile_p[0] * tile_p[1]
        if engine == "culled_pallas":
            from openglraytracer_tpu.ops.pallas_culled import (
                bounce_culled_pallas_geometry_op)
            # every DFS step is a bounce bundle: over-cap tiles take the
            # dense global pass, so kp can be the stack spec's quantile cap
            bounce_op = partial(bounce_culled_pallas_geometry_op,
                                hot_p=cull_hot_p(cull))
        else:
            from openglraytracer_tpu.ops.accel import (
                bounce_culled_geometry_op as bounce_op)

    def cast(o, d, w):
        """One ray cast + shade; returns (color, hit, overflow)."""
        if culled:
            active = w[:, 0] > 0.0
            hit, occ, aux = bounce_op(scene, o, d, active, tile_p, kp, ks,
                                      shadow_lights, hot_m, kb, ksb)
            mat_rows = culled_material_rows(scene, hit, aux, tile_p)
            color = phong_shade_lit(scene, d, hit, occ, mat_rows=mat_rows)
            ovf = cull_overflow_count(aux)
        else:
            hit, occ = geometry_op(scene, o, d, engine, chunk_size,
                                   shadow_lights)
            color = phong_shade_lit(scene, d, hit, occ)
            ovf = jnp.zeros((), jnp.int32)
        return jnp.where(hit.hit[:, None], color, 0.0), hit, ovf

    def finish(out, ovf):
        return (out, ovf) if with_cull_stats else out

    if depth == 0 or not (has_refl or has_refr):
        if culled:
            c, _, ovf = cast(origins, dirs,
                             jnp.ones((origins.shape[0], 1), origins.dtype))
            return finish(c, ovf)
        return finish(trace_rays_fast(scene, origins, dirs, 0,
                                      chunk_size=chunk_size, engine=engine,
                                      shadow_lights=shadow_lights),
                      jnp.zeros((), jnp.int32))
    if not (has_refl and has_refr):
        # one statically-dead branch: the tree degenerates to a CHAIN — trace
        # depth+1 casts instead of 2^(depth+1)-1, with no pending-frame stack
        # at all (the node weights reduce exactly: a dead branch's edge weight
        # is identically 0 in the blend :1042-1051)
        if not culled:
            return finish(_trace_chain(scene, origins, dirs, depth, has_refl,
                                       chunk_size, engine, shadow_lights),
                          jnp.zeros((), jnp.int32))
        return finish(*_trace_chain_cast(scene, origins, dirs, depth,
                                         has_refl, cast))

    r = origins.shape[0]
    dtype = origins.dtype
    steps = _dfs_schedule(depth)
    src = jnp.asarray([s for s, _ in steps], jnp.int32)
    lvl = jnp.asarray([l for _, l in steps], jnp.int32)

    def body(carry, xs):
        stack, next_o, next_d, next_w, accum, ovf_acc = carry
        s, level = xs
        use_next = s < 0
        frame = jax.lax.dynamic_index_in_dim(stack, jnp.maximum(s, 0), 0,
                                             keepdims=False)   # (R, 7)
        o = jnp.where(use_next, next_o, frame[:, 0:3])
        d = jnp.where(use_next, next_d, frame[:, 3:6])
        w = jnp.where(use_next, next_w, frame[:, 6:7])          # (R, 1)

        color, hit, ovf = cast(o, d, w)
        mat = gather_materials(scene, hit.material_id)

        is_leaf = level >= depth
        w_refl = jnp.where(hit.hit & (mat.reflectivity > 0.0) & ~is_leaf,
                           mat.reflectivity, 0.0)[:, None]
        w_refr = jnp.where(hit.hit & (mat.transparency > 0.0) & ~is_leaf,
                           mat.transparency, 0.0)[:, None]
        accum = accum + w * (1.0 - w_refl) * (1.0 - w_refr) * color

        next_o = hit.p + hit.n * BOUNCE_EPS
        next_d = reflect(d, hit.n)
        next_w = w * w_refl * (1.0 - w_refr)

        ratio = jnp.where(hit.inside,
                          mat.refraction_index / AIR_IOR,
                          AIR_IOR / mat.refraction_index)
        refr_frame = jnp.concatenate(
            [hit.p - hit.n * BOUNCE_EPS,
             refract(d, hit.n, ratio[:, None]),
             w * w_refr], axis=-1)
        stack = jax.lax.dynamic_update_index_in_dim(stack, refr_frame,
                                                    level, 0)
        return (stack, next_o, next_d, next_w, accum, ovf_acc + ovf), None

    init = (jnp.zeros((depth + 1, r, 7), dtype),
            origins, dirs, jnp.ones((r, 1), dtype), jnp.zeros((r, 3), dtype),
            jnp.zeros((), jnp.int32))
    (_, _, _, _, accum, ovf), _ = jax.lax.scan(jax.checkpoint(body), init,
                                               (src, lvl))
    return finish(accum, ovf)


def _trace_chain_cast(scene: Scene, origins, dirs, depth: int,
                      refl_branch: bool, cast):
    """Single-branch bounce chain through an arbitrary cast(o, d, w) ->
    (color, hit, overflow) — the CULLED variant of _trace_chain (every step
    a bounce-cone survivor pass). Returns (accum (R, 3), overflow)."""
    r = origins.shape[0]
    dtype = origins.dtype

    def body(carry, level):
        o, d, w, accum, ovf_acc = carry
        color, hit, ovf = cast(o, d, w)
        mat = gather_materials(scene, hit.material_id)
        is_leaf = level >= depth
        weight = mat.reflectivity if refl_branch else mat.transparency
        w_child = jnp.where(hit.hit & (weight > 0.0) & ~is_leaf,
                            weight, 0.0)[:, None]
        accum = accum + w * (1.0 - w_child) * color
        if refl_branch:
            o_next = hit.p + hit.n * BOUNCE_EPS
            d_next = reflect(d, hit.n)
        else:
            ratio = jnp.where(hit.inside,
                              mat.refraction_index / AIR_IOR,
                              AIR_IOR / mat.refraction_index)
            o_next = hit.p - hit.n * BOUNCE_EPS
            d_next = refract(d, hit.n, ratio[:, None])
        return (o_next, d_next, w * w_child, accum, ovf_acc + ovf), None

    init = (origins, dirs, jnp.ones((r, 1), dtype),
            jnp.zeros((r, 3), dtype), jnp.zeros((), jnp.int32))
    (_, _, _, accum, ovf), _ = jax.lax.scan(jax.checkpoint(body), init,
                                            jnp.arange(depth + 1))
    return accum, ovf


def _trace_chain(scene: Scene, origins, dirs, depth: int, refl_branch: bool,
                 chunk_size: int, engine: str,
                 shadow_lights: tuple | None) -> jnp.ndarray:
    """Single-branch bounce chain (reflection-only or refraction-only scene)
    via lax.scan: node contribution w*(1-w_child)*phong, edge weight w_child
    — the full tree blend with the dead branch's weight identically zero.
    O(depth) casts and O(1) carried state; same geometry/shading ops as
    trace_rays_stack so outputs are identical to the tree unroll."""
    from openglraytracer_tpu.ops.geometry import geometry_op
    from openglraytracer_tpu.ops.shading import phong_shade_lit

    r = origins.shape[0]
    dtype = origins.dtype

    def body(carry, level):
        o, d, w, accum = carry
        hit, occ = geometry_op(scene, o, d, engine, chunk_size,
                               shadow_lights)
        color = phong_shade_lit(scene, d, hit, occ)
        color = jnp.where(hit.hit[:, None], color, 0.0)
        mat = gather_materials(scene, hit.material_id)

        is_leaf = level >= depth
        weight = mat.reflectivity if refl_branch else mat.transparency
        w_child = jnp.where(hit.hit & (weight > 0.0) & ~is_leaf,
                            weight, 0.0)[:, None]
        accum = accum + w * (1.0 - w_child) * color

        if refl_branch:
            o_next = hit.p + hit.n * BOUNCE_EPS
            d_next = reflect(d, hit.n)
        else:
            ratio = jnp.where(hit.inside,
                              mat.refraction_index / AIR_IOR,
                              AIR_IOR / mat.refraction_index)
            o_next = hit.p - hit.n * BOUNCE_EPS
            d_next = refract(d, hit.n, ratio[:, None])
        return (o_next, d_next, w * w_child, accum), None

    init = (origins, dirs, jnp.ones((r, 1), dtype), jnp.zeros((r, 3), dtype))
    (_, _, _, accum), _ = jax.lax.scan(jax.checkpoint(body), init,
                                       jnp.arange(depth + 1))
    return accum


def trace_rays_mirror(scene: Scene, origins, dirs, depth: int,
                      chunk_size: int = 512, remat: bool = True) -> jnp.ndarray:
    """Reflection-only bounce chain via lax.scan (O(depth) ray casts).

    Equivalent to ``trace_rays`` when every material has transparency == 0.
    """
    r = origins.shape[0]
    dtype = origins.dtype

    def body(carry, level):
        o, d, throughput, accum = carry
        hit = closest_hit(scene, o, d, chunk_size=chunk_size, remat=remat)
        phong = phong_shade(scene, d, hit, chunk_size=chunk_size, remat=remat)
        phong = jnp.where(hit.hit[:, None], phong, 0.0)

        mat_refl = scene.materials.reflectivity[hit.material_id]
        is_last = level >= depth
        do_refl = hit.hit & (mat_refl > 0.0) & (~is_last)
        weight = jnp.where(do_refl, mat_refl, 0.0)[:, None]

        accum = accum + throughput * phong * (1.0 - weight)
        throughput = throughput * weight

        o_next = jnp.where(do_refl[:, None], hit.p + hit.n * BOUNCE_EPS, o)
        d_next = jnp.where(do_refl[:, None], reflect(d, hit.n), d)
        return (o_next, d_next, throughput, accum), None

    init = (origins, dirs, jnp.ones((r, 1), dtype), jnp.zeros((r, 3), dtype))
    body_fn = jax.checkpoint(body) if remat else body
    (_, _, _, accum), _ = jax.lax.scan(
        body_fn, init, jnp.arange(depth + 1), length=depth + 1)
    return accum


def render(scene: Scene, camera: Camera, height: int, width: int,
           depth: int = 0, chunk_size: int = 512, remat: bool = False,
           row_block: int | None = None,
           mirror_only: bool = False, engine: str = "auto",
           cull: tuple | None = None,
           shadow_lights: tuple | None = None,
           bounce: str = "tree",
           with_cull_stats: bool = False,
           bounce_mask: tuple | None = None,
           child_cull: tuple | None = None):
    """Render an (H, W, 3) image. Pure function of (scene, camera) — the
    reference's statelessness (everything recomputed from `time` each frame,
    SURVEY.md §5 checkpoint entry) preserved by construction.

    row_block: trace rays in blocks of `row_block` image rows via lax.map to
    bound peak memory at high resolutions (the XLA analog of tiling).

    engine='culled' needs cull=((tile_h, tile_w), kp, ks) — size kp/ks with
    ops/accel.suggest_cull_sizes (counts above K drop objects: conservative
    sizing is the caller's contract).

    shadow_lights: static per-light bools; None auto-detects ambient-only
    lights (whose shadows cannot affect the image) when the scene is
    concrete, and casts all shadows when it is traced.

    bounce: 'tree' (static unroll, O(2^depth) live intermediates) or
    'stack' (DFS-scan stack machine, O(depth) memory — use for depth >= 3
    with refraction).

    with_cull_stats: return (image, overflow) where overflow is a device
    int32 scalar counting culled-engine K overflows (0 for exact engines).
    """
    if shadow_lights is None:
        from openglraytracer_tpu.ops.shading import static_shadow_mask
        shadow_lights = static_shadow_mask(scene)
    # static dead-branch elision must be decided OUTSIDE the jit (the scene
    # is traced inside _render_jit, where the material table is unknown);
    # callers under their own jit (train steps) pass the mask explicitly
    if bounce_mask is None:
        from openglraytracer_tpu.ops.shading import static_bounce_mask
        bounce_mask = static_bounce_mask(scene) if depth > 0 else (True, True)
    out = _render_jit(scene, camera, height, width, depth, chunk_size,
                      remat, row_block, mirror_only, engine, cull,
                      shadow_lights, bounce, with_cull_stats, bounce_mask,
                      child_cull)
    return out


@partial(jax.jit, static_argnames=("height", "width", "depth", "chunk_size",
                                   "remat", "row_block", "mirror_only",
                                   "engine", "cull", "shadow_lights",
                                   "bounce", "with_cull_stats",
                                   "bounce_mask", "child_cull"))
def _render_jit(scene: Scene, camera: Camera, height: int, width: int,
                depth: int, chunk_size: int, remat: bool,
                row_block: int | None, mirror_only: bool, engine: str,
                cull: tuple | None,
                shadow_lights: tuple | None,
                bounce: str = "tree",
                with_cull_stats: bool = False,
                bounce_mask: tuple = (True, True),
                child_cull: tuple | None = None):
    origins, dirs = generate_rays(camera, height, width)

    if engine in ("culled", "culled_pallas"):
        from openglraytracer_tpu.ops.accel import (parse_cull_spec,
                                                   tile_image, untile_image)
        assert cull is not None, \
            f"engine='{engine}' needs cull=((th, tw), kp, ks[, hot_m[, kb, ksb]])"
        if bounce == "stack" and not mirror_only:
            # deep recursion x culling composes — every DFS step runs the
            # secondary-ray culled path (bounce cones + survivor narrow
            # phase, Triton kernels for culled_pallas). The spec must cover bounce bundles too: size
            # it with suggest_child_cull_config-style headroom; overflow is
            # counted per step and summed (never silent).
            from openglraytracer_tpu.ops.accel import cull_hot_p
            (sth, stw), skp, sks, shot, skb, sksb = parse_cull_spec(cull)
            so = tile_image(origins, sth, stw).reshape(-1, 3)
            sd = tile_image(dirs, sth, stw).reshape(-1, 3)
            out = trace_rays_stack(scene, so, sd, depth, engine=engine,
                                   shadow_lights=shadow_lights,
                                   bounce_mask=bounce_mask,
                                   cull=(sth * stw, skp, sks, shot, skb,
                                         sksb, cull_hot_p(cull)),
                                   with_cull_stats=with_cull_stats)
            if with_cull_stats:
                colors, ovf = out
                return untile_image(colors, height, width, sth, stw), ovf
            return untile_image(out, height, width, sth, stw)
        assert row_block is None, \
            f"row_block is not supported with engine='{engine}' (the culled " \
            "path is already tile-blocked); drop --row-block or use " \
            "engine='xla'"
        (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
        o = tile_image(origins, th, tw).reshape(-1, 3)
        d = tile_image(dirs, th, tw).reshape(-1, 3)
        cc = None
        if child_cull is not None:
            from openglraytracer_tpu.ops.accel import cull_hot_p
            (cth, ctw), ckp, cks, chot, ckb, cksb = \
                parse_cull_spec(child_cull)
            assert (cth, ctw) == (th, tw), \
                "child_cull tile must match cull tile (children inherit " \
                "the parent's tile-major ray order)"
            cc = (cth * ctw, ckp, cks, chot, ckb, cksb,
                  cull_hot_p(child_cull))
        out = trace_rays_fast(scene, o, d, depth, chunk_size=chunk_size,
                              engine=engine,
                              cull=(th * tw, kp, ks, hot_m, kb, ksb),
                              shadow_lights=shadow_lights,
                              with_cull_stats=with_cull_stats,
                              bounce_mask=bounce_mask,
                              child_cull=cc)
        if with_cull_stats:
            colors, ovf = out
            return untile_image(colors, height, width, th, tw), ovf
        return untile_image(out, height, width, th, tw)

    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)

    if bounce == "stack" and not mirror_only:
        assert engine in ("auto", "xla"), \
            "bounce='stack' without cull supports engine xla"
        eng = "xla" if engine == "auto" else engine

        def tracer(s, o, d, depth, chunk_size=512, remat=False):
            return trace_rays_stack(s, o, d, depth, chunk_size=chunk_size,
                                    engine=eng, shadow_lights=shadow_lights,
                                    bounce_mask=bounce_mask)
    else:
        tracer = (trace_rays_mirror if mirror_only
                  else pick_tracer(scene, engine, shadow_lights,
                                   bounce_mask))

    if row_block is None or row_block >= height:
        colors = tracer(scene, o, d, depth, chunk_size=chunk_size, remat=remat)
    else:
        assert height % row_block == 0, "row_block must divide height"
        nblocks = height // row_block
        ob = o.reshape(nblocks, row_block * width, 3)
        db = d.reshape(nblocks, row_block * width, 3)
        colors = jax.lax.map(
            lambda od: tracer(scene, od[0], od[1], depth,
                              chunk_size=chunk_size, remat=remat),
            (ob, db))
        colors = colors.reshape(-1, 3)

    img = colors.reshape(height, width, 3)
    if with_cull_stats:   # exact engines never drop objects
        return img, jnp.zeros((), jnp.int32)
    return img
