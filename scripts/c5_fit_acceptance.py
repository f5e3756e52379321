"""Config-5 acceptance run: the graded "4096-sphere procedural scene,
2048^2, tile-sharded inverse-rendering fit" (BASELINE.json config 5) run to
convergence on the GPU:

    python scripts/c5_fit_acceptance.py          # full run
    C5_SMOKE=1 python scripts/c5_fit_acceptance.py      # tiny rehearsal

Round-5 change — BREAK THE GEOMETRY FLOOR: the r4 run plateaued at 22%
center-error reduction because the hard engines' straight-through visibility
gradient is silhouette-blind (r4 summary.json "pass": false, commit b163801).
The fit now runs a SOFT-COVERAGE CURRICULUM (ops/soft.py — SoftRas-style
sigmoid coverage + depth softmax, annealed toward hard):

  * Soft stages fit the soft forward against soft renders of the true scene
    at the SAME (bw, gamma) — the true scene is then an exact global optimum
    and silhouette mismatch carries real gradient. bw anneals downward as
    resolution rises: at this camera a c5 sphere is ~1 px at 512^2, so the
    first stage needs a coverage band of ~0.5 r to be visible at all.
  * Soft stages are MULTI-VIEW (3 cameras orbited about the scene): a
    single view leaves depth-along-the-ray vs radius nearly degenerate
    (bigger-or-closer), which is exactly where the r5 CPU probe measured
    the single-view soft fit stalling at ~40% of the initial error. The
    targets are renders of the true scene either way; extra views are the
    same supervision the multi-resolution targets already were.
  * The final stage is unchanged from r4: HARD culled engine, 2048^2,
    tile-sharded through parallel/sharded on a (1,1) mesh, checkpoint +
    resume — fitting the real (shadowed, hard) target.

Acceptance (the computed `pass` field enforces exactly these):
  * zero cull-overflow events across every stage's log,
  * checkpoint resume verified at 2048^2 (restored step >= final steps),
  * center error halved (reported against the <= 0.05 BASELINE target),
  * end-to-end HARD loss improvement at 2048^2 >= 10x: MSE(init render,
    target) / MSE(fitted render, target), both on the hard engine — this
    replaces r4's final-stage-only loss-drop report, which under a
    curriculum is small precisely because earlier stages did the work
    (ADVICE r4 #3: the docstring/predicate mismatch is resolved by making
    the criterion end-to-end and enforcing it).

Artifacts (written under artifacts/c5_fit/, gitignored): fit_log.jsonl,
target.png, init.png, fitted.png, summary.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops.accel import suggest_cull_config
from openglraytracer_tpu.ops.render import render
from openglraytracer_tpu.ops.soft import soft_render, suggest_soft_cull
from openglraytracer_tpu.parallel.mesh import make_mesh
from openglraytracer_tpu.train.inverse import FitConfig, fit
from openglraytracer_tpu.utils.compile_cache import enable_compile_cache
from openglraytracer_tpu.utils.image import save_png

enable_compile_cache()

TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse")

# --- soft curriculum: (res, steps, bw, gamma, geo_lr, photo_lr) ----------
# bw sets the coverage band width ~ 4*bw*r in world units; the band must
# span >= ~1-2 px of the stage resolution to carry gradient (px ~ 0.65
# world at 512^2 with this camera, r ~ 0.65). gamma is the depth-softmax
# scale. bw anneals with resolution so the band stays >= ~1.5 px.
SOFT_STAGES = [(512, 300, 0.50, 0.60, 1.2e-2, 3.0e-2),
               (1024, 250, 0.18, 0.25, 5.0e-3, 1.2e-2),
               (2048, 200, 0.09, 0.10, 2.0e-3, 6.0e-3)]
SOFT_VIEWS = [0.0, 45.0, -45.0]     # orbit degrees about world z
# --- final hard stage: (res, steps, geo_lr, photo_lr), sharded + ckpt ----
HARD_STAGE = (2048, 200, 6.0e-4, 5.0e-3)
RESUME_EXTRA = 20

# smoke mode (CI / CPU validation of the whole script at tiny scale):
# C5_SMOKE=1 shrinks the scene and stages but exercises every code path.
SMOKE = os.environ.get("C5_SMOKE", "") == "1"
if SMOKE:
    SOFT_STAGES = [(64, 40, 0.50, 0.60, 1.5e-2, 3.0e-2),
                   (128, 30, 0.18, 0.25, 8.0e-3, 1.5e-2),
                   (256, 25, 0.09, 0.10, 3.0e-3, 8.0e-3)]
    HARD_STAGE = (256, 30, 1.0e-3, 5.0e-3)
    RESUME_EXTRA = 5
GRID_SIDE = 8 if SMOKE else 64

# smoke runs must never clobber the acceptance artifacts
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts", "c5_fit_smoke" if SMOKE else "c5_fit")


def orbit_camera(cam, phi_deg: float):
    """Camera orbited phi degrees about the world z axis through the
    origin (Z-up world, yaw about Z — ops/transforms.py conventions)."""
    import math
    phi = math.radians(phi_deg)
    x, y, z = (float(cam.position[0]), float(cam.position[1]),
               float(cam.position[2]))
    pos = (x * math.cos(phi) - y * math.sin(phi),
           x * math.sin(phi) + y * math.cos(phi), z)
    ang = (float(cam.angles[0]), float(cam.angles[1]) + phi_deg,
           float(cam.angles[2]))
    return cam._replace(position=jnp.asarray(pos, cam.position.dtype),
                        angles=jnp.asarray(ang, cam.angles.dtype))


def make_optimizer(steps, geo_lr, photo_lr):
    return optax.multi_transform(
        {"geo": optax.adam(optax.cosine_decay_schedule(geo_lr, steps)),
         "photo": optax.adam(optax.cosine_decay_schedule(photo_lr, steps))},
        {"spheres.center": "geo", "spheres.radius": "geo",
         "materials.diffuse": "photo"})


def center_err(a, b):
    return float(jnp.mean(jnp.linalg.norm(
        a.spheres.center - b.spheres.center, axis=-1)))


def hard_mse(scene, target, cam, res, cull):
    img = render(scene, cam, res, res, engine="culled", cull=cull)
    return float(jnp.mean(jnp.square(img - target)))


def main():
    os.makedirs(OUT, exist_ok=True)
    ckpt_dir = os.path.join(OUT, "ckpt")
    log_path = os.path.join(OUT, "fit_log.jsonl")
    for stale in (log_path,):
        if os.path.exists(stale):
            os.remove(stale)
    # a PREVIOUS run's checkpoints must not leak into this one: fit()
    # auto-restores the latest step, and a stale step-200 checkpoint makes
    # the 200-step hard stage a 0-step no-op
    if os.path.isdir(ckpt_dir):
        import shutil
        shutil.rmtree(ckpt_dir)

    scene_true, cam = sphere_grid_scene(GRID_SIDE, seed=1)

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    scene_fit = scene_true._replace(
        spheres=scene_true.spheres._replace(
            center=scene_true.spheres.center
            + 0.1 * jax.random.normal(k1, scene_true.spheres.center.shape),
            radius=jnp.clip(
                scene_true.spheres.radius
                + 0.05 * jax.random.normal(k2,
                                           scene_true.spheres.radius.shape),
                0.1, None)),
        materials=scene_true.materials._replace(
            diffuse=jnp.clip(
                scene_true.materials.diffuse
                + 0.3 * jax.random.normal(k3,
                                          scene_true.materials.diffuse.shape),
                0.0, 1.0)))
    scene_init = scene_fit
    err0 = center_err(scene_init, scene_true)

    stage_rows = []
    t_total0 = time.time()

    # ---- soft curriculum stages (multi-view, unsharded by design) --------
    cams = tuple(orbit_camera(cam, v) for v in SOFT_VIEWS)
    for res, steps, bw, gamma, geo_lr, photo_lr in SOFT_STAGES:
        t0 = time.time()
        tile = 32 if res >= 1024 else 16
        # headroom 2.0: centers move up to ~0.2 during a stage and the spec
        # is computed once against the TRUE scene
        culls = tuple(suggest_soft_cull(scene_true, c, res, res,
                                        (tile, tile), bw, headroom=2.0)
                      for c in cams)
        target = jnp.stack([
            soft_render(scene_true, c, res, res, bw=bw, gamma=gamma,
                        cull=cu) for c, cu in zip(cams, culls)])
        target.block_until_ready()
        cfg = FitConfig(height=res, width=res, steps=steps,
                        trainable=TRAINABLE, soft=(bw, gamma), cull=culls,
                        log_every=10, log_path=log_path)
        scene_fit, losses = fit(scene_fit, target, cams, cfg,
                                optimizer=make_optimizer(steps, geo_lr,
                                                         photo_lr))
        row = {"res": res, "steps": steps, "soft": [bw, gamma],
               "views": SOFT_VIEWS,
               "loss_first": losses[0][1], "loss_last": losses[-1][1],
               "center_err": round(center_err(scene_fit, scene_true), 4),
               "sharded": False, "seconds": round(time.time() - t0, 1)}
        stage_rows.append(row)
        print(json.dumps(row), flush=True)

    # ---- final hard stage: 2048^2, culled, tile-sharded, checkpointed ----
    res, steps, geo_lr, photo_lr = HARD_STAGE
    tile = 32 if res >= 1024 else 16
    mesh = make_mesh(jax.devices()[:1])   # (1,1): sharded path, one card
    t0 = time.time()
    # hot=False + headroom: max-based ks so the per-tile caps have slack
    # for a MOVING scene (see accel.check_cull_overflow's contract note)
    cull = suggest_cull_config(scene_true, cam, res, res, (tile, tile),
                               headroom=2.0, hot=False)
    target = render(scene_true, cam, res, res, engine="culled", cull=cull)
    target.block_until_ready()
    save_png(target, os.path.join(OUT, "target.png"))
    save_png(render(scene_init, cam, res, res, engine="culled", cull=cull),
             os.path.join(OUT, "init.png"))
    loss_init_hard = hard_mse(scene_init, target, cam, res, cull)

    ckpt_every = min(100, steps)   # smoke stages are < 100 steps
    cfg = FitConfig(height=res, width=res, steps=steps,
                    trainable=TRAINABLE, engine="culled", cull=cull,
                    checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                    log_every=10, log_path=log_path)
    scene_fit, losses = fit(scene_fit, target, cam, cfg, mesh=mesh,
                            optimizer=make_optimizer(steps, geo_lr, photo_lr))
    row = {"res": res, "steps": steps, "soft": None,
           "loss_first": losses[0][1], "loss_last": losses[-1][1],
           "center_err": round(center_err(scene_fit, scene_true), 4),
           "sharded": True, "seconds": round(time.time() - t0, 1)}
    stage_rows.append(row)
    print(json.dumps(row), flush=True)

    err1 = center_err(scene_fit, scene_true)
    loss_fit_hard = hard_mse(scene_fit, target, cam, res, cull)
    save_png(render(scene_fit, cam, res, res, engine="culled", cull=cull),
             os.path.join(OUT, "fitted.png"))

    # checkpoint resume at scale: a fresh final-stage fit() from the same
    # dir must restore step `steps` and only run RESUME_EXTRA more
    cfg2 = FitConfig(height=res, width=res, steps=steps + RESUME_EXTRA,
                     trainable=TRAINABLE, engine="culled", cull=cull,
                     checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                     log_every=10, log_path=log_path)
    t0 = time.time()
    _, losses2 = fit(scene_init, target, cam, cfg2, mesh=mesh,
                     optimizer=make_optimizer(steps + RESUME_EXTRA,
                                              geo_lr, photo_lr))
    resume_s = time.time() - t0
    resumed_from = losses2[0][0]
    resumed_loss = losses2[-1][1]

    ovf_events = 0
    with open(log_path) as f:
        for line in f:
            ovf_events += json.loads(line).get("cull_overflow_events", 0)

    radius_err = float(jnp.mean(jnp.abs(
        scene_fit.spheres.radius - scene_true.spheres.radius)))
    hard_drop = loss_init_hard / max(loss_fit_hard, 1e-30)
    summary = {
        "config": "c5_grid4096_fit_soft_curriculum" if not SMOKE
                  else "c5_SMOKE_fit_soft_curriculum",
        "n_spheres": GRID_SIDE * GRID_SIDE, "engine": "soft->culled",
        "stages": stage_rows,
        "total_fit_seconds": round(time.time() - t_total0, 1),
        "center_err_init": round(err0, 4),
        "center_err_fitted": round(err1, 4),
        "center_err_reduction": round(1.0 - err1 / err0, 3),
        "center_err_target": 0.05,
        "center_err_target_met": err1 <= 0.05,
        "radius_err_fitted": round(radius_err, 4),
        "overflow_events": ovf_events,
        "resume": {"restored_first_logged_step": resumed_from,
                   "extra_steps": RESUME_EXTRA,
                   "final_loss": resumed_loss,
                   "seconds": round(resume_s, 1),
                   "ok": resumed_from >= steps},
        "device": jax.devices()[0].device_kind,
        # end-to-end improvement at the graded resolution, HARD engine both
        # sides: init-vs-target over fitted-vs-target (see module docstring)
        "hard_loss_init": loss_init_hard,
        "hard_loss_fitted": loss_fit_hard,
        "hard_loss_drop_x": round(hard_drop, 1),
        "pass": (ovf_events == 0 and resumed_from >= steps
                 and err1 < err0 * 0.5 and hard_drop >= 10.0),
    }
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
