"""Smoke test of the renderer and its fit on one GPU, at the benchmark sizes.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the tile-sharded phases only

One-card phases, all through the normal entry points (render,
culled_geometry*, make_train_step), every kernel compiled through Triton:
  c3_fwd     c3_grid64 at 1024^2: culled_pallas against culled and against
             the NumPy oracle (utils/oracle.py) on every 8th image row
  c3_fit     three make_train_step steps on culled_pallas; the loss
             gradient matches the culled engine's
  c5_fwd     c5_grid4096 at 2048^2 (compaction at N = 4096, dynamic trip
             counts, shadow kernel) against culled, no overflow
  c4m_fwd    c4_mirror4096 at depth 1 with child culling (hot-primary
             pass), no overflow, against the exact dense xla engine (in
             blocks of 32 image rows)
  obb_fwd    the reference's animated OBB world at 1280x720 on the xla
             engine against the oracle, and culled_pallas against xla
  triton     the lowered c3 gradient holds the Triton custom calls
Four-card phases (2x2 mesh, render_sharded):
  c3_sharded_fwd   equals the one-card render
  c3_sharded_step  gradient equals the one-card gradient
  c5_sharded_step  one fwd+bwd step at 2048^2 with no overflow

Tolerances, with their reasons:
  * Pixels: at least 99.99% within 2e-3 (max over RGB). The kernels and XLA
    may contract multiply-adds differently, so a ray that grazes a sphere
    tangentially can pick another, equally valid winner; such rays are
    rare and isolated. The oracle is float64, the renderer float32.
  * Winner ids: at least 99.99% equal, for the same reason.
  * Gradients, kernel against XLA engine: max |a - b| <= 1e-3 max |a| per
    parameter. Both engines share the analytic backward, but its scatter-
    adds and reductions sum in another order, and the residual hit points
    round differently.
  * Sharded against one card: images within 1e-5 (the same per-tile
    arithmetic; the mesh only moves tiles), gradients within 1e-4 relative
    (the cross-device psum adds in another order).
  * Overflow (objects dropped from a survivor list): exactly 0.

Prints the card's name and power limit, each phase's compile and run
seconds, peak device memory, and every comparison beside its limit; the last
line is one JSON object. Exits non-zero when JAX finds no GPU or any
comparison fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from openglraytracer_tpu.utils.compile_cache import enable_compile_cache

FAILURES: list[str] = []
OBB_SIZE = (720, 1280)      # the reference window (main.cpp)


def check(name: str, value: float, limit: float, ok: bool) -> None:
    print(f"  check {name}: {value:.6g} (limit {limit:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        FAILURES.append(name)


def at_least(name, value, limit):
    check(name, value, limit, value >= limit)


def at_most(name, value, limit):
    check(name, value, limit, value <= limit)


def timed(label: str, fn, *args):
    """Compile fn for args, then run it once: prints both times."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t2 = time.perf_counter()
    print(f"  {label}: compile {t1 - t0:.2f} s, run {t2 - t1:.3f} s",
          flush=True)
    return out


def phase(name: str):
    print(f"phase {name}", flush=True)


def peak_memory() -> None:
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)


def pixel_agreement(a, b) -> float:
    diff = np.max(np.abs(np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)), axis=-1)
    return float(np.mean(diff <= 2e-3))


def grad_rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))


def oracle_rows(scene, cam, height, width, depth=0, step=8):
    """Oracle colors and winner ids on every `step`-th image row."""
    from openglraytracer_tpu.utils import oracle
    s = oracle._np(scene)
    o, d = oracle.generate_rays(cam, height, width, np.float64)
    sel = (np.arange(height * width) // width) % step == 0
    hit = oracle.closest_hit(s, o[sel], d[sel])
    colors = oracle.trace(s, o[sel], d[sel], depth)
    return sel.reshape(height, width), colors, hit["obj_id"]


def image_ids(geom_fn, scene, cam, h, w, tile, spec):
    """Winner ids of a culled geometry op, in image layout (H, W)."""
    from openglraytracer_tpu.ops.accel import (parse_cull_spec, tile_image,
                                               untile_image)
    from openglraytracer_tpu.ops.raygen import generate_rays
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    origins, dirs = generate_rays(cam, h, w)
    o = tile_image(origins, *tile).reshape(-1, 3)
    d = tile_image(dirs, *tile).reshape(-1, 3)
    hit, _, _ = geom_fn(scene, o, d, tile[0] * tile[1], kp, ks, None, hot_m,
                        kb, ksb)
    return untile_image(hit.obj_id[:, None], h, w, *tile)[..., 0]


def one_card() -> None:
    from openglraytracer_tpu.models.animated import reference_frame
    from openglraytracer_tpu.models.builders import BENCH_CONFIGS
    from openglraytracer_tpu.ops import pallas_culled
    from openglraytracer_tpu.ops.accel import (culled_geometry,
                                               suggest_child_cull_config,
                                               suggest_cull_config)
    from openglraytracer_tpu.ops.render import render
    from openglraytracer_tpu.train.inverse import (FitConfig, apply_params,
                                                   extract_params,
                                                   make_train_step)

    check("kernels compiled, not interpreted", 0, 0,
          not pallas_culled.interpret_mode())

    # ---- c3_grid64 forward
    phase("c3_fwd")
    builder, h, w, _ = BENCH_CONFIGS["c3_grid64"]
    scene, cam = builder()
    tile = (64, 64)
    spec = suggest_cull_config(scene, cam, h, w, tile)
    print(f"  cull spec {spec}")
    img_k, ovf_k = timed("culled_pallas render", lambda s: render(
        s, cam, h, w, engine="culled_pallas", cull=spec,
        with_cull_stats=True), scene)
    img_c, ovf_c = timed("culled render", lambda s: render(
        s, cam, h, w, engine="culled", cull=spec, with_cull_stats=True),
        scene)
    ids_k = timed("culled_pallas geometry", lambda s: image_ids(
        pallas_culled.culled_geometry_pallas, s, cam, h, w, tile, spec),
        scene)
    ids_c = timed("culled geometry", lambda s: image_ids(
        culled_geometry, s, cam, h, w, tile, spec), scene)
    t0 = time.perf_counter()
    sel, o_colors, o_ids = oracle_rows(scene, cam, h, w)
    print(f"  oracle on {int(sel.sum())} rays: "
          f"{time.perf_counter() - t0:.1f} s")
    img_k, ids_k = np.asarray(img_k), np.asarray(ids_k)
    at_least("c3 pixels culled_pallas vs culled",
             pixel_agreement(img_k, img_c), 0.9999)
    at_least("c3 pixels culled_pallas vs oracle",
             pixel_agreement(img_k[sel], o_colors), 0.9999)
    at_least("c3 winner ids culled_pallas vs culled",
             float(np.mean(ids_k == np.asarray(ids_c))), 0.9999)
    at_least("c3 winner ids culled_pallas vs oracle",
             float(np.mean(ids_k[sel] == o_ids)), 0.9999)
    at_most("c3 overflow", int(ovf_k) + int(ovf_c), 0)
    peak_memory()

    # ---- c3 fit
    phase("c3_fit")
    init = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center + 0.05 * jax.random.normal(
            jax.random.key(0), scene.spheres.center.shape)))
    target = img_c
    cfg = FitConfig(height=h, width=w, engine="culled_pallas", cull=spec,
                    learning_rate=1e-2)
    init_fn, step_fn = make_train_step(cam, cfg)
    params, opt_state = init_fn(init)
    t0 = time.perf_counter()
    for i in range(3):
        params, opt_state, loss, ovf = step_fn(params, opt_state, init,
                                               target)
        loss = float(loss)
        print(f"  step {i}: loss {loss:.6g}, overflow {int(ovf)}, "
              f"{time.perf_counter() - t0:.2f} s (step 0 compiles)")
        t0 = time.perf_counter()
        check(f"c3 fit loss finite (step {i})", loss, 0,
              bool(np.isfinite(loss)))
    p0 = extract_params(init, cfg.trainable)

    def loss_for(engine):
        def loss_fn(p, s):
            img = render(apply_params(s, p), cam, h, w, engine=engine,
                         cull=spec)
            return jnp.mean(jnp.square(img - target))
        return jax.grad(loss_fn)

    g_k = timed("culled_pallas grad", loss_for("culled_pallas"), p0, init)
    g_c = timed("culled grad", loss_for("culled"), p0, init)
    for k in g_k:
        at_most(f"c3 grad {k} culled_pallas vs culled",
                grad_rel(g_c[k], g_k[k]), 1e-3)
    peak_memory()

    # ---- c5_grid4096 forward
    phase("c5_fwd")
    builder, h5, w5, _ = BENCH_CONFIGS["c5_grid4096"]
    scene5, cam5 = builder()
    spec5 = suggest_cull_config(scene5, cam5, h5, w5, (32, 32))
    print(f"  cull spec {spec5}")
    img_k, ovf_k = timed("culled_pallas render", lambda s: render(
        s, cam5, h5, w5, engine="culled_pallas", cull=spec5,
        with_cull_stats=True), scene5)
    img_c, ovf_c = timed("culled render", lambda s: render(
        s, cam5, h5, w5, engine="culled", cull=spec5, with_cull_stats=True),
        scene5)
    at_least("c5 pixels culled_pallas vs culled",
             pixel_agreement(img_k, img_c), 0.9999)
    at_most("c5 overflow culled_pallas", int(ovf_k), 0)
    at_most("c5 overflow culled", int(ovf_c), 0)
    del img_k, img_c
    peak_memory()

    # ---- c4_mirror4096, depth 1 with child culling
    phase("c4m_fwd")
    builder, hm, wm, depth = BENCH_CONFIGS["c4_mirror4096"]
    scene_m, cam_m = builder()
    spec_m = suggest_cull_config(scene_m, cam_m, hm, wm, (32, 32))
    child_k = suggest_child_cull_config(scene_m, cam_m, hm, wm, spec_m,
                                        hot_primary=True)
    print(f"  cull spec {spec_m}, child {child_k}")
    img_k, ovf_k = timed("culled_pallas render", lambda s: render(
        s, cam_m, hm, wm, depth=depth, engine="culled_pallas", cull=spec_m,
        child_cull=child_k, with_cull_stats=True), scene_m)
    # reference: the exact dense scan, in blocks of image rows to bound its
    # (rays, objects) intermediates; the XLA culled child path's max-sized
    # lists would need (T, N, P) candidate blocks of 16 GiB each here
    img_x = timed("xla render (row blocks)", lambda s: render(
        s, cam_m, hm, wm, depth=depth, engine="xla", row_block=32), scene_m)
    at_least("c4_mirror4096 pixels culled_pallas vs xla",
             pixel_agreement(img_k, img_x), 0.9999)
    at_most("c4_mirror4096 overflow culled_pallas", int(ovf_k), 0)
    peak_memory()

    # ---- the reference's animated OBB world
    phase("obb_fwd")
    scene_o, cam_o = reference_frame(1.2)
    ho, wo = OBB_SIZE
    img_x = np.asarray(timed("xla render", lambda s: render(
        s, cam_o, ho, wo, engine="xla"), scene_o))
    spec_o = suggest_cull_config(scene_o, cam_o, ho, wo, (16, 16))
    img_k = timed("culled_pallas render", lambda s: render(
        s, cam_o, ho, wo, engine="culled_pallas", cull=spec_o), scene_o)
    sel, o_colors, _ = oracle_rows(scene_o, cam_o, ho, wo)
    at_least("obb pixels xla vs oracle",
             pixel_agreement(img_x[sel], o_colors), 0.9999)
    at_least("obb pixels culled_pallas vs xla",
             pixel_agreement(img_k, img_x), 0.9999)
    peak_memory()

    # ---- nothing interpreted: the c3 gradient holds Triton kernels
    phase("triton")
    text = jax.jit(loss_for("culled_pallas")).lower(p0, init).as_text()
    n_triton = text.count("__gpu$xla.gpu.triton")
    at_least("c3 step Triton custom calls", n_triton, 2)


def four_cards() -> None:
    from openglraytracer_tpu.models.builders import BENCH_CONFIGS
    from openglraytracer_tpu.ops.accel import suggest_cull_config
    from openglraytracer_tpu.ops.render import render
    from openglraytracer_tpu.parallel.mesh import make_mesh
    from openglraytracer_tpu.parallel.sharded import render_sharded
    from openglraytracer_tpu.train.inverse import (DEFAULT_TRAINABLE,
                                                   apply_params,
                                                   extract_params)

    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    print(f"mesh {dict(mesh.shape)}")

    def grads(scene, cam, h, w, spec, sharded, target):
        def loss_fn(p, s):
            s = apply_params(s, p)
            if sharded:
                img, ovf = render_sharded(
                    s, cam, h, w, mesh=mesh, engine="culled_pallas",
                    cull=spec, with_cull_stats=True)
            else:
                img, ovf = render(s, cam, h, w, engine="culled_pallas",
                                  cull=spec, with_cull_stats=True)
            return jnp.mean(jnp.square(img - target)), ovf
        return jax.grad(loss_fn, has_aux=True)

    phase("c3_sharded_fwd")
    builder, h, w, _ = BENCH_CONFIGS["c3_grid64"]
    scene, cam = builder()
    spec = suggest_cull_config(scene, cam, h, w, (64, 64))
    print(f"  cull spec {spec}")
    img_1 = timed("one-card render", lambda s: render(
        s, cam, h, w, engine="culled_pallas", cull=spec), scene)
    img_4, ovf_4 = timed("sharded render", lambda s: render_sharded(
        s, cam, h, w, mesh=mesh, engine="culled_pallas", cull=spec,
        with_cull_stats=True), scene)
    at_most("c3 sharded vs one-card max |diff|",
            float(np.max(np.abs(np.asarray(img_4) - np.asarray(img_1)))),
            1e-5)
    at_most("c3 sharded overflow", int(ovf_4), 0)
    peak_memory()

    phase("c3_sharded_step")
    init = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center + 0.05 * jax.random.normal(
            jax.random.key(0), scene.spheres.center.shape)))
    p0 = extract_params(init, DEFAULT_TRAINABLE)
    g_1, _ = timed("one-card grad", grads(init, cam, h, w, spec, False,
                                          img_1), p0, init)
    g_4, ovf = timed("sharded grad", grads(init, cam, h, w, spec, True,
                                           img_1), p0, init)
    for k in g_1:
        at_most(f"c3 sharded grad {k} vs one-card", grad_rel(g_1[k], g_4[k]),
                1e-4)
    at_most("c3 sharded step overflow", int(ovf), 0)
    peak_memory()

    phase("c5_sharded_step")
    builder, h5, w5, _ = BENCH_CONFIGS["c5_grid4096"]
    scene5, cam5 = builder()
    spec5 = suggest_cull_config(scene5, cam5, h5, w5, (32, 32))
    print(f"  cull spec {spec5}")
    p5 = extract_params(scene5, DEFAULT_TRAINABLE)
    target5 = jnp.full((h5, w5, 3), 0.25, jnp.float32)
    g5, ovf5 = timed("sharded grad", grads(scene5, cam5, h5, w5, spec5, True,
                                           target5), p5, scene5)
    check("c5 sharded grads finite", 0, 0, all(
        bool(np.isfinite(np.asarray(v)).all()) for v in g5.values()))
    at_most("c5 sharded step overflow", int(ovf5), 0)
    peak_memory()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the tile-sharded phases on four cards")
    args = ap.parse_args()

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"--four needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 1

    print(f"compile cache {enable_compile_cache()}")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for card in cards:
        print(f"card {card}")
    print(f"jax {jax.__version__}, {len(devices)} x {dev.device_kind}")

    t0 = time.perf_counter()
    if args.four:
        four_cards()
    else:
        one_card()
    print(f"total {time.perf_counter() - t0:.1f} s")
    if FAILURES:
        print(f"FAILED: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
