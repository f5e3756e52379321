"""Command-line interface — the build's host-application layer.

The reference's 'app' is a GLFW window with a hardcoded scene and a vsync
frame loop (main.cpp). The JAX equivalents:

  oglrt render   — render a scene (builtin config or JSON file) to PNG
  oglrt animate  — render the port-fidelity animated demo to a PNG sequence
  oglrt fit      — inverse-rendering: fit scene params to a target image
  oglrt bench    — the north-star benchmark (also available as bench.py)
  oglrt configs  — list builtin scene configs

Configuration is data, not code: scenes load from JSON (models/scene.py) and
every knob is a flag — the deliberate divergence from the reference's
recompile-the-shader-to-change-anything model (SURVEY.md §5).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _builtin(name: str, dtype=None):
    import jax.numpy as jnp
    from openglraytracer_tpu.models.builders import BENCH_CONFIGS
    if name not in BENCH_CONFIGS:
        raise SystemExit(
            f"unknown config '{name}'; available: {list(BENCH_CONFIGS)}")
    builder, h, w, depth = BENCH_CONFIGS[name]
    scene, cam = builder()
    return scene, cam, h, w, depth


def cmd_configs(args):
    from openglraytracer_tpu.models.builders import BENCH_CONFIGS
    for name, (_, h, w, depth) in BENCH_CONFIGS.items():
        print(f"{name:20s} {w}x{h} depth={depth}")


def _profiled(profile_dir):
    """Context manager: a jax.profiler trace when --profile-dir is set."""
    import contextlib
    if not profile_dir:
        return contextlib.nullcontext()
    from openglraytracer_tpu.utils.profiling import trace
    print(f"profiling to {profile_dir} (view with XProf/TensorBoard)")
    return trace(profile_dir)


def _resolve_scene(args):
    """(scene, cam, h, w, depth) from a builtin name or scene JSON.

    JSON scenes carry their own camera when saved with one (scene+camera are
    one unit, like the reference's in-shader scene); explicit --camera-pos /
    --camera-angles flags override it."""
    from openglraytracer_tpu.models.scene import load_scene_camera, make_camera
    if args.scene.endswith(".json"):
        scene, cam = load_scene_camera(args.scene)
        h = args.height or 720
        w = args.width or 1280
        depth = args.depth if args.depth is not None else 0
        if cam is None or args.camera_pos or args.camera_angles:
            cam = make_camera(tuple(args.camera_pos or (0.0, -10.0, 4.0)),
                              tuple(args.camera_angles or (-15.0, 0.0, 0.0)),
                              aspect=w / h)
    else:
        scene, cam, h, w, depth = _builtin(args.scene)
        h, w = args.height or h, args.width or w
        depth = args.depth if args.depth is not None else depth
    return scene, cam, h, w, depth


def cmd_render(args):
    from openglraytracer_tpu.models.scene import save_scene
    from openglraytracer_tpu.ops.render import render
    from openglraytracer_tpu.utils.image import save_png
    from openglraytracer_tpu.utils.metrics import MetricsLogger, time_fn

    scene, cam, h, w, depth = _resolve_scene(args)

    kwargs = dict(depth=depth, engine=args.engine,
                  chunk_size=args.chunk_size,
                  bounce=getattr(args, "bounce", "tree"))
    if args.engine in ("culled", "culled_pallas"):
        from openglraytracer_tpu.ops.accel import suggest_cull_config
        t = args.cull_tile
        if h % t or w % t:
            raise SystemExit(
                f"--cull-tile {t} must divide the image: {w}x{h} "
                f"(--width/--height); pick a dividing tile or resolution "
                f"(e.g. --height {h - h % t or t})")
        tile = (args.cull_tile, args.cull_tile)
        spec = suggest_cull_config(scene, cam, h, w, tile)
        kwargs["cull"] = spec
        print(f"cull: tile={args.cull_tile} "
              + " ".join(f"{k}={v}" for k, v in
                         zip(("kp", "ks", "hot_m", "kb", "ksb"), spec[1:])))
        if args.child_cull:
            from openglraytracer_tpu.ops.accel import suggest_child_cull_config
            if depth <= 0:
                raise SystemExit("--child-cull needs --depth >= 1 "
                                 "(it accelerates bounce children)")
            cspec = suggest_child_cull_config(
                scene, cam, h, w, spec,
                # hot-primary dense fallback is a kernel-path feature; the
                # XLA child path gets max-sized (never-truncating) lists
                hot_primary=(args.engine == "culled_pallas"))
            kwargs["child_cull"] = cspec
            print(f"child cull: "
                  + " ".join(f"{k}={v}" for k, v in
                             zip(("kp", "ks", "hot_m", "kb", "ksb",
                                  "hot_p"), cspec[1:])))
    elif getattr(args, "child_cull", False):
        # mirror the --depth check's feedback: an equally wrong invocation
        # must not be silently ignored (ADVICE r3)
        raise SystemExit("--child-cull requires --engine culled or "
                         "culled_pallas (it sizes the culled bounce-child "
                         f"lists; --engine {args.engine} traces children "
                         "densely)")
    with _profiled(args.profile_dir):
        img = render(scene, cam, h, w, **kwargs)
        img.block_until_ready()
    if args.time:
        from openglraytracer_tpu.ops.shading import (static_bounce_mask,
                                                     static_shadow_mask)
        from openglraytracer_tpu.utils.metrics import rays_per_frame
        dt = time_fn(lambda: render(scene, cam, h, w, **kwargs))
        n_rays = rays_per_frame(h, w, scene.lights.count, depth,
                                shadow_lights=static_shadow_mask(scene),
                                bounce_mask=(static_bounce_mask(scene)
                                             if depth > 0 else None))
        MetricsLogger("render").log(h=h, w=w, depth=depth, sec=dt,
                                    mrays_per_s=round(n_rays / dt / 1e6, 2))
    if args.save_scene:
        save_scene(scene, args.save_scene, camera=cam)
        print(f"wrote scene+camera JSON {args.save_scene}")
    save_png(img, args.out)
    print(f"wrote {args.out} ({w}x{h}, depth={depth})")


def cmd_animate(args):
    from openglraytracer_tpu.models.animated import reference_frame
    from openglraytracer_tpu.ops.render import render
    from openglraytracer_tpu.utils.image import save_png

    cull = None
    if args.engine in ("culled", "culled_pallas"):
        from openglraytracer_tpu.ops.accel import (check_cull_overflow,
                                                   suggest_cull_config)
        t = args.cull_tile
        if args.height % t or args.width % t:
            raise SystemExit(f"--cull-tile {t} must divide the frame "
                             f"{args.width}x{args.height}")
        scene0, cam0 = reference_frame(args.start_time)
        # generous headroom: the spec is reused across the moving sequence,
        # with a never-silent overflow recheck per frame
        cull = suggest_cull_config(scene0, cam0, args.height, args.width,
                                   (t, t), headroom=2.0)
        print(f"cull: {cull}")

    frames = []
    for i in range(args.frames):
        t = args.start_time + i / args.fps
        scene, cam = reference_frame(t)
        if cull is not None:
            ovf = check_cull_overflow(scene, cam, args.height, args.width,
                                      cull)
            if ovf:
                print(f"frame {i}: cull overflow {ovf} — resizing")
                cull = suggest_cull_config(scene, cam, args.height,
                                           args.width, cull[0], headroom=2.0)
                # round K's up to multiples of 16: each distinct spec is a
                # fresh jit compile, so coarser sizes bound recompile thrash
                # when a moving scene oscillates around a threshold (ADVICE r2)
                cull = (cull[0],) + tuple(-(-k // 16) * 16 if k else k
                                          for k in cull[1:])
        img = render(scene, cam, args.height, args.width, depth=args.depth,
                     engine=args.engine, cull=cull)
        path = args.out_pattern.format(i)
        save_png(img, path)
        if args.gif:
            from openglraytracer_tpu.utils.image import to_uint8
            frames.append(to_uint8(img))
        print(f"frame {i}: t={t:.3f}s -> {path}")

    if args.gif and frames:
        # the closest artifact to the reference's live GLFW window
        # (main.cpp:81-86 swap loop): the rendered sequence as one motion file
        from PIL import Image
        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(args.gif, save_all=True, append_images=ims[1:],
                    duration=int(1000 / args.fps), loop=0)
        print(f"wrote {args.gif} ({len(ims)} frames @ {args.fps:g} fps)")


def cmd_view(args):
    from openglraytracer_tpu.utils.viewer import run_viewer
    run_viewer(args.height, args.width, depth=args.depth,
               engine=args.engine, cull_tile=args.cull_tile,
               port=args.port, fps_cap=args.fps_cap,
               max_frames=args.frames, start_time=args.start_time)


def cmd_fit(args):
    import numpy as np
    import jax.numpy as jnp
    from openglraytracer_tpu.models.builders import sphere_grid_scene
    from openglraytracer_tpu.ops.render import render
    from openglraytracer_tpu.parallel.mesh import make_mesh
    from openglraytracer_tpu.train.inverse import FitConfig, fit
    from openglraytracer_tpu.utils.image import load_png, save_png

    target = None
    if args.target:
        # external-target fit: --scene provides the INITIAL scene (+ camera)
        if not (args.scene and args.scene.endswith(".json")):
            raise SystemExit("--target needs --scene init.json "
                             "(the initial scene to optimize, with its "
                             "camera; see save_scene / render --save-scene)")
        from openglraytracer_tpu.models.scene import (load_scene_camera,
                                                      make_camera)
        scene_true, cam = load_scene_camera(args.scene)
        target = jnp.asarray(load_png(args.target))
        th, tw = target.shape[:2]
        if (args.height and args.height != th) or \
                (args.width and args.width != tw):
            raise SystemExit(f"--target {args.target} is {tw}x{th}; "
                             f"--width/--height must match (or be omitted)")
        args.height, args.width = th, tw
        if cam is None:
            cam = make_camera((0.0, -10.0, 4.0), (-15.0, 0.0, 0.0),
                              aspect=tw / th)
    else:
        side = args.grid_side
        scene_true, cam = sphere_grid_scene(side, seed=1)
    args.height = args.height or 128
    args.width = args.width or 128

    cull = None
    if args.engine in ("culled", "culled_pallas"):
        from openglraytracer_tpu.ops.accel import suggest_cull_config
        t = args.cull_tile
        if args.height % t or args.width % t:
            raise SystemExit(f"--cull-tile {t} must divide the fit "
                             f"resolution {args.width}x{args.height}")
        tile = (t, t)
        # generous headroom: the scene moves during the fit
        cull = suggest_cull_config(scene_true, cam, args.height, args.width,
                                   tile, headroom=2.0)
        print(f"cull: {cull}")

    soft = None
    if args.soft:
        # silhouette-aware soft-coverage fit stage (ops/soft.py, r5):
        # --soft BW,GAMMA; the target (self-rendered mode) is soft-rendered
        # at the same constants so the true scene is the exact optimum
        try:
            bw, gamma = (float(x) for x in args.soft.split(","))
        except ValueError:
            raise SystemExit(f"--soft wants BW,GAMMA (got {args.soft!r})")
        if args.engine not in ("auto",):
            raise SystemExit("--soft replaces the hard engine; drop --engine")
        if args.sharded:
            raise SystemExit("--soft stages run unsharded")
        from openglraytracer_tpu.ops.soft import suggest_soft_cull
        t = args.cull_tile
        if args.height % t or args.width % t:
            raise SystemExit(f"--cull-tile {t} must divide the fit "
                             f"resolution {args.width}x{args.height}")
        soft = (bw, gamma)
        cull = suggest_soft_cull(scene_true, cam, args.height, args.width,
                                 (t, t), bw, headroom=2.0)
        print(f"soft cull: {cull}")

    cfg = FitConfig(height=args.height, width=args.width,
                    depth=args.depth,
                    steps=args.steps, learning_rate=args.lr,
                    checkpoint_dir=args.checkpoint_dir,
                    trainable=tuple(args.trainable.split(",")),
                    engine=args.engine, cull=cull,
                    row_block=args.row_block, soft=soft)
    if target is None:
        # self-rendered target + perturbed init (the classic synthetic fit)
        if soft is not None:
            from openglraytracer_tpu.ops.soft import soft_render
            target = soft_render(scene_true, cam, cfg.height, cfg.width,
                                 bw=soft[0], gamma=soft[1], cull=cull)
        else:
            target = render(scene_true, cam, cfg.height, cfg.width,
                            depth=cfg.depth)
        import jax
        key = jax.random.PRNGKey(0)
        k1, k2 = jax.random.split(key)
        scene_init = scene_true._replace(
            spheres=scene_true.spheres._replace(
                center=scene_true.spheres.center
                + 0.3 * jax.random.normal(k1, scene_true.spheres.center.shape),
                radius=jnp.clip(
                    scene_true.spheres.radius
                    + 0.1 * jax.random.normal(
                        k2, scene_true.spheres.radius.shape),
                    0.1, None)))
    else:
        scene_init = scene_true  # the loaded scene IS the starting point

    mesh = make_mesh() if args.sharded else None
    t0 = time.time()
    with _profiled(args.profile_dir):
        fitted, losses = fit(scene_init, target, cam, cfg, mesh=mesh)
    print(f"fit: {len(losses)} logged losses, final {losses[-1][1]:.3e}, "
          f"{time.time() - t0:.1f}s")
    if args.save_scene:
        from openglraytracer_tpu.models.scene import save_scene
        save_scene(fitted, args.save_scene, camera=cam)
        print(f"wrote fitted scene JSON {args.save_scene}")
    if args.out:
        save_png(render(fitted, cam, cfg.height, cfg.width, depth=cfg.depth),
                 args.out)


def cmd_bench(args):
    import bench
    bench.main()


def cmd_scale(args):
    from openglraytracer_tpu.parallel.distributed import init_distributed
    from openglraytracer_tpu.parallel.scaling import (format_table,
                                                      measure_scaling)

    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes,
                     process_id=args.process_id)
    scene, cam, h, w, depth = _resolve_scene(args)
    rows = measure_scaling(scene, cam, h, w, depth=depth, mode=args.mode,
                           engine=args.engine,
                           device_counts=args.devices, iters=args.iters)
    print(format_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}")
    worst = min(r["efficiency"] for r in rows)
    base_n = rows[0]["devices"]
    rel = "1 chip" if base_n == 1 else \
        f"{base_n} devices — NOT the 1-chip baseline BASELINE.md defines"
    print(f"worst-case efficiency: {worst:.1%} relative to {rel} "
          f"(target >= 85%, BASELINE.md)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="oglrt",
                                description="differentiable raytracer in JAX")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="c2_eight_spheres",
                   help="builtin config name or scene .json path")
    r.add_argument("--out", default="render.png")
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "culled", "culled_pallas"])
    r.add_argument("--cull-tile", type=int, default=32,
                   help="pixel tile side for engine=culled")
    r.add_argument("--child-cull", action="store_true",
                   help="cull BOUNCE children too (bounce cones; needs "
                        "engine=culled* and depth >= 1)")
    r.add_argument("--chunk-size", type=int, default=512)
    r.add_argument("--bounce", default="tree", choices=["tree", "stack"],
                   help="bounce engine: 'tree' (static unroll) or 'stack' "
                        "(O(depth)-memory DFS scan for deep recursion)")
    r.add_argument("--camera-pos", type=float, nargs=3, default=None,
                   help="overrides the scene JSON's camera when given")
    r.add_argument("--camera-angles", type=float, nargs=3, default=None)
    r.add_argument("--time", action="store_true", help="print timing metrics")
    r.add_argument("--save-scene", default=None,
                   help="also write the scene+camera as JSON (round-trip)")
    r.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the render here")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate", help="render the reference animated demo")
    a.add_argument("--frames", type=int, default=30)
    a.add_argument("--fps", type=float, default=30.0)
    a.add_argument("--start-time", type=float, default=0.0)
    a.add_argument("--width", type=int, default=640)
    a.add_argument("--height", type=int, default=360)
    a.add_argument("--depth", type=int, default=0)
    a.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "culled", "culled_pallas", "autodiff"])
    a.add_argument("--cull-tile", type=int, default=8,
                   help="pixel tile side for engine=culled")
    a.add_argument("--out-pattern", default="frame_{:04d}.png")
    a.add_argument("--gif", default=None,
                   help="also assemble the frames into an animated GIF")
    a.set_defaults(fn=cmd_animate)

    v = sub.add_parser("view", help="LIVE viewer: render the animated demo "
                       "continuously and stream it over HTTP (MJPEG) — the "
                       "reference's real-time window for a headless GPU host")
    v.add_argument("--width", type=int, default=1280)
    v.add_argument("--height", type=int, default=720)
    v.add_argument("--depth", type=int, default=0)
    v.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "culled", "culled_pallas"])
    v.add_argument("--cull-tile", type=int, default=8)
    v.add_argument("--port", type=int, default=8000)
    v.add_argument("--fps-cap", type=float, default=None,
                   help="cap the render rate (the vsync analog, "
                        "main.cpp:76); default: as fast as the chip goes")
    v.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until Ctrl-C)")
    v.add_argument("--start-time", type=float, default=0.0)
    v.set_defaults(fn=cmd_view)

    f = sub.add_parser("fit", help="inverse-rendering fit")
    f.add_argument("--grid-side", type=int, default=4)
    f.add_argument("--target", default=None,
                   help="fit to this PNG (needs --scene init.json); default "
                        "is the synthetic self-rendered-target fit")
    f.add_argument("--scene", default=None,
                   help="initial scene JSON for --target fits")
    f.add_argument("--width", type=int, default=None)
    f.add_argument("--height", type=int, default=None)
    f.add_argument("--depth", type=int, default=0)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=1e-2)
    f.add_argument("--trainable",
                   default="spheres.center,spheres.radius,materials.diffuse")
    f.add_argument("--sharded", action="store_true")
    f.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "culled", "culled_pallas"])
    f.add_argument("--soft", default=None, metavar="BW,GAMMA",
                   help="soft-coverage forward for silhouette-aware "
                        "geometry fitting (ops/soft.py): e.g. --soft "
                        "0.3,0.3; anneal over successive runs via "
                        "--checkpoint-dir")
    f.add_argument("--cull-tile", type=int, default=32)
    f.add_argument("--row-block", type=int, default=None)
    f.add_argument("--checkpoint-dir", default=None)
    f.add_argument("--out", default=None)
    f.add_argument("--save-scene", default=None,
                   help="write the fitted scene+camera as JSON")
    f.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the fit here")
    f.set_defaults(fn=cmd_fit)

    b = sub.add_parser("bench", help="north-star benchmark")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("scale",
                       help="scaling-efficiency harness (Mrays/s vs devices)")
    s.add_argument("--scene", default="c3_grid64",
                   help="builtin config name or scene .json path")
    s.add_argument("--width", type=int, default=None)
    s.add_argument("--height", type=int, default=None)
    s.add_argument("--depth", type=int, default=None)
    s.add_argument("--mode", default="render", choices=["render", "step"],
                   help="forward render or full fwd+bwd training step")
    s.add_argument("--engine", default="auto",
                   choices=["auto", "xla"])
    s.add_argument("--devices", type=int, nargs="+", default=None,
                   help="device counts to sweep (default 1,2,4,...,all)")
    s.add_argument("--iters", type=int, default=5)
    s.add_argument("--json", default=None, help="write rows to this file")
    s.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address (host:port)")
    s.add_argument("--num-processes", type=int, default=None)
    s.add_argument("--process-id", type=int, default=None)
    s.add_argument("--camera-pos", type=float, nargs=3, default=None)
    s.add_argument("--camera-angles", type=float, nargs=3, default=None)
    s.set_defaults(fn=cmd_scale)

    c = sub.add_parser("configs", help="list builtin configs")
    c.set_defaults(fn=cmd_configs)

    args = p.parse_args(argv)
    from openglraytracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
