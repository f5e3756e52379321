"""Measurements that decide each kernel's fate on the GPU.

Run on the card:  python scripts/kernel_decisions.py [--out FILE]
                  python scripts/kernel_decisions.py --only shade --out FILE2
Rehearse on CPU:  JAX_PLATFORMS=cpu python scripts/kernel_decisions.py --small

1. Survivor compaction at c5's shapes: lax.top_k against cumsum-rank
   compaction (binary search per slot, and scatter by rank), all three
   checked equal on the real (4096 tiles x 4096 spheres) cone masks, alone
   and inside the whole c5 culled_pallas frame and step.
2. The culled narrow phase, Triton kernels (engine culled_pallas) against
   plain XLA (engine culled), forward and forward+backward, at c3_grid64
   (1024^2, 64x64 tiles) and c5_grid4096 (2048^2, 32x32 tiles), run in the
   order kernel, XLA, XLA, kernel; then a sweep of rays per program and
   warps on the c5 forward.
3. The plain XLA shade (run alone, `--only shade`): one profiler trace of
   the c3 fwd+bwd step with XLA's command buffers (CUDA graphs) off, so
   that each kernel is its own trace event. The device time of the fusions
   under the "shade" name scope is set against the time their operand and
   result bytes would take at the card's peak bandwidth; the plain shade is
   also timed alone, forward and backward.
4. The Triton shade kernels against the plain XLA shade inside culled_pallas,
   forward and fwd+bwd at c3 and c5, run kernel, XLA, XLA, kernel.

Prints one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bench import device_peaks  # noqa: E402
from openglraytracer_tpu.models.builders import sphere_grid_scene  # noqa: E402
from openglraytracer_tpu.ops import accel, pallas_culled  # noqa: E402
from openglraytracer_tpu.ops.render import render  # noqa: E402
from openglraytracer_tpu.train.inverse import (  # noqa: E402
    DEFAULT_TRAINABLE, apply_params, extract_params)
from openglraytracer_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)


def timeit(fn, *args, reps: int = 10, windows: int = 3) -> dict:
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / reps)
    return {"first_s": first, "min_ms": min(per) * 1e3,
            "median_ms": float(np.median(per)) * 1e3}


# ---------------------------------------------------------------------------
# 1. compaction
# ---------------------------------------------------------------------------

def compact_topk(mask, k):
    n = mask.shape[-1]
    key = jnp.where(mask, jnp.arange(n, 0, -1, dtype=jnp.int32)[None, :], 0)
    vals, idx = jax.lax.top_k(key, min(k, n))
    valid = vals > 0
    return (jnp.where(valid, idx, 0).astype(jnp.int32), valid,
            jnp.sum(mask, axis=-1, dtype=jnp.int32))


def compact_scatter(mask, k):
    """Cumsum rank, then one scatter of each survivor's column to its slot
    (slots >= k fall off)."""
    t, n = mask.shape
    k_eff = min(k, n)
    rank = jnp.cumsum(mask, axis=-1, dtype=jnp.int32)
    count = rank[:, -1]
    dest = jnp.where(mask, rank - 1, k_eff)
    cols = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (t, n))
    idx = jnp.zeros((t, k_eff), jnp.int32).at[
        jnp.arange(t, dtype=jnp.int32)[:, None], dest].set(cols, mode="drop")
    valid = jnp.arange(1, k_eff + 1, dtype=jnp.int32)[None, :] \
        <= count[:, None]
    return idx, valid, count


def measure_compaction(scene, cam, h, w, tile, spec) -> dict:
    from openglraytracer_tpu.ops.raygen import generate_rays
    _, kp, ks = spec[:3]
    origins, dirs = generate_rays(cam, h, w)
    d = accel.tile_image(dirs, *tile)
    axis, cos_half = accel.tile_cones(d)
    o0 = origins[0, 0]
    pmask = jax.jit(accel.sphere_vs_cone)(
        o0, axis, cos_half, scene.spheres.center, scene.spheres.radius)
    out = {"mask_shape": list(pmask.shape), "kp": kp, "ks": ks,
           "mask_density": float(jnp.mean(pmask))}
    impls = {"top_k": compact_topk, "cumsum_search": accel.compact_mask,
             "cumsum_scatter": compact_scatter}
    for label, k in (("primary_kp", kp), ("dense_k", min(4 * kp, 4096))):
        ref = None
        for name, fn in impls.items():
            f = jax.jit(fn, static_argnums=1)
            res = f(pmask, k)
            got = tuple(np.asarray(x) for x in res)
            if ref is None:
                ref = got
            else:
                assert all((a == b).all() for a, b in zip(ref, got)), name
            out[f"{label}_{name}"] = timeit(f, pmask, k)
    return out


def measure_compaction_e2e(scene, cam, h, w, spec) -> dict:
    """The whole culled_pallas c5 frame and step with each compaction,
    run in a mirrored order."""
    impls = {"top_k": compact_topk, "cumsum_search": accel.compact_mask,
             "cumsum_scatter": compact_scatter}
    shipped = accel.compact_mask
    out = {}
    order = list(impls) + list(impls)[::-1]
    for name in order:
        accel.compact_mask = pallas_culled.compact_mask = impls[name]
        jax.clear_caches()
        fwd, step, params = engine_fns(scene, cam, h, w, spec,
                                       "culled_pallas")
        rec = out.setdefault(name, {"fwd": [], "fwd_bwd": []})
        rec["fwd"].append(timeit(fwd, scene))
        rec["fwd_bwd"].append(timeit(step, params, scene))
        print(f"[c5 compaction] {name}: fwd {rec['fwd'][-1]['min_ms']:.3f}"
              f" ms, fwd+bwd {rec['fwd_bwd'][-1]['min_ms']:.3f} ms",
              flush=True)
    accel.compact_mask = pallas_culled.compact_mask = shipped
    jax.clear_caches()
    return out


# ---------------------------------------------------------------------------
# 2. kernels against plain XLA
# ---------------------------------------------------------------------------

def engine_fns(scene, cam, h, w, spec, engine):
    params = extract_params(scene, DEFAULT_TRAINABLE)

    def fwd(s):
        return render(s, cam, h, w, engine=engine, cull=spec)

    def loss(p, s):
        img = render(apply_params(s, p), cam, h, w, engine=engine, cull=spec)
        return jnp.mean(jnp.square(img - 0.25))

    return jax.jit(fwd), jax.jit(jax.value_and_grad(loss)), params


def measure_engines(name, scene, cam, h, w, spec) -> dict:
    fns = {e: engine_fns(scene, cam, h, w, spec, e)
           for e in ("culled_pallas", "culled")}
    out = {"spec": [list(spec[0])] + [int(x) for x in spec[1:]]}
    for e in ("culled_pallas", "culled", "culled", "culled_pallas"):
        fwd, step, params = fns[e]
        rec = out.setdefault(e, {"fwd": [], "fwd_bwd": []})
        rec["fwd"].append(timeit(fwd, scene))
        rec["fwd_bwd"].append(timeit(step, params, scene))
        print(f"[{name}] {e}: fwd {rec['fwd'][-1]['min_ms']:.3f} ms, "
              f"fwd+bwd {rec['fwd_bwd'][-1]['min_ms']:.3f} ms", flush=True)
    return out


def sweep_blocks(scene, cam, h, w, spec, variants) -> dict:
    out = {}
    for br, warps in variants:
        pallas_culled.BLOCK_RAYS, pallas_culled.NUM_WARPS = br, warps
        jax.clear_caches()
        fwd = jax.jit(lambda s: render(s, cam, h, w, engine="culled_pallas",
                                       cull=spec))
        out[f"br{br}_w{warps}"] = timeit(fwd, scene)
        print(f"[sweep] BR={br} warps={warps}: "
              f"{out[f'br{br}_w{warps}']['min_ms']:.3f} ms", flush=True)
    pallas_culled.BLOCK_RAYS, pallas_culled.NUM_WARPS = 256, 4
    jax.clear_caches()
    return out


def xla_shade(scene, dirs, hit, occluded, mat_rows):
    from openglraytracer_tpu.ops.shading import phong_shade_lit
    return phong_shade_lit(scene, dirs, hit, occluded, mat_rows=mat_rows)


def measure_shade_kernel(name, scene, cam, h, w, spec) -> dict:
    """culled_pallas with the Triton shade kernels against the same engine
    with the plain XLA shade, run kernel, XLA, XLA, kernel."""
    from openglraytracer_tpu.ops import pallas_shade
    kernel_shade = pallas_shade.shade
    out = {}
    for label in ("kernel", "xla", "xla", "kernel"):
        pallas_shade.shade = kernel_shade if label == "kernel" else xla_shade
        jax.clear_caches()
        fwd, step, params = engine_fns(scene, cam, h, w, spec,
                                       "culled_pallas")
        rec = out.setdefault(label, {"fwd": [], "fwd_bwd": []})
        rec["fwd"].append(timeit(fwd, scene))
        rec["fwd_bwd"].append(timeit(step, params, scene))
        print(f"[{name} shade] {label}: fwd {rec['fwd'][-1]['min_ms']:.3f}"
              f" ms, fwd+bwd {rec['fwd_bwd'][-1]['min_ms']:.3f} ms",
              flush=True)
    pallas_shade.shade = kernel_shade
    jax.clear_caches()
    return out


# ---------------------------------------------------------------------------
# 3. shade: trace of the c3 step, and the plain shade alone
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "s8": 1, "u8": 1,
                "f16": 2, "bf16": 2, "s64": 8, "u64": 8, "f64": 8}
_SHAPE = re.compile(r"\b(f32|s32|u32|pred|s8|u8|f16|bf16|s64|u64|f64)"
                    r"\[([\d,]*)\]")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_OPNAME = re.compile(r'op_name="([^"]*)"')


def hlo_kernels(hlo_text: str) -> dict:
    """Top-level instructions of the optimized HLO (those outside fused and
    reducer computations): name -> (op_name metadata, operand + result
    bytes)."""
    out = {}
    comp = ""
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            comp = line.split()[1] if line.startswith("ENTRY") \
                else line.split()[0]
            continue
        m = _INSTR.match(line)
        if not m or "fused" in comp or "region" in comp:
            continue
        name, rest = m.group(1), m.group(2)
        body = rest.split(", metadata=")[0].split(", calls=")[0]
        nbytes = 0
        for dt, dims in _SHAPE.findall(body):
            n = 1
            for x in dims.split(","):
                if x:
                    n *= int(x)
            nbytes += n * _DTYPE_BYTES[dt]
        op = _OPNAME.search(rest)
        out[name] = (op.group(1) if op else "", nbytes)
    return out


def device_events(trace_dir: str) -> dict:
    """hlo_op (or event name) -> [total device ns, count] over the GPU
    planes of the newest trace under trace_dir."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    out: dict = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                key = str(stats.get("hlo_op", ev.name))
                rec = out.setdefault(key, [0, 0, line.name])
                rec[0] += ev.duration_ns
                rec[1] += 1
    return out


def measure_shade(scene, cam, h, w, spec, peak_bw, steps: int = 5) -> dict:
    from openglraytracer_tpu.ops import pallas_shade
    kernel_shade, pallas_shade.shade = pallas_shade.shade, xla_shade
    _, step, params = engine_fns(scene, cam, h, w, spec, "culled_pallas")
    jax.block_until_ready(step(params, scene))
    kernels = hlo_kernels(step.lower(params, scene).compile().as_text())
    trace_dir = tempfile.mkdtemp(prefix="shade_trace_")
    with jax.profiler.trace(trace_dir):
        for _ in range(steps):
            out = step(params, scene)
        jax.block_until_ready(out)
    events = device_events(trace_dir)
    pallas_shade.shade = kernel_shade
    # kernels are named after their HLO instruction, sometimes with '.'
    # and '-' spelled '_'
    norm = lambda k: k.replace(".", "_").replace("-", "_")
    kernels.update({norm(k): v for k, v in list(kernels.items())})
    events = {norm(k) if k not in kernels else k: v
              for k, v in events.items()}
    shade_ns = 0
    shade_bytes = 0
    all_ns = 0
    shade_ops = []
    for key, (ns, cnt, _line) in events.items():
        all_ns += ns
        op, nbytes = kernels.get(key, ("", 0))
        if "shade" in op:
            shade_ns += ns
            shade_bytes += nbytes * (cnt // steps)
            shade_ops.append((key, ns / steps / 1e3, nbytes))
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:40]
    res = {
        "steps_traced": steps,
        "device_us_per_step": all_ns / steps / 1e3,
        "shade_fusions_us_per_step": shade_ns / steps / 1e3,
        "shade_fusion_bytes_per_step": shade_bytes,
        "shade_bytes_at_peak_us": shade_bytes / peak_bw * 1e6,
        "shade_ops": sorted(shade_ops, key=lambda r: -r[1]),
        "top_events": [(k, v[0] / steps / 1e3, v[1], v[2],
                        kernels.get(k, ("", 0))[0][-120:]) for k, v in top],
        "n_hlo_kernels": len(kernels),
        "n_matched": sum(1 for k in events if k in kernels),
    }
    res["shade_vs_bytes_ratio"] = (res["shade_fusions_us_per_step"]
                                   / max(res["shade_bytes_at_peak_us"], 1e-9))

    # the plain shade alone, forward and backward, on the c3 hit record
    from openglraytracer_tpu.ops.raygen import generate_rays
    from openglraytracer_tpu.ops.shading import phong_shade_lit
    (th, tw), kp, ks, hot_m, kb, ksb = accel.parse_cull_spec(spec)
    origins, dirs = generate_rays(cam, h, w)
    o = accel.tile_image(origins, th, tw).reshape(-1, 3)
    d = accel.tile_image(dirs, th, tw).reshape(-1, 3)
    hit, occ, aux = jax.jit(
        lambda s: accel.culled_geometry(s, o, d, th * tw, kp, ks, None,
                                        hot_m, kb, ksb))(scene)
    mat_rows = jax.jit(lambda s: accel.culled_material_rows(
        s, hit, aux, th * tw))(scene)

    def shade(p, n, rows):
        return phong_shade_lit(scene, d, hit._replace(p=p, n=n), occ,
                               mat_rows=rows)

    args = (hit.p, hit.n, mat_rows)
    fwd = jax.jit(shade)
    colors = fwd(*args)
    bwd = jax.jit(lambda p, n, rows, g: jax.vjp(shade, p, n, rows)[1](g))
    nb = lambda xs: sum(int(np.prod(x.shape)) * x.dtype.itemsize
                        for x in jax.tree_util.tree_leaves(xs))
    in_bytes = nb(args) + nb((d, occ, hit.hit))
    res["alone_fwd"] = timeit(fwd, *args)
    res["alone_fwd_bytes"] = in_bytes + nb(colors)
    res["alone_bwd"] = timeit(bwd, *args, colors)
    res["alone_bwd_bytes"] = in_bytes + 2 * nb(colors) + nb(args)
    for k in ("fwd", "bwd"):
        res[f"alone_{k}_bytes_at_peak_us"] = res[f"alone_{k}_bytes"] \
            / peak_bw * 1e6
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes for a CPU rehearsal")
    ap.add_argument("--out", default="chiprun_out/kernel_decisions.json")
    ap.add_argument("--only",
                    default="compact,compact_e2e,engines,sweep,shade_kernel",
                    help="comma list of sections: compact, compact_e2e, "
                         "engines, sweep, shade_kernel, or shade (alone)")
    args = ap.parse_args()
    sections = set(args.only.split(","))
    if "shade" in sections:
        if sections != {"shade"}:
            sys.exit("the shade trace turns command buffers off for the "
                     "whole process: run it alone (--only shade)")
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")
    enable_compile_cache()
    dev = jax.devices()[0]
    if args.small:
        c3 = (sphere_grid_scene(4), 128, 128, (32, 32))
        c5 = (sphere_grid_scene(8), 128, 128, (16, 16))
        peak_bw = 1e11
        variants = [(128, 4)]
    else:
        if dev.platform != "gpu":
            sys.exit(f"measurements need the GPU; JAX found {dev.platform!r}")
        c3 = (sphere_grid_scene(8), 1024, 1024, (64, 64))
        c5 = (sphere_grid_scene(64), 2048, 2048, (32, 32))
        peak_bw = device_peaks(dev.device_kind)["hbm_bytes_per_s"]
        variants = [(128, 4), (256, 8), (512, 8)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout \
        if dev.platform == "gpu" else "none"
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind},
           "card": card.strip()}

    specs = {}
    for name, ((scene, cam), h, w, tile) in (("c3", c3), ("c5", c5)):
        specs[name] = accel.suggest_cull_config(scene, cam, h, w, tile)
    if "compact" in sections:
        (scene, cam), h, w, tile = c5
        res["compaction_c5"] = measure_compaction(scene, cam, h, w, tile,
                                                  specs["c5"])
        print(json.dumps(res["compaction_c5"]), flush=True)
    if "compact_e2e" in sections:
        (scene, cam), h, w, _ = c5
        res["compaction_e2e_c5"] = measure_compaction_e2e(
            scene, cam, h, w, specs["c5"])
    if "shade" in sections:
        (scene, cam), h, w, _ = c3
        res["shade_c3"] = measure_shade(scene, cam, h, w, specs["c3"],
                                        peak_bw)
        print(json.dumps({k: v for k, v in res["shade_c3"].items()
                          if k != "top_events"}), flush=True)
    if "engines" in sections:
        for name, ((scene, cam), h, w, _) in (("c3", c3), ("c5", c5)):
            res[f"engines_{name}"] = measure_engines(name, scene, cam, h, w,
                                                     specs[name])
    if "shade_kernel" in sections:
        for name, ((scene, cam), h, w, _) in (("c3", c3), ("c5", c5)):
            res[f"shade_kernel_{name}"] = measure_shade_kernel(
                name, scene, cam, h, w, specs[name])
    if "sweep" in sections:
        (scene, cam), h, w, _ = c5
        res["sweep_c5_fwd"] = sweep_blocks(scene, cam, h, w, specs["c5"],
                                           variants)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "shade_c3"}))


if __name__ == "__main__":
    main()
