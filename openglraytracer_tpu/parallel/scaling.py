"""Scaling-efficiency harness: Mrays/s vs device count over the tile mesh.

BASELINE.md's graded target is >= 85% rays/s scaling efficiency from 1 chip
to 1 host to >= 2 hosts. This module measures it: for each device count n it
builds an ('dx','dy') mesh over the first n devices, times the tile-sharded
render (or the full sharded inverse-rendering train step), and reports
Mrays/s plus efficiency relative to perfect linear scaling from the
1-device row:

    efficiency(n) = (mrays(n) / n) / mrays(1)

The forward render is communication-free (each GLSL invocation wrote one
disjoint pixel, raytrace_compute.glsl:404 — here each device owns a pixel
tile), so the expected loss is only dispatch overhead; the train step adds
the gradient psum across devices, which XLA overlaps with the backward.

Runs anywhere jax.devices() shows >1 device: the GPUs of a host, several hosts
(call parallel.distributed.init_distributed first; every process runs the
same harness and the timings are device-global), or the CPU-virtual mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8) for CI smoke tests —
CPU numbers validate the harness mechanics, not device efficiency.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from openglraytracer_tpu.models.scene import Camera, Scene
from openglraytracer_tpu.parallel.mesh import (AXIS_X, AXIS_Y, image_sharding,
                                               make_mesh)
from openglraytracer_tpu.utils.metrics import rays_per_frame


def default_device_counts(n_devices: int) -> list[int]:
    """1, 2, 4, ... up to and always including n_devices."""
    counts = []
    c = 1
    while c < n_devices:
        counts.append(c)
        c *= 2
    counts.append(n_devices)
    return counts


def _time_render(scene, cam, height, width, depth, mesh, engine,
                 shadow_lights, warmup, iters):
    from openglraytracer_tpu.parallel.sharded import render_sharded

    def run():
        return render_sharded(scene, cam, height, width, mesh=mesh,
                              depth=depth, engine=engine,
                              shadow_lights=shadow_lights)

    jax.block_until_ready(run())
    for _ in range(warmup):
        jax.block_until_ready(run())
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _time_step(scene, cam, height, width, depth, mesh, engine, warmup, iters):
    from openglraytracer_tpu.train.inverse import FitConfig, make_train_step

    cfg = FitConfig(height=height, width=width, depth=depth, engine=engine)
    init_fn, step_fn = make_train_step(cam, cfg, mesh=mesh)
    params, opt_state = init_fn(scene)
    target = jax.device_put(jnp.zeros((height, width, 3), jnp.float32),
                            image_sharding(mesh))

    p, o, loss, _ = step_fn(params, opt_state, scene, target)
    jax.block_until_ready(loss)
    for _ in range(warmup):
        p, o, loss, _ = step_fn(p, o, scene, target)
    jax.block_until_ready(loss)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):  # chained: step k consumes step k-1's params
            p, o, loss, _ = step_fn(p, o, scene, target)
        jax.block_until_ready(loss)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def measure_scaling(scene: Scene, cam: Camera, height: int, width: int,
                    depth: int = 0, mode: str = "render",
                    engine: str = "auto",
                    device_counts: list[int] | None = None,
                    warmup: int = 2, iters: int = 5) -> list[dict]:
    """Rows of {devices, mesh, sec, mrays_per_s, efficiency} per device count.

    mode: 'render' (forward only) or 'step' (full fwd+bwd training step with
    the gradient psum). Device counts must divide the image when factorized
    into the 2-D mesh (use power-of-two resolutions).
    """
    from openglraytracer_tpu.ops.shading import static_shadow_mask

    devices = jax.devices()
    counts = device_counts or default_device_counts(len(devices))
    shadow_lights = static_shadow_mask(scene)
    rays = rays_per_frame(height, width, scene.lights.count, depth,
                          shadow_lights=shadow_lights)

    rows = []
    for n in counts:
        assert n <= len(devices), f"{n} devices requested, have {len(devices)}"
        mesh = make_mesh(devices[:n])
        dx, dy = mesh.shape[AXIS_X], mesh.shape[AXIS_Y]
        assert height % dx == 0 and width % dy == 0, \
            f"mesh {dx}x{dy} must divide the image {height}x{width}"
        if mode == "render":
            dt = _time_render(scene, cam, height, width, depth, mesh, engine,
                              shadow_lights, warmup, iters)
        elif mode == "step":
            dt = _time_step(scene, cam, height, width, depth, mesh, engine,
                            warmup, iters)
        else:
            raise ValueError(f"mode must be 'render' or 'step', got {mode!r}")
        rows.append({
            "devices": n,
            "mesh": f"{dx}x{dy}",
            "sec": dt,
            "mrays_per_s": rays / dt / 1e6,
        })

    per_dev_1 = rows[0]["mrays_per_s"] / rows[0]["devices"]
    for r in rows:
        r["efficiency"] = (r["mrays_per_s"] / r["devices"]) / per_dev_1
        # efficiency is relative to the smallest measured count; BASELINE.md
        # defines it vs 1 chip — label the baseline so a [4, 8] sweep can't
        # masquerade as true 1-chip scaling (ADVICE r2)
        r["efficiency_baseline_devices"] = rows[0]["devices"]
    return rows


def format_table(rows: list[dict]) -> str:
    lines = [f"{'devices':>8} {'mesh':>8} {'ms':>10} {'Mrays/s':>10} "
             f"{'efficiency':>11}"]
    for r in rows:
        lines.append(f"{r['devices']:>8} {r['mesh']:>8} "
                     f"{r['sec'] * 1e3:>10.2f} {r['mrays_per_s']:>10.1f} "
                     f"{r['efficiency']:>10.1%}")
    return "\n".join(lines)
