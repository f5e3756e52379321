"""bench.py plan wiring must execute end-to-end — the acceptance artifact
the driver runs for the round grade can never again be committed in a state
that crashes (VERDICT r3 next #1: BENCH_r03 was rc=1 because the
culled_pallas plan rows never met a matching cull-spec branch, and no test
touched bench_config's plan wiring).

Strategy: iterate bench.PLAN itself (not a copy) so a new plan row with an
unhandled engine string fails HERE, on CPU, at tiny shapes — same
bench_config code path, tiny scene substituted for the graded one (the
wiring under test is engine dispatch + cull-spec construction, which is
scene-size independent). Triton kernels run in interpret mode on CPU.
"""

import jax
import pytest

import bench
from openglraytracer_tpu.models.builders import BENCH_CONFIGS, sphere_grid_scene

# tiny stand-ins preserving each graded config's *class* (mirror vs matte,
# depth) so the same cull/suggest/child-cull code paths run
_TINY = {
    "c1_sphere_plane": lambda: sphere_grid_scene(2),
    "c2_eight_spheres": lambda: sphere_grid_scene(2),
    "c3_grid64": lambda: sphere_grid_scene(3),
    "c5_grid4096": lambda: sphere_grid_scene(4),
    "c4_mirror": lambda: sphere_grid_scene(3, reflectivity=0.6),
    "c4_mirror4096": lambda: sphere_grid_scene(4, reflectivity=0.6),
}
_H = _W = 32
_TILE = 16   # tile_p = 256: one 256-ray kernel program per tile


def test_plan_configs_exist():
    for row, (cfg, engine, k, tile_side, child) in bench.PLAN.items():
        assert cfg in BENCH_CONFIGS, f"{row}: unknown config {cfg}"
        if child:
            assert BENCH_CONFIGS[cfg][3] > 0, \
                f"{row}: use_child_cull needs depth > 0"
        assert engine in ("xla", "culled", "culled_pallas"), \
            f"{row}: unknown engine {engine}"


@pytest.mark.parametrize("row", sorted(bench.PLAN))
def test_plan_row_runs(row):
    cfg, engine, _k, _tile, child = bench.PLAN[row]
    _builder, _h, _w, depth = BENCH_CONFIGS[cfg]
    scene, cam = _TINY[cfg]()
    out = bench.bench_config(row, scene, cam, _H, _W, depth, engine,
                             k=1, tile_side=_TILE, use_child_cull=child,
                             windows=1)
    assert out["fwd_mrays_per_s"] > 0
    assert out["fwd_bwd_mrays_per_s"] > 0
    assert "fwd_compile_s" in out and "fwd_bwd_compile_s" in out


def test_stack_depth_row_runs():
    out = bench.bench_stack_depth(height=16, width=16, depth=2, k=1)
    assert out["fwd_mrays_per_s"] > 0


def test_headline_fields():
    # main() prints the c3 headline — the row must exist in the plan
    assert "c3_grid64" in bench.PLAN
    _cfg, engine, _k, _tile, _child = bench.PLAN["c3_grid64"]
    assert engine in ("culled", "culled_pallas"), \
        "headline row should run a perf engine"


def test_stack_glass_row_runs():
    """The r5 deep-glass-at-scale row: same code path at tiny shapes."""
    import bench as b
    scene, cam = b.glass_grid_scene(4)
    from openglraytracer_tpu.ops.accel import suggest_stack_cull_config
    from openglraytracer_tpu.ops.render import render
    spec = suggest_stack_cull_config(scene, cam, 32, 32, (16, 16),
                                     headroom=2.0)
    img, ovf = render(scene, cam, 32, 32, depth=2, engine="culled_pallas",
                      bounce="stack", cull=spec, with_cull_stats=True)
    assert img.shape == (32, 32, 3)


def test_device_peaks_h100_and_unknown():
    """One peak table keyed by device_kind; a card not in it is an error."""
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    with pytest.raises(KeyError, match="no peak rates"):
        bench.device_peaks("cpu")


def test_add_utilization():
    row = {"fwd_bwd_ms": 2.0, "fwd_bwd_flops": 67e9,
           "fwd_bwd_bytes_accessed": 3.35e9}
    bench.add_utilization(row, bench.device_peaks("NVIDIA H100 80GB HBM3"))
    assert row["f32_util_vs_peak"] == 0.5
    assert row["hbm_util_vs_peak"] == 0.5
