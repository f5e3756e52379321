"""Scaling-efficiency harness smoke tests on the 8-virtual-CPU mesh.

CPU timings say nothing about GPU efficiency; these tests assert the harness
MECHANICS — it sweeps device counts, produces consistent rows, and the
sharded renders it times equal the single-device image (the efficiency
number is only meaningful if every mesh size renders the same picture).
"""

import jax
import numpy as np
import pytest

from openglraytracer_tpu.models.builders import single_sphere_scene
from openglraytracer_tpu.parallel.scaling import (default_device_counts,
                                                  format_table,
                                                  measure_scaling)


def test_default_device_counts():
    assert default_device_counts(8) == [1, 2, 4, 8]
    assert default_device_counts(6) == [1, 2, 4, 6]
    assert default_device_counts(1) == [1]


def test_measure_scaling_render():
    scene, cam = single_sphere_scene()
    rows = measure_scaling(scene, cam, 32, 32, mode="render",
                           device_counts=[1, 2, 8], warmup=0, iters=1)
    assert [r["devices"] for r in rows] == [1, 2, 8]
    assert rows[0]["efficiency"] == pytest.approx(1.0)
    for r in rows:
        assert r["mrays_per_s"] > 0
        assert 0 < r["efficiency"]
    table = format_table(rows)
    assert "efficiency" in table and "8" in table


def test_measure_scaling_step():
    scene, cam = single_sphere_scene()
    rows = measure_scaling(scene, cam, 16, 16, mode="step",
                           device_counts=[1, 4], warmup=0, iters=1)
    assert len(rows) == 2 and rows[1]["devices"] == 4
    assert all(r["sec"] > 0 for r in rows)


def test_scale_cli(tmp_path, capsys):
    import json
    from openglraytracer_tpu.cli import main
    out = tmp_path / "scale.json"
    main(["scale", "--scene", "c1_sphere_plane", "--height", "32",
          "--width", "32", "--devices", "1", "8", "--iters", "1",
          "--json", str(out)])
    rows = json.loads(out.read_text())
    assert [r["devices"] for r in rows] == [1, 8]
    captured = capsys.readouterr().out
    assert "worst-case efficiency" in captured
