"""Multi-process tests: spawned subprocesses running
jax.distributed.initialize + the process_allgather branch of gather_image
(SURVEY.md §4 'multi-process tests via jax.distributed.initialize with
spawned subprocesses'). Plus unit tests of the init auto-detect logic.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_gather():
    """2 CPU processes: init_distributed explicit path, sharded render over
    the global mesh, gather_image via process_allgather."""
    addr = f"127.0.0.1:{_free_port()}"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(os.path.dirname(__file__), "_dcn_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(i), addr],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK" in out


_CLUSTER_VARS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def test_pod_environment_detection(monkeypatch):
    from openglraytracer_tpu.parallel import distributed as d
    for k in _CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert d.cluster_from_env() is None
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert d.cluster_from_env() is None    # no coordinator: single-process
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    assert d.cluster_from_env() == dict(coordinator_address="localhost:1234",
                                        num_processes=2, process_id=1)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:99")
    assert d.cluster_from_env()["coordinator_address"] == "localhost:99"
    monkeypatch.delenv("JAX_PROCESS_ID")
    with pytest.raises(RuntimeError, match="JAX_PROCESS_ID"):
        d.cluster_from_env()


def test_init_distributed_noop_single_host(monkeypatch):
    """No args + no cluster env: must not touch jax.distributed at all."""
    from openglraytracer_tpu.parallel import distributed as d
    for k in _CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    called = []
    import jax
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **kw: called.append((a, kw)))
    d.init_distributed()
    assert called == []


def test_init_distributed_pod_env_autoinit(monkeypatch):
    """A cluster described by the environment must initialize with its
    coordinator, process count and id (nothing on a GPU host auto-detects
    them)."""
    from openglraytracer_tpu.parallel import distributed as d
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:4321")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    called = []
    import jax
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **kw: called.append((a, kw)))
    d.init_distributed()
    assert called == [((), dict(coordinator_address="localhost:4321",
                                num_processes=4, process_id=3))]


def test_init_distributed_explicit_errors_propagate(monkeypatch):
    """Explicit cluster args must never silently fall back."""
    from openglraytracer_tpu.parallel import distributed as d
    import jax

    def boom(*a, **kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        d.init_distributed(coordinator_address="10.0.0.1:1", num_processes=2,
                           process_id=0)
