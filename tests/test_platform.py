"""Platform plumbing: the compile-cache location, the precision policy of
every contraction on the render and training paths, the smoke script's
refusal to run without a GPU, and (on the card only) the compiled kernels."""

import os
import subprocess
import sys

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

def test_compile_cache_default_is_in_checkout(monkeypatch):
    from openglraytracer_tpu.utils.compile_cache import compile_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from openglraytracer_tpu.utils.compile_cache import compile_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path,
                                              env_set):
    from openglraytracer_tpu.utils.compile_cache import enable_compile_cache
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])


def test_gitignore_lists_cache_and_build_outputs():
    lines = open(os.path.join(REPO, ".gitignore")).read().split()
    for entry in (".jax_cache/", "native/build/", "chiprun_out/"):
        assert entry in lines


# ---------------------------------------------------------------------------
# precision: no contraction may fall back to the backend's default (TF32 on
# the GPU). The jaxprs are traced with the global default precision unset,
# so a contraction that names no precision shows up whatever the test
# configuration sets.
# ---------------------------------------------------------------------------

def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _default_precision_dots(jaxpr, found):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params.get("precision")
            if prec is None or any(p in (None, jax.lax.Precision.DEFAULT)
                                   for p in prec):
                found.append(str(eqn.source_info.traceback)
                             .splitlines()[-1] if eqn.source_info.traceback
                             else str(eqn))
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                _default_precision_dots(sub, found)
    return found


@pytest.mark.parametrize("engine", ["xla", "culled", "culled_pallas"])
@pytest.mark.parametrize("scene_kind", ["spheres", "obb"])
def test_no_default_precision_contractions(engine, scene_kind):
    from openglraytracer_tpu.models.animated import reference_frame
    from openglraytracer_tpu.models.builders import sphere_grid_scene
    from openglraytracer_tpu.ops.accel import suggest_cull_config
    from openglraytracer_tpu.ops.render import render
    from openglraytracer_tpu.train.inverse import apply_params, extract_params

    scene, cam = (sphere_grid_scene(2) if scene_kind == "spheres"
                  else reference_frame(1.2))
    h = w = 32
    spec = (suggest_cull_config(scene, cam, h, w, (16, 16))
            if engine != "xla" else None)
    trainable = ("materials.diffuse",) + (
        ("spheres.center",) if scene_kind == "spheres"
        else ("boxes.position", "boxes.angles"))
    params = extract_params(scene, trainable)

    def loss(p):
        img = render(apply_params(scene, p), cam, h, w, engine=engine,
                     cull=spec)
        return jnp.mean(img)

    for fn in (loss, jax.grad(loss)):
        jax.clear_caches()
        with jax.default_matmul_precision(None):
            jaxpr = jax.make_jaxpr(fn)(params).jaxpr
        found = _default_precision_dots(jaxpr, [])
        assert not found, f"{engine}: default-precision dot_general at {found}"


def test_precision_walker_catches_a_default_dot():
    def f(a, b):
        return jnp.einsum("ij,jk->ik", a, b)
    x = jnp.ones((2, 2))
    with jax.default_matmul_precision(None):
        jaxpr = jax.make_jaxpr(f)(x, x).jaxpr
    assert _default_precision_dots(jaxpr, [])


# ---------------------------------------------------------------------------
# chip_smoke.py on a machine without a GPU
# ---------------------------------------------------------------------------

def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "cpu" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the package, the script cannot pass."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "openglraytracer_tpu" in out.stderr
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# on the card only
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_kernels_compile_through_triton(gpu):
    from openglraytracer_tpu.models.builders import sphere_grid_scene
    from openglraytracer_tpu.ops import pallas_culled
    from openglraytracer_tpu.ops.accel import suggest_cull_config
    from openglraytracer_tpu.ops.render import render

    assert not pallas_culled.interpret_mode()
    scene, cam = sphere_grid_scene(8)
    spec = suggest_cull_config(scene, cam, 256, 256, (32, 32))
    fk = jax.jit(lambda s: render(s, cam, 256, 256, engine="culled_pallas",
                                  cull=spec))
    assert "__gpu$xla.gpu.triton" in fk.lower(scene).as_text()
    a = np.asarray(fk(scene))
    b = np.asarray(render(scene, cam, 256, 256, engine="culled", cull=spec))
    # a ray that grazes a sphere or a shadow edge may flip between the
    # kernel's and XLA's multiply-add contraction: at 256^2 that is a few
    # pixels in ten thousand
    assert np.mean(np.max(np.abs(a - b), -1) <= 2e-3) >= 0.999
