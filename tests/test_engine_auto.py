"""Engine selection (parallel.make_multichip_engine, cli --engine auto,
ensemble.solve_ensemble_stacked, transport.run_problem(engine='auto')).

| topology              | dtype   | platform | engine selected           |
|-----------------------|---------|----------|---------------------------|
| no mesh / 1 device    | float32 | gpu      | TritonEngine (GPU kernel) |
| no mesh / 1 device    | float32 | cpu      | FastEngine                |
| no mesh / 1 device    | float64 | any      | FastEngine (native f64)   |
| several devices       | any     | any      | ShardedFastEngine         |

The platform comes from radiative_transfer.backend.platform(); tests
pin it by monkeypatching that one helper. No default route ever runs a
kernel in the Pallas interpreter.
"""

import subprocess
import sys

import conftest  # noqa: F401
from conftest import deck_edit, reference_deck

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import backend, load_config, parallel
from radiative_transfer.config.config import Config
from radiative_transfer.models import transport
from radiative_transfer.ops.fast_sweep import FastEngine
from radiative_transfer.ops.triton_sweep import TritonEngine
from radiative_transfer.parallel.sharded_fast import (
    ShardedFastEngine,
    make_mesh_1d,
)


def _gray(N=1024, steps=4, M=4, G=1):
    C = 299.79245800
    return Config(
        M=M, G=G, N=N, X=1.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple((4.0931,) * G for _ in range(M)),
        rho=1.0, kappa_grey=1.0, T=1.0,
        ts_method=3, dt=0.4 * (1.0 / N) / C, max_timesteps=steps,
        include_validation=False,
    )


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8
    return {None: None, 1: make_mesh_1d(1), 8: make_mesh_1d(8)}


@pytest.fixture
def on_platform(monkeypatch):
    def pin(name):
        monkeypatch.setattr(backend, "platform", lambda: name)
    return pin


@pytest.mark.parametrize("n_dev", [None, 1, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_routing_table(meshes, on_platform, platform, dtype, n_dev):
    on_platform(platform)
    cfg = _gray()
    tables, _, _ = transport.build_tables(cfg)
    jdt = jnp.dtype(dtype)
    eng = parallel.make_multichip_engine(cfg, tables, meshes[n_dev],
                                         dtype=jdt)
    if n_dev == 8:
        want = ShardedFastEngine
    elif platform == "gpu" and dtype == "float32":
        want = TritonEngine
    else:
        want = FastEngine
    assert type(eng) is want
    assert not getattr(eng, "interpret", False)
    got_dtype = eng.eng.dtype if want is ShardedFastEngine else eng.dtype
    assert jnp.dtype(got_dtype) == (jnp.float32 if want is TritonEngine
                                    else jdt)


def test_unknown_platform_is_an_error(monkeypatch):
    class Dev:
        platform = "metal"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.require_gpu("x")


def test_backend_reports_cpu_here():
    assert backend.platform() == "cpu"
    with pytest.raises(RuntimeError, match="GPU kernel"):
        backend.require_gpu("TritonEngine")


def test_fast_pin(meshes):
    cfg = _gray()
    tables, _, _ = transport.build_tables(cfg)
    eng = parallel.make_multichip_engine(cfg, tables, meshes[8],
                                         engine="fast", dtype=jnp.float64)
    assert isinstance(eng, ShardedFastEngine)
    with pytest.raises(ValueError, match="unknown engine"):
        parallel.make_multichip_engine(cfg, tables, None, engine="pallas")


def test_auto_solution_matches_fast(meshes):
    """auto at a 1-device mesh is exactly the plain engine's trajectory."""
    cfg = _gray(steps=3)
    tables, _, _ = transport.build_tables(cfg)
    ref = FastEngine(cfg, tables).solve()
    got = parallel.make_multichip_engine(cfg, tables, meshes[1]).solve()
    np.testing.assert_array_equal(np.asarray(got.e0), np.asarray(ref.e0))


def test_run_problem_engine_param():
    """transport.run_problem(engine=...) is the library-level entry to
    the perf engines: same diagnostics; float64 auto is the f64 engine."""
    cfg = load_config(reference_deck("single_group.prm"), max_timesteps=10)
    a = transport.run_problem(cfg)
    b = transport.run_problem(cfg, engine="auto")
    c = transport.run_problem(cfg, engine="fast")
    d = transport.run_problem(cfg, engine="auto", dtype=jnp.float32)
    pa = np.asarray(a.phi)
    np.testing.assert_allclose(np.asarray(b.phi), pa, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(c.phi), pa, rtol=1e-12)
    assert np.abs(np.asarray(d.phi) - pa).max() / np.abs(pa).max() < 1e-5
    with pytest.raises(ValueError, match="unknown engine"):
        transport.run_problem(cfg, engine="bogus")


def test_cli_auto_mesh_f64_uses_fast_engine(tmp_path):
    """auto must honor an explicit f64 request on a mesh by selecting the
    sharded XLA engine at f64."""
    import io
    import os
    from contextlib import redirect_stdout

    from radiative_transfer import cli

    text = open(reference_deck("single_group.prm")).read()
    text = deck_edit(text, "max_timesteps=1000", "max_timesteps=2")
    deck = os.path.join(tmp_path, "deck.prm")
    open(deck, "w").write(text)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([deck, "--outdir", str(tmp_path), "--engine", "auto",
                       "--mesh", "1x2", "--dtype", "float64"])
    assert rc == 0
    assert "auto engine: ShardedFastEngine (mesh 1x2, float64)" \
        in buf.getvalue()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cli_auto_single_chip(tmp_path, dtype):
    """cli --engine auto without a mesh runs the one-device engine for
    the requested precision (the CPU here: the XLA engine)."""
    out = subprocess.run(
        [sys.executable, "-m", "radiative_transfer.cli",
         reference_deck("single_group.prm"), "--steps", "2",
         "--engine", "auto", "--dtype", dtype,
         "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env=None,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"auto engine: FastEngine (one device, {dtype})" in out.stdout
    assert "wrote 8 CSVs" in out.stdout


def test_indivisible_mesh_raises_clear_valueerror(meshes):
    """No chunking shards N=100 over 8 contiguous spatial shards; auto
    must surface a clear ValueError (an assert would vanish under -O)."""
    cfg = _gray().replace(N=100)           # 100 % 8 != 0
    tables, _, _ = transport.build_tables(cfg)
    with pytest.raises(ValueError, match="splits evenly"):
        parallel.make_multichip_engine(cfg, tables, meshes[8])


def test_compile_cache_placement():
    """Without JAX_COMPILATION_CACHE_DIR the package caches compiled
    programs at a fixed git-ignored path in the checkout; with it set,
    JAX's own setting is left alone."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import jax, radiative_transfer; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == os.path.join(repo, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(repo, ".gitignore")).read()

    env["JAX_COMPILATION_CACHE_DIR"] = "/nonexistent/elsewhere"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "/nonexistent/elsewhere"
