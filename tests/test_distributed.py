"""Multi-PROCESS execution of the distributed layer (not just multi-device).

The reference is single-process (SURVEY §2: only a dormant MPICXX hook,
reference CMakeLists.txt:37-43); the equivalent here is
jax.distributed. Everything else in the suite runs many *devices* in one
process — this module is the only place the coordinator handshake, the
cross-process mesh assembly, and the cross-process collectives actually
execute, via two subprocesses on a localhost coordinator (CPU backend).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "distributed_child.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = dict(os.environ)
    # The child sets its own platform/device-count flags before importing
    # jax; drop the parent test-harness overrides so they don't conflict.
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_two_process_sharded_solve_matches_single_process(tmp_path):
    """2 processes x 1 CPU device each, localhost coordinator: the sharded
    fast engine on the spanning mesh must reproduce the single-process
    solve exactly (same f64 algebra, deterministic collectives)."""
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, str(pid), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"child failed:\n{out[-3000:]}"

    got = np.load(tmp_path / "ends.npy")

    # Single-process oracle: same problem, plain FastEngine in f64.
    import jax.numpy as jnp

    from radiative_transfer.config.config import Config
    from radiative_transfer.models import transport
    from radiative_transfer.ops.fast_sweep import FastEngine

    cfg = Config(
        M=4, G=2, N=64, efirst=0.1, elast=10.0, X=1.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(4.0931 for _ in range(2)) for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=1.0, use_correction=True,
        ts_method=3, dt=1e-4, max_timesteps=5,
        include_validation=False,
    )
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng = FastEngine(cfg, tables, dtype=jnp.float64, chunk=8)
    want = np.asarray(eng.ends(eng.solve()))

    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    # float32 across the process boundary (written by the same
    # children): must match the single-process f64 solve at the f32
    # drift bar.
    got_h = np.load(tmp_path / "sharded_f32_ends.npy")
    cfgh = Config(
        M=2, G=1, N=2048, efirst=0.1, elast=10.0, X=20.48,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=((4.0931,), (4.0931,)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.0, use_correction=True,
        ts_method=3, dt=1e-5, max_timesteps=3,
        include_validation=False,
    )
    tablesh, _, _ = transport.build_tables(cfgh, dtype=jnp.float64)
    feng = FastEngine(cfgh, tablesh, dtype=jnp.float64)
    want_h = np.asarray(feng.ends(feng.solve()))
    assert got_h.shape == want_h.shape
    scale = np.abs(want_h).max()
    assert np.abs(got_h - want_h).max() / scale < 1e-5

    # GROUP-axis-across-processes run (mesh (g=2, x=1), written by the
    # same children): exact f64 algebra, so the f64 bar.
    cfgg = Config(
        M=4, G=2, N=1024, efirst=0.1, elast=10.0, X=10.24,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple((4.0931,) * 2 for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.0, use_correction=True,
        ts_method=3, dt=1e-5, max_timesteps=3,
        include_validation=False,
    )
    tablesg, _, _ = transport.build_tables(cfgg, dtype=jnp.float64)
    fengg = FastEngine(cfgg, tablesg, dtype=jnp.float64)
    want_g = np.asarray(fengg.ends(fengg.solve()))
    got_g = np.load(tmp_path / "sharded_g_ends.npy")
    assert got_g.shape == want_g.shape
    np.testing.assert_allclose(got_g, want_g, rtol=1e-12,
                               atol=1e-12 * np.abs(want_g).max())


def _run_children(tmp_path, mode, port=None):
    port = port or _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, str(pid), "2", str(port),
             str(tmp_path), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"child ({mode}) failed:\n{out[-3000:]}"


def test_two_process_checkpoint_resume(tmp_path):
    """Checkpoint mid-run on a 2-process mesh, kill, relaunch, resume:
    the resumed result must equal the uninterrupted 2-process run
    bit-exactly (VERDICT r2 #4 — the write is gathered via
    process_allgather, done by process 0 only, behind a barrier)."""
    import glob as glob_mod

    # The killed run: 2 of 5 steps, per-step checkpoints.
    _run_children(tmp_path, "ckpt1")
    cks = sorted(glob_mod.glob(str(tmp_path / "ck" / "ckpt_*.npz")))
    assert [os.path.basename(c) for c in cks] == [
        "ckpt_000000001.npz", "ckpt_000000002.npz"]

    # The relaunch: must resume from step 2 and finish.
    _run_children(tmp_path, "ckpt2")
    got = np.load(tmp_path / "ckpt_ends.npy")

    # Uninterrupted oracle: the plain 2-process run's result.
    _run_children(tmp_path, "")
    want = np.load(tmp_path / "ends.npy")
    np.testing.assert_array_equal(got, want)


def test_explicit_coordinator_failure_raises(tmp_path):
    """With EXPLICIT coordinator arguments, a failed jax.distributed init
    must raise (fail-fast policy), never silently fall back to
    single-process (parallel/distributed.py)."""
    script = (
        "import jax\n"
        # Pin the CPU through jax.config too (cf. tests/conftest.py).
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.devices()  # backend up -> distributed init must fail\n"
        "from radiative_transfer.parallel import distributed\n"
        "try:\n"
        "    distributed.initialize(\n"
        "        coordinator_address='127.0.0.1:1',\n"
        "        num_processes=2, process_id=0)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "else:\n"
        "    print('SWALLOWED')\n"
    )
    env = _clean_env()
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", script], env=env, cwd=os.path.dirname(HERE),
        capture_output=True, text=True, timeout=120,
    )
    assert "RAISED" in out.stdout, out.stdout + out.stderr[-2000:]
