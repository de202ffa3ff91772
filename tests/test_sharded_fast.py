"""Sharded FAST engine == single-device FAST engine (virtual 8-dev mesh)."""

import conftest  # noqa: F401
from conftest import reference_deck

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import load_config
from radiative_transfer.models import transport
from radiative_transfer.ops import fast_sweep
from radiative_transfer.parallel import sharded_fast


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return sharded_fast.make_mesh_1d(8)


def _compare(cfg, mesh, num_steps, chunk=8, tol=5e-13):
    tables, _, _ = transport.build_tables(cfg)
    eng, fst = fast_sweep.solve_fast(
        cfg, tables, num_steps=num_steps, dtype=jnp.float64, chunk=chunk
    )
    seng = sharded_fast.ShardedFastEngine(
        cfg, tables, mesh, dtype=jnp.float64, chunk=chunk
    )
    sst = seng.solve(num_steps=num_steps)

    ref = np.asarray(eng.ends(fst))
    got = np.asarray(seng.ends(sst))
    scale = np.max(np.abs(ref)) + 1e-300
    assert np.max(np.abs(got - ref)) / scale < tol
    # prev/half too (BDF2 history must survive the decomposition) —
    # compared in the global layout since the engines may pick different
    # chunkings for the same N.
    if cfg.ts_method == 3:
        for a, b in (
            (eng.ends_pair(fst.p0, fst.p1), seng.ends_pair(sst.p0, sst.p1)),
            (eng.ends_pair(fst.h0, fst.h1), seng.ends_pair(sst.h0, sst.h1)),
        ):
            d = np.max(np.abs(np.asarray(a) - np.asarray(b))) / scale
            assert d < tol


@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_gray_deck(mesh8, ts_method):
    cfg = load_config(reference_deck("single_group.prm"),
                      max_timesteps=8, N=128, ts_method=ts_method)
    _compare(cfg, mesh8, 8)


def test_multigroup_correction(mesh8):
    cfg = load_config(reference_deck("multi_group_equilibrium.prm"),
                      max_timesteps=6, N=64)
    _compare(cfg, mesh8, 6)


def test_llnl_deck(mesh8):
    cfg = load_config(reference_deck("llnl_slab_test.prm"), N=64)
    _compare(cfg, mesh8, 2)


@pytest.mark.parametrize("bc_left,bc_right", [(0, 0), (1, 1), (2, 0)])
def test_bc_combinations(mesh8, bc_left, bc_right):
    cfg = load_config(reference_deck("single_group.prm"),
                      max_timesteps=5, N=64,
                      bc_left_indicator=bc_left, bc_right_indicator=bc_right)
    _compare(cfg, mesh8, 5)


def test_matches_general_sharded_trajectory(mesh8):
    """Cross-check against the general engine (not just fast vs fast)."""
    cfg = load_config(reference_deck("single_group.prm"),
                      max_timesteps=5, N=64)
    tables, _, _ = transport.build_tables(cfg)
    res = transport.run_problem(cfg, num_steps=5)

    seng = sharded_fast.ShardedFastEngine(
        cfg, tables, mesh8, dtype=jnp.float64, chunk=8
    )
    sst = seng.solve(num_steps=5)
    ends = np.asarray(seng.ends(sst))
    ref = np.asarray(res.state.ends)
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(ends - ref)) / scale < 1e-12


@pytest.fixture(scope="module")
def mesh2x4():
    assert len(jax.devices()) >= 8
    return sharded_fast.make_mesh_2d(2, 4)


@pytest.mark.parametrize("ts_method", [1, 3])
def test_2d_mesh_gray(mesh2x4, ts_method):
    """(g=2, x=4) mesh: batch rows sharded too (Bh=4 with S_8 gray)."""
    cfg = load_config(reference_deck("single_group.prm"),
                      max_timesteps=6, N=64, M=8,
                      psi_source=tuple((4.0931,) for _ in range(8)),
                      ts_method=ts_method)
    _compare(cfg, mesh2x4, 6)


def test_2d_mesh_multigroup_reflective(mesh2x4):
    """Group-sharded rows with a reflective left boundary: the direction
    flip crosses row shards (the all_gather path)."""
    cfg = load_config(reference_deck("multi_group_equilibrium.prm"),
                      max_timesteps=5, N=64, bc_left_indicator=2)
    _compare(cfg, mesh2x4, 5)


def test_2d_mesh_llnl(mesh2x4):
    cfg = load_config(reference_deck("llnl_slab_test.prm"), N=64)
    _compare(cfg, mesh2x4, 2)


def test_awkward_N_chunk_autopick(mesh2x4):
    """N=100 (the reference default) has no power-of-two chunking that
    splits over 4 spatial shards; the engine must auto-pick a compatible
    chunk (25 -> nc=4). (8 spatial shards are impossible for N=100 — the
    contiguous split requires K | N — and must raise clearly.)"""
    cfg = load_config(reference_deck("single_group.prm"), max_timesteps=4,
                      M=8, psi_source=tuple((4.0931,) for _ in range(8)))
    assert cfg.N == 100
    _compare(cfg, mesh2x4, 4, chunk=256)

    import jax

    from radiative_transfer.models import transport as tr

    tables, _, _ = tr.build_tables(cfg)
    with pytest.raises(ValueError, match="spatial shards"):
        sharded_fast.ShardedFastEngine(
            cfg, tables, sharded_fast.make_mesh_1d(8), dtype=jnp.float64
        )


def test_cli_mesh_flag(tmp_path):
    from radiative_transfer import cli

    deck = reference_deck("multi_group_equilibrium.prm")
    for engine, sub in (("general", "a"), ("fast", "b")):
        out = str(tmp_path / sub)
        assert cli.main([deck, "--steps", "3", "--outdir", out,
                         "--mesh", "2x4", "--engine", engine]) == 0
    a = np.loadtxt(tmp_path / "a" / "phi.csv")
    b = np.loadtxt(tmp_path / "b" / "phi.csv")
    assert np.abs(a - b).max() / np.abs(a).max() < 1e-12
