"""Direct steady-state solves (radiative_transfer/steady.py).

The reference can only reach t -> infinity by time-marching (its LLNL
transient needs ~2e4 BDF2 steps, benchmarks/soak.py); the steady module
computes the same limits directly. Contracts tested here:

* solve_steady is the EXACT fixed point of the BE and CN marches (the
  k_ee elimination in the module docstring): marching from it moves
  nothing, and a converged BE march lands on it to roundoff.
* With use_correction the O(beta) psi-linear source converges in a
  handful of sweeps; without it ONE sweep is exact.
* solve_steady_cycle is the exact fixed point of the FULL configured
  step map — equal to solve_steady for BE/CN, and for BDF2 equal to
  where the reference's own 4-phase march settles (which is NOT the
  diamond steady solution — docs/QUIRKS.md #16; the bias is dt- and
  dx-independent and lives in the within-cell edge jumps).
* The equilibrium invariant: with psi_source = B_g exactly, the steady
  state IS the Planckian equilibrium (the GrayTest physics,
  tests/test_gray.cpp:89, without the time march).
"""

import conftest  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import load_config
from radiative_transfer.models import transport
from radiative_transfer.ops.fast_sweep import FastEngine
from radiative_transfer.steady import (
    run_steady_problem,
    solve_steady,
    solve_steady_cycle,
)

GRAY = "prm/single_group.prm"
MG = "prm/multi_group_equilibrium.prm"
LLNL = "prm/llnl_slab_test.prm"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _march_from(cfg, tables, ends, steps):
    eng = FastEngine(cfg, tables, dtype=jnp.float64)
    st = eng.from_ends(ends, ends, ends)
    return np.asarray(eng.ends(eng.solve(st, num_steps=steps)))


@pytest.mark.parametrize("deck", [GRAY, MG])
@pytest.mark.parametrize("ts", [1, 2])
def test_steady_is_exact_be_cn_fixed_point(deck, ts):
    cfg = load_config(deck, ts_method=ts)
    tables, _, _ = transport.build_tables(cfg)
    sr = solve_steady(cfg, tables)
    marched = _march_from(cfg, tables, sr.ends, 50)
    assert _rel(marched, sr.ends) < 1e-13


def test_be_march_converges_to_steady():
    # BE is L-stable: a few huge-dt steps land on the fixed point.
    cfg = load_config(GRAY, ts_method=1, dt=1.0)
    tables, _, _ = transport.build_tables(cfg)
    sr = solve_steady(cfg, tables)
    eng = FastEngine(cfg, tables, dtype=jnp.float64)
    marched = np.asarray(eng.ends(eng.solve(num_steps=60)))
    assert _rel(marched, sr.ends) < 1e-13


def test_correction_fixed_point_iteration_converges():
    cfg = load_config(MG, ts_method=1, dt=1.0)
    assert cfg.use_correction
    tables, _, _ = transport.build_tables(cfg)
    sr = solve_steady(cfg, tables)
    assert 1 < sr.iterations <= 20       # O(beta) contraction
    assert sr.residual < 1e-13
    eng = FastEngine(cfg, tables, dtype=jnp.float64)
    marched = np.asarray(eng.ends(eng.solve(num_steps=80)))
    assert _rel(marched, sr.ends) < 1e-13


def test_no_correction_single_sweep():
    cfg = load_config(MG, use_correction=False)
    tables, _, _ = transport.build_tables(cfg)
    sr = solve_steady(cfg, tables)
    assert sr.iterations == 1


def test_exact_equilibrium_source_gives_planckian():
    # psi_source = B_g exactly -> steady state == B_g everywhere and the
    # radiative flux vanishes (GrayTest invariant without the march).
    cfg0 = load_config(GRAY)
    B = np.asarray(transport.build_tables(cfg0)[0].B)
    src = tuple(tuple(float(B[g]) for g in range(cfg0.G))
                for _ in range(cfg0.M))
    cfg = load_config(GRAY, psi_source=src)
    res, sr = run_steady_problem(cfg)
    assert _rel(sr.ends, B[None, :, None, None]
                * np.ones_like(np.asarray(sr.ends))) < 1e-12
    assert np.max(np.abs(np.asarray(res.F))) < 1e-10


@pytest.mark.parametrize("ts", [1, 2])
def test_cycle_equals_direct_for_be_cn(ts):
    cfg = load_config(MG, ts_method=ts)
    tables, _, _ = transport.build_tables(cfg)
    a = solve_steady(cfg, tables)
    b = solve_steady_cycle(cfg, tables)
    assert _rel(b.ends, a.ends) < 1e-12


def test_cycle_is_exact_bdf2_fixed_point():
    cfg = load_config(MG)            # ts_method=3 in the deck
    assert cfg.ts_method == 3
    tables, _, _ = transport.build_tables(cfg)
    b = solve_steady_cycle(cfg, tables)
    assert b.residual < 1e-10
    marched = _march_from(cfg, tables, b.ends, 200)
    assert _rel(marched, b.ends) < 1e-10


def test_bdf2_cycle_bias_quirk():
    # QUIRKS #16: the reference's BDF2 predictor-corrector fixed point
    # differs from the spatial scheme's steady solution; on this deck
    # the bias is ~6.4e-4 and neither dt nor dx moves it.
    cfg = load_config(MG)
    tables, _, _ = transport.build_tables(cfg)
    a = solve_steady(cfg, tables)
    b = solve_steady_cycle(cfg, tables)
    gap = _rel(b.ends, a.ends)
    assert 1e-4 < gap < 3e-3
    cfg2 = load_config(MG, dt=cfg.dt / 4)
    b2 = solve_steady_cycle(cfg2, tables)
    assert abs(_rel(b2.ends, a.ends) - gap) < 0.1 * gap


def test_llnl_steady_small():
    # The shipped LLNL deck shape (N=50): one steady solve; marched BE
    # with large dt agrees. kappa spans [2e-2, 1e6] — the optically
    # thick groups exercise the a -> 0 underflow path.
    cfg = load_config(LLNL, ts_method=1, dt=1.0, max_timesteps=120)
    tables, _, _ = transport.build_tables(cfg)
    sr = solve_steady(cfg, tables)
    eng = FastEngine(cfg, tables, dtype=jnp.float64)
    marched = np.asarray(eng.ends(eng.solve(num_steps=120)))
    assert _rel(marched, sr.ends) < 1e-12
    assert np.all(np.isfinite(np.asarray(sr.ends)))


def test_run_steady_problem_diagnostics():
    res, sr = run_steady_problem(load_config(GRAY))
    assert res.psi.shape == (2, 1, 100)
    assert res.F.shape == (1, 100)
    assert np.all(np.isfinite(np.asarray(res.balance)))
    # steady state of the near-equilibrium gray deck stays near B
    assert float(np.max(np.abs(np.asarray(res.F)))) < 1e-4
