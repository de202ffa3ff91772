"""Gray equilibrium integration test — the reference's one active test.

Runs the full solver on the reference's own prm/single_group.prm deck
(gray, S_2, N=100, BDF2, 1000 steps, reflective-left + equilibrium
source-right with psi_src = a c T^4): the pass criterion replicates the
reference exactly — the maximum ELEMENT of F stays below 1e-6
(spec: tests/test_gray.cpp:89 `F.maxCoeff() < 1.E-6`; the deck's rounded
source 4.0931 vs the internal B = 4.09309762 injects a small negative
flux, so max-element is the criterion that the reference actually
enforces).

A stricter invariant is added on top: with the boundary source set to
the internal equilibrium intensity exactly, max |F| stays at machine
precision after 1000 steps.
"""

import numpy as np

from conftest import reference_deck
from radiative_transfer import load_config
from radiative_transfer.models import transport


def test_gray_equilibrium_reference_criterion():
    cfg = load_config(reference_deck("single_group.prm"))
    assert cfg.max_timesteps == 1000 and cfg.ts_method == 3
    res = transport.run_problem(cfg)

    F = np.asarray(res.F)
    assert F.max() < 1e-6, f"max F element = {F.max()}"
    # the rounded deck source bounds the total flux perturbation
    assert np.abs(F).max() < 1e-4

    # psi stays uniform at the equilibrium intensity to the source rounding
    psi = np.asarray(res.psi)
    np.testing.assert_allclose(psi, psi[0, 0, 0], rtol=1e-5)

    # the balance diagnostic is printed (never asserted) by the reference
    # and is O(1) by construction even in equilibrium; just require finite
    assert np.all(np.isfinite(np.asarray(res.balance)))


def test_gray_exact_equilibrium_machine_precision():
    cfg = load_config(reference_deck("single_group.prm"))
    tables, _, _ = transport.build_tables(cfg)
    B = float(np.asarray(tables.B)[0])
    cfg = cfg.replace(psi_source=((B,), (B,)))
    res = transport.run_problem(cfg)
    F = np.asarray(res.F)
    assert np.abs(F).max() < 1e-9, f"max |F| = {np.abs(F).max()}"


def test_multigroup_equilibrium_deck():
    """prm/multi_group_equilibrium.prm: G=4, v/c correction, comoving
    equilibrium boundary sources, 500 BDF2 steps. The solution should hold
    near the equilibrium Planck spectrum (the deck's purpose)."""
    cfg = load_config(reference_deck("multi_group_equilibrium.prm"))
    res = transport.run_problem(cfg)
    psi = np.asarray(res.psi)
    assert np.all(np.isfinite(psi)) and np.all(psi > 0)
    # each group stays near its Planckian B_g: drift < 1% over 500 steps
    tables, _, _ = transport.build_tables(cfg)
    B = np.asarray(tables.B)
    rel = np.abs(psi - B[None, :, None]) / B[None, :, None]
    assert np.max(rel) < 1e-2, f"max relative drift from equilibrium {np.max(rel)}"


def test_llnl_deck_runs():
    """prm/llnl_slab_test.prm: 124 tabulated groups, kappa spanning
    2e-2..1e6, vacuum boundaries, 2 BDF2 steps. Must run without
    overflow/NaN across the optically-thick groups."""
    cfg = load_config(reference_deck("llnl_slab_test.prm"))
    res = transport.run_problem(cfg)
    for arr in (res.psi, res.phi, res.F, res.left_ends, res.right_ends):
        assert np.all(np.isfinite(np.asarray(arr)))
    # optically thick groups stay pinned at their Planckian equilibrium
    tables, _, _ = transport.build_tables(cfg)
    B = np.asarray(tables.B)
    kappa = np.asarray(tables.kappa)
    psi = np.asarray(res.psi)
    # (away from the vacuum boundary layers, which leak physically)
    thick = kappa > 1e3
    interior = psi[:, thick, 6:-6]
    rel = np.abs(interior - B[None, thick, None]) / B[None, thick, None]
    assert np.max(rel) < 1e-9
