"""The scan-parallel sweep must reproduce the straight-loop oracle exactly.

Covers every integrator (BE/CN/BDF2), both direction signs, all boundary
condition combinations, the v/c correction source, and multiple angular
orders. Tolerances are ~1e-12: same arithmetic, different evaluation
order only.
"""

import numpy as np
import pytest

from radiative_transfer import Config
from radiative_transfer.models import transport
from oracle import Oracle


def make_problem(cfg: Config, dtype=None):
    import jax.numpy as jnp

    tables, grid, ct = transport.build_tables(cfg)
    state = transport.initial_state(cfg, tables)
    orc = Oracle(
        M=cfg.M, G=cfg.G, N=cfg.N, dx=cfg.dx, dt=cfg.dt,
        mu=np.asarray(tables.mu), wt=np.asarray(tables.wt),
        rho=np.asarray(tables.rho), kappa=np.asarray(tables.kappa),
        B=np.asarray(tables.B),
        psi_source=np.asarray(tables.psi_source),
        bc_left=cfg.bc_left_indicator, bc_right=cfg.bc_right_indicator,
        use_correction=cfg.use_correction,
        cor1=np.asarray(tables.cor1), cor2=np.asarray(tables.cor2),
        cor3=np.asarray(tables.cor3), beta=cfg.beta,
    )
    return tables, state, orc


def run_both(cfg: Config, n_steps: int):
    tables, state, orc = make_problem(cfg)
    state = transport.solve(cfg, tables, state, num_steps=n_steps)
    orc.run(cfg.ts_method, n_steps)
    return state, orc


def assert_match(state, orc, tol=1e-11):
    np.testing.assert_allclose(np.asarray(state.ends), orc.ends, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        np.asarray(transport.psi_from_ends(state.ends)), orc.psi, rtol=tol, atol=tol
    )


BASE = dict(
    M=2, G=2, N=7, X=0.7, efirst=0.1, elast=10.0,
    rho=1.3, kappa_grey=0.8, T=1.0, dt=2e-4, max_timesteps=3,
    bc_left_indicator=1, bc_right_indicator=1,
    psi_source=((1.5, 0.3), (0.7, 2.2)),
    include_validation=False,
)


@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_integrators_source_bc(ts_method):
    cfg = Config(**{**BASE, "ts_method": ts_method})
    assert_match(*run_both(cfg, 3))


@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_reflective_left(ts_method):
    cfg = Config(**{**BASE, "ts_method": ts_method, "bc_left_indicator": 2})
    assert_match(*run_both(cfg, 3))


def test_vacuum_right_vacuum_left_fallthrough():
    # left vacuum falls through to the source value (reference quirk);
    # right vacuum is a true zero
    cfg = Config(**{**BASE, "ts_method": 3,
                    "bc_left_indicator": 0, "bc_right_indicator": 0})
    assert_match(*run_both(cfg, 2))


@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_with_correction_and_velocity(ts_method):
    cfg = Config(**{**BASE, "ts_method": ts_method, "use_correction": True,
                    "V": 1.0, "G": 3,
                    "psi_source": ((1.0, 0.5, 0.2), (0.3, 0.9, 1.1))})
    assert_match(*run_both(cfg, 3))


def test_s8_many_cells():
    cfg = Config(**{**BASE, "ts_method": 3, "M": 8, "N": 33,
                    "bc_left_indicator": 2,
                    "psi_source": tuple((0.1 * (i + 1), 0.2) for i in range(8))})
    assert_match(*run_both(cfg, 2))


def test_optically_thick():
    # kappa ~ 1e6: near-singular per-cell systems; contraction a ~ 0
    cfg = Config(**{**BASE, "ts_method": 3, "kappa_grey": 1e6, "dt": 1e-3})
    assert_match(*run_both(cfg, 2))


def test_grey_deck_semantics():
    cfg = Config(M=2, G=1, N=10, X=1.0, ts_method=3, dt=1e-5,
                 bc_left_indicator=2, bc_right_indicator=1,
                 psi_source=((4.0931,), (4.0931,)), use_correction=True,
                 include_validation=False)
    assert_match(*run_both(cfg, 3))


def test_affine_scan_matches_sequential():
    import jax.numpy as jnp

    from radiative_transfer.ops.scan import (
        affine_scan,
        affine_scan_sequential,
        apply_prefix,
    )

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.uniform(0.1, 0.9, size=(3, 2, 17)))
    b = jnp.asarray(rng.normal(size=(3, 2, 17)))
    init = jnp.asarray(rng.normal(size=(3, 2)))
    pa1, pb1 = affine_scan(a, b)
    pa2, pb2 = affine_scan_sequential(a, b)
    np.testing.assert_allclose(np.asarray(pa1), np.asarray(pa2), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(pb1), np.asarray(pb2), rtol=1e-13, atol=1e-13)
    c1 = apply_prefix(pa1, pb1, init)
    # explicit recurrence
    c_ref = np.zeros((3, 2, 17))
    cur = np.asarray(init)
    for j in range(17):
        cur = np.asarray(a)[..., j] * cur + np.asarray(b)[..., j]
        c_ref[..., j] = cur
    np.testing.assert_allclose(np.asarray(c1), c_ref, rtol=1e-12, atol=1e-13)
