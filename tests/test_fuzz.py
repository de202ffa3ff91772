"""Randomized configuration sweep: every engine vs the straight-loop
oracle on seeded random problems (shapes, BCs, integrators, physics)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp

from radiative_transfer.config.config import Config
from radiative_transfer.models import transport
from radiative_transfer.ops import fast_sweep
from oracle import Oracle


def _random_cfg(rng) -> Config:
    M = int(rng.choice([2, 4, 8]))
    G = int(rng.integers(1, 5))
    N = int(rng.choice([17, 32, 50, 96]))
    return Config(
        M=M, G=G, N=N,
        X=float(rng.uniform(0.2, 2.0)),
        efirst=0.1, elast=10.0,
        bc_left_indicator=int(rng.choice([0, 1, 2])),
        bc_right_indicator=int(rng.choice([0, 1, 2])),
        psi_source=tuple(
            tuple(float(rng.uniform(0, 5)) for _ in range(G))
            for _ in range(M)
        ),
        rho=float(rng.uniform(0.5, 2.0)),
        kappa_grey=float(10.0 ** rng.uniform(-1, 2)),
        T=float(rng.uniform(0.5, 2.0)),
        V=float(rng.uniform(0.0, 3.0)),
        use_correction=bool(rng.integers(0, 2)),
        ts_method=int(rng.choice([1, 2, 3])),
        dt=float(10.0 ** rng.uniform(-6, -4)),
        max_timesteps=int(rng.integers(2, 6)),
        include_validation=False,
    )


def _oracle_solve(cfg: Config, tables, ct):
    o = Oracle(
        M=cfg.M, G=cfg.G, N=cfg.N, dx=cfg.dx, dt=cfg.dt,
        mu=np.asarray(tables.mu), wt=np.asarray(tables.wt),
        rho=np.asarray(tables.rho), kappa=np.asarray(tables.kappa),
        B=np.asarray(ct.B), psi_source=np.asarray(tables.psi_source),
        bc_left=cfg.bc_left_indicator, bc_right=cfg.bc_right_indicator,
        use_correction=cfg.use_correction,
        cor1=ct.cor1, cor2=ct.cor2, cor3=ct.cor3, beta=cfg.beta,
    )
    o.run(cfg.ts_method, cfg.max_timesteps)
    return o


@pytest.mark.parametrize("seed", range(12))
def test_random_config_all_engines_match_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = _random_cfg(rng)
    tables, _, ct = transport.build_tables(cfg)
    oracle = _oracle_solve(cfg, tables, ct)
    scale = np.abs(oracle.ends).max() + 1e-300

    res = transport.run_problem(cfg)
    d_gen = np.abs(np.asarray(res.state.ends) - oracle.ends).max() / scale
    assert d_gen < 1e-11, f"general engine diverged ({cfg})"

    feng, fst = fast_sweep.solve_fast(cfg, tables, dtype=jnp.float64, chunk=8)
    d_fast = np.abs(np.asarray(feng.ends(fst)) - oracle.ends).max() / scale
    assert d_fast < 1e-11, f"fast engine diverged ({cfg})"


def test_config_validation_errors():
    with pytest.raises(ValueError, match="even"):
        Config(M=3)
    with pytest.raises(ValueError, match="ts_method"):
        Config(ts_method=4)
    with pytest.raises(ValueError, match="bc_left"):
        Config(bc_left_indicator=7)
    with pytest.raises(ValueError, match="group_bounds"):
        Config(G=2, have_group_bounds=True, group_bounds=(1.0, 2.0))
    with pytest.raises(ValueError, match="dt"):
        Config(dt=0.0)


def test_bdf2_symmetric_half_mode():
    """The corrected symmetric snapshot (opt-in): engines agree with each
    other and differ from the parity-quirk trajectory."""
    from radiative_transfer.ops import triton_sweep

    base = Config(
        M=4, G=3, N=48, bc_left_indicator=1, bc_right_indicator=1,
        psi_source=tuple(tuple(2.0 for _ in range(3)) for _ in range(4)),
        use_correction=True, V=1.0, ts_method=3, dt=1e-5, max_timesteps=4,
        include_validation=False,
    )
    sym = base.replace(bdf2_symmetric_half=True)

    def run_gen(cfg):
        return np.asarray(transport.run_problem(cfg).state.ends)

    e_quirk = run_gen(base)
    e_sym = run_gen(sym)
    assert not np.allclose(e_quirk, e_sym, rtol=1e-9)

    tables, _, _ = transport.build_tables(sym)
    feng, fst = fast_sweep.solve_fast(sym, tables, dtype=jnp.float64, chunk=8)
    np.testing.assert_allclose(
        np.asarray(feng.ends(fst)), e_sym, rtol=0,
        atol=1e-12 * np.abs(e_sym).max(),
    )
    peng = triton_sweep.TritonEngine(sym, tables, chunk=8, interpret=True)
    pst = peng.solve(num_steps=4)
    scale = np.abs(e_sym).max()
    assert np.abs(np.asarray(peng.ends(pst)) - e_sym).max() / scale < 1e-5
