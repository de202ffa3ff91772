"""Fast fused engine (ops/fast_sweep.py) == general engine (models/transport).

The fast path restructures the sweep (tiled chunk-major layout, oriented
storage, constant-a two-level scan, boundary-fill folding, fused halves) —
it must reproduce the general scan-parallel path, and hence the reference
semantics, to float64 roundoff on every integrator / BC / deck combination.
"""

import conftest  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import load_config
from radiative_transfer.models import transport
from radiative_transfer.ops import fast_sweep


def _compare(cfg, num_steps, chunk=16, rtol=1e-12, atol=1e-13):
    tables, _, _ = transport.build_tables(cfg)
    state0 = transport.initial_state(cfg, tables)
    ref = transport.solve(cfg, tables, state0, num_steps)

    eng, fst = fast_sweep.solve_fast(
        cfg, tables, num_steps=num_steps, dtype=jnp.float64, chunk=chunk
    )
    got = eng.ends(fst)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref.ends), rtol=rtol, atol=atol
    )
    got_prev = eng.ends_pair(fst.p0, fst.p1)
    np.testing.assert_allclose(
        np.asarray(got_prev), np.asarray(ref.prev_ends), rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_gray_deck(ts_method):
    cfg = load_config(
        conftest.reference_deck("single_group.prm"),
        ts_method=ts_method, max_timesteps=5,
    )
    _compare(cfg, 5, chunk=10)


def test_multigroup_correction_deck():
    cfg = load_config(
        conftest.reference_deck("multi_group_equilibrium.prm"), max_timesteps=4
    )
    _compare(cfg, 4, chunk=25)


def test_llnl_deck():
    cfg = load_config(
        conftest.reference_deck("llnl_slab_test.prm"), max_timesteps=2
    )
    _compare(cfg, 2, chunk=10)


def test_roundtrip_layout():
    """from_ends -> ends round-trips exactly."""
    cfg = load_config(
        conftest.reference_deck("multi_group_equilibrium.prm"), N=40
    )
    tables, _, _ = transport.build_tables(cfg)
    eng = fast_sweep.FastEngine(cfg, tables, dtype=jnp.float64, chunk=8)
    rng = np.random.default_rng(0)
    ends = rng.random((cfg.M, cfg.G, cfg.N, 2))
    st = eng.from_ends(ends, ends * 2.0, ends * 3.0)
    np.testing.assert_array_equal(np.asarray(eng.ends(st)), ends)
    np.testing.assert_array_equal(
        np.asarray(eng.ends_pair(st.h0, st.h1)), ends * 3.0
    )


@pytest.mark.parametrize("bc_left,bc_right", [(0, 0), (1, 1), (2, 0), (2, 1)])
def test_bc_combinations(bc_left, bc_right):
    cfg = load_config(
        conftest.reference_deck("single_group.prm"),
        M=8, N=64, ts_method=3, max_timesteps=3,
        bc_left_indicator=bc_left, bc_right_indicator=bc_right,
        psi_source=tuple((float(i + 1),) for i in range(8)),
    )
    _compare(cfg, 3, chunk=16)


def test_equilibrium_preserved_fast_f32():
    """The GrayTest invariant holds in float32 on the fast path to a
    float32-appropriate tolerance (reference bar is 1e-6 in f64,
    tests/test_gray.cpp:89-98)."""
    cfg = load_config(conftest.reference_deck("single_group.prm"))
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng, fst = fast_sweep.solve_fast(
        cfg, tables, num_steps=50, dtype=jnp.float32, chunk=25
    )
    psi = transport.psi_from_ends(eng.ends(fst))
    F = transport.compute_F(
        psi, jnp.asarray(tables.mu, jnp.float32), jnp.asarray(tables.wt, jnp.float32)
    )
    assert float(jnp.max(jnp.abs(F))) < 1e-3
