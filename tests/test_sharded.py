"""Sharded solve == single-device solve, on a virtual 8-device CPU mesh.

Validates the scan-of-scans spatial decomposition (parallel/sharded.py):
ppermute halo exchange of upwind prev/half edges + all-gather composition
of per-shard affine maps must reproduce the unsharded solution to fp64
roundoff for every integrator and boundary-condition combination.
"""

import conftest  # noqa: F401  (forces the 8-device CPU platform)

import jax
import numpy as np
import pytest

from radiative_transfer import load_config
from radiative_transfer.models import transport
from radiative_transfer.parallel import sharded


def _run_pair(cfg, mesh, num_steps):
    tables, _, _ = transport.build_tables(cfg)
    state0 = transport.initial_state(cfg, tables)
    ref = transport.solve(cfg, tables, state0, num_steps)
    got = sharded.solve_sharded(cfg, tables, state0, mesh, num_steps)
    return ref, got


def _assert_state_close(ref, got, rtol=1e-12, atol=1e-13):
    for name in ("ends", "prev_ends", "half_ends"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(ref, name)),
            rtol=rtol, atol=atol, err_msg=name,
        )


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return sharded.make_mesh(n_spatial=8)


@pytest.fixture(scope="module")
def mesh4x2():
    return sharded.make_mesh(n_spatial=4, n_group=2)


@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_gray_sharded_matches(mesh8, ts_method):
    cfg = load_config(
        conftest.reference_deck("single_group.prm"),
        N=96, ts_method=ts_method, max_timesteps=5,
    )
    ref, got = _run_pair(cfg, mesh8, 5)
    _assert_state_close(ref, got)


def test_multigroup_correction_sharded_matches(mesh8):
    cfg = load_config(
        conftest.reference_deck("multi_group_equilibrium.prm"),
        N=96, max_timesteps=3,
    )
    ref, got = _run_pair(cfg, mesh8, 3)
    _assert_state_close(ref, got)


def test_group_axis_sharding(mesh4x2):
    cfg = load_config(
        conftest.reference_deck("multi_group_equilibrium.prm"),
        N=96, max_timesteps=3,
    )
    ref, got = _run_pair(cfg, mesh4x2, 3)
    _assert_state_close(ref, got)


def test_llnl_deck_sharded_matches(mesh8):
    cfg = load_config(
        conftest.reference_deck("llnl_slab_test.prm"),
        N=48, max_timesteps=2,
    )
    ref, got = _run_pair(cfg, mesh8, 2)
    _assert_state_close(ref, got)


@pytest.mark.parametrize("bc_left,bc_right", [(0, 0), (1, 1), (2, 0)])
def test_bc_combinations_sharded(mesh8, bc_left, bc_right):
    cfg = load_config(
        conftest.reference_deck("single_group.prm"),
        N=64, M=4, ts_method=3, max_timesteps=3,
        bc_left_indicator=bc_left, bc_right_indicator=bc_right,
    )
    ref, got = _run_pair(cfg, mesh8, 3)
    _assert_state_close(ref, got)
