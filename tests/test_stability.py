"""Time-integrator stability envelope (docs/QUIRKS.md #14).

The reference's BDF2 4-phase predictor-corrector cycle
(src/solver.cpp:723-750) is unstable once the cell Courant number
c*dt/dx exceeds ~0.5-1 — verified against the reference binary itself,
which diverges identically (see QUIRKS.md). BE and CN are
unconditionally stable. These tests pin that envelope so (a) a future
engine change that *breaks* BE/CN stability is caught, and (b) the
documented BDF2 bound stays honest: bench.py and any high-resolution
workload must derive dt from it.

Setup: gray equilibrium slab (reflective left, equilibrium source
right, psi initialised to B) — the exact-equilibrium invariant of
tests/test_gray.cpp:89. A stable integrator holds the state at B
indefinitely; an unstable one diverges within a few hundred steps.
"""

import conftest  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer.config.config import Config
from radiative_transfer.models import transport
from radiative_transfer.ops import fast_sweep


def _max_after(ts_method: int, courant: float, steps: int = 512,
               N: int = 128) -> float:
    C = 299.79245800
    dx = 1.0 / N
    dt = courant * dx / C
    tables0 = transport.build_tables(
        Config(M=4, G=1, N=N, X=1.0, T=1.0, rho=1.0, kappa_grey=1.0)
    )[0]
    B = float(tables0.B[0])
    cfg = Config(
        M=4, G=1, N=N, X=1.0, T=1.0, rho=1.0, kappa_grey=1.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple([B]) for _ in range(4)),
        ts_method=ts_method, dt=dt, max_timesteps=steps,
        include_validation=False,
    )
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng, fst = fast_sweep.solve_fast(
        cfg, tables, num_steps=steps, dtype=jnp.float64, chunk=N
    )
    return float(np.max(np.abs(np.asarray(eng.ends(fst)))))


@pytest.mark.parametrize("ts_method", [1, 2])
def test_be_cn_stable_at_huge_courant(ts_method):
    # BE (1) and CN (2) are unconditionally stable implicit schemes:
    # equilibrium holds even at cell Courant 100.
    B = 4.0931
    m = _max_after(ts_method, courant=100.0, steps=256)
    assert m == pytest.approx(B, rel=1e-3), m


def test_bdf2_stable_inside_envelope():
    # Courant 0.4 — the regime bench.py runs in.
    B = 4.0931
    m = _max_after(3, courant=0.4, steps=512)
    assert m == pytest.approx(B, rel=1e-3), m


def test_bdf2_diverges_outside_envelope():
    # Courant 4: the reference's own scheme diverges (the reference
    # binary reaches ~1e21 by step 256 at Courant 3). If this ever
    # *passes* equilibrium, the engine no longer reproduces the
    # reference cycle — investigate before celebrating.
    m = _max_after(3, courant=4.0, steps=512)
    assert m > 1e3, f"BDF2 unexpectedly stable at Courant 4 (max={m})"
