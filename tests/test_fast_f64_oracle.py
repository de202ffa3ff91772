"""FastEngine at float64 == the straight-loop NumPy oracle (tests/oracle.py).

On a GPU, ``auto`` at float64 routes to FastEngine(dtype=float64): the
card computes f64 in hardware. These cases pin that engine to the
oracle at the f64 bar (1e-11 relative) over integrators x boundaries x
the v/c correction x padded N — the tiled layout, the boundary-fill
folding, the fused halves and the sweep-downstream pad cells all in one
matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import Config
from radiative_transfer.ops.fast_sweep import FastEngine
from test_sweep_vs_oracle import make_problem

BAR = 1e-11
BASE = dict(
    M=2, G=2, X=0.7, efirst=0.1, elast=10.0,
    rho=1.3, kappa_grey=0.8, T=1.0, dt=2e-4, max_timesteps=3,
    psi_source=((1.5, 0.3), (0.7, 2.2)),
    include_validation=False,
)


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("N", [32, 37])
@pytest.mark.parametrize("correction", [False, True])
@pytest.mark.parametrize("bc_left,bc_right", [(1, 1), (2, 1), (0, 0), (2, 0)])
@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_fast_f64_matches_oracle(ts_method, bc_left, bc_right, correction,
                                 N):
    cfg = Config(**{**BASE, "N": N, "X": 0.1 * N / 4, "ts_method": ts_method,
                    "bc_left_indicator": bc_left,
                    "bc_right_indicator": bc_right,
                    "use_correction": correction,
                    "V": 1.0 if correction else 0.0})
    tables, _, orc = make_problem(cfg)
    eng = FastEngine(cfg, tables, dtype=jnp.float64, chunk=8)
    assert (eng.pad > 0) == (N % 8 != 0)
    st = eng.solve(num_steps=3)
    orc.run(ts_method, 3)
    assert _rel(eng.ends(st), orc.ends) < BAR
    assert _rel(eng.ends_pair(st.p0, st.p1), orc.prev_ends) < BAR
    if ts_method == 3:
        assert _rel(eng.ends_pair(st.h0, st.h1), orc.half_ends) < BAR
