"""Device parity on the card: each engine the GPU routes to, against the
general float64 engine (models/transport.py) run on the same card.

Bars: FastEngine float64 holds 1e-11 relative (the native-f64 bar);
float32 engines hold the f32 drift bars of tests/test_f32_drift.py
(gray 1e-5, LLNL 1e-4).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import flagship_config, llnl_config  # noqa: E402
from radiative_transfer import parallel  # noqa: E402
from radiative_transfer.models import transport  # noqa: E402
from radiative_transfer.ops.fast_sweep import FastEngine  # noqa: E402
from radiative_transfer.ops.triton_sweep import TritonEngine  # noqa: E402
from radiative_transfer.parallel import sharded_fast  # noqa: E402

pytestmark = pytest.mark.gpu

F32_BAR = {"gray": 1e-5, "llnl": 1e-4}
STEPS = 16


def _cfg(name, N=None):
    if name == "gray":
        return flagship_config(N=N or 1 << 16, steps=STEPS)
    return llnl_config(N=N or 1 << 14, steps=STEPS)


def _general(cfg):
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    state = transport.initial_state(cfg, tables, dtype=jnp.float64)
    with jax.default_matmul_precision("highest"):
        out = transport.solve(cfg, tables, state, STEPS)
    return tables, np.asarray(out.ends)


def _rel(eng, st, ref):
    got = np.asarray(jnp.asarray(eng.ends(st), jnp.float64))
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("deck", ["gray", "llnl"])
def test_fast_f64_matches_general(gpu, deck):
    cfg = _cfg(deck)
    tables, ref = _general(cfg)
    eng = FastEngine(cfg, tables, dtype=jnp.float64)
    assert _rel(eng, eng.solve(num_steps=STEPS), ref) <= 1e-11


@pytest.mark.parametrize("deck", ["gray", "llnl"])
@pytest.mark.parametrize("kind", ["fast", "triton", "triton_two_pass"])
def test_f32_engine_drift(gpu, deck, kind):
    cfg = _cfg(deck)
    tables, ref = _general(cfg)
    if kind == "fast":
        eng = FastEngine(cfg, tables, dtype=jnp.float32)
    else:
        eng = TritonEngine(cfg, tables,
                           scan_tol=0.0 if kind == "triton_two_pass"
                           else 1e-10)
    assert _rel(eng, eng.solve(num_steps=STEPS), ref) <= F32_BAR[deck]


def test_triton_padded_n(gpu):
    """N with no power-of-two chunk: padded sweep-downstream cells and
    the reflective outflow read at the last real cell."""
    cfg = _cfg("gray", N=(1 << 16) - 3)
    tables, ref = _general(cfg)
    eng = TritonEngine(cfg, tables)
    assert eng.pad > 0
    assert _rel(eng, eng.solve(num_steps=STEPS), ref) <= F32_BAR["gray"]


def test_auto_routes_to_compiled_engines(gpu):
    cfg = _cfg("gray")
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    f32 = parallel.make_multichip_engine(cfg, tables, None,
                                         dtype=jnp.float32)
    f64 = parallel.make_multichip_engine(cfg, tables, None,
                                         dtype=jnp.float64)
    assert not getattr(f32, "interpret", False)
    assert isinstance(f64, FastEngine) and f64.dtype == jnp.float64


def test_sharded_fast_one_card_mesh(gpu):
    cfg = _cfg("llnl")
    tables, ref = _general(cfg)
    mesh = sharded_fast.make_mesh_1d(1)
    eng = sharded_fast.ShardedFastEngine(cfg, tables, mesh,
                                         dtype=jnp.float64)
    assert _rel(eng, eng.solve(num_steps=STEPS), ref) <= 1e-11
