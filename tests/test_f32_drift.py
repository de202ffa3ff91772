"""f32 accuracy contract: drift of the f32 perf engines vs the f64 solve.

The fast (ops/fast_sweep) and GPU kernel (ops/triton_sweep, here in the
Pallas interpreter) engines run float32 for throughput;
docs/PERFORMANCE.md "f32 accuracy" reports
the measured drift over the decks' full transients (via
benchmarks/f32_drift.py). These tests pin CI-scale prefixes of those
transients with ~10x headroom so a regression that degrades f32
conditioning (e.g. a reordering that loses compensated structure in the
scan, or a precision downgrade on a matmul) is caught.

Reference accuracy bar for context: the reference's own acceptance test
asserts 1e-6 invariants in f64 (tests/test_gray.cpp:89, Constants.h:19);
the f32 engines hold ~1e-6..2e-5 relative over the shipped transients.
"""

import conftest  # noqa: F401

import numpy as np
import pytest

from radiative_transfer import load_config

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
from f32_drift import run_deck, stable_dt  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from radiative_transfer.ops import fast_sweep, triton_sweep  # noqa: E402

ENGINES = {
    "fast_f32": lambda cfg, t: fast_sweep.FastEngine(cfg, t,
                                                     dtype=jnp.float32),
    "triton_f32": lambda cfg, t: triton_sweep.TritonEngine(cfg, t,
                                                           interpret=True),
}


def _max_drift(rows, key):
    return max(r[key] for r in rows)


def test_gray_transient_drift():
    """single_group.prm, 250-step prefix of the shipped 1000-step run.
    Measured: 1.1e-6 (both engines) at 250 and at 1000 steps (saturates
    at the equilibrium fixpoint)."""
    cfg = load_config(conftest.reference_deck("single_group.prm"))
    rows = run_deck("gray", cfg, (250,), ENGINES)
    assert _max_drift(rows, "fast_f32") < 1e-5
    assert _max_drift(rows, "triton_f32") < 1e-5


def test_multigroup_equilibrium_drift():
    """multi_group_equilibrium.prm (v/c correction, mg-equilib BCs),
    200-step prefix of the shipped 500. Measured: 2.3e-5."""
    cfg = load_config(conftest.reference_deck("multi_group_equilibrium.prm"))
    rows = run_deck("mg", cfg, (200,), ENGINES)
    assert _max_drift(rows, "fast_f32") < 2e-4
    assert _max_drift(rows, "triton_f32") < 2e-4


def test_llnl_drift():
    """llnl_slab_test.prm: the real 2-step run at shipped dt (Courant
    ~7.5e4 — fine for 2 steps) plus a 60-step transient at a
    BDF2-stable dt (QUIRKS.md #14). Measured: 9.5e-7 / 7.6e-6."""
    cfg = load_config(conftest.reference_deck("llnl_slab_test.prm"))
    rows = run_deck("llnl2", cfg, (2,), ENGINES)
    assert _max_drift(rows, "fast_f32") < 1e-5
    assert _max_drift(rows, "triton_f32") < 1e-5

    cfg2 = cfg.replace(dt=stable_dt(cfg))
    rows = run_deck("llnl-tr", cfg2, (60,), ENGINES)
    assert _max_drift(rows, "fast_f32") < 1e-4
    assert _max_drift(rows, "triton_f32") < 1e-4
