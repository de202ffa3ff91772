#!/usr/bin/env python
"""Benchmark: cell-angle-group updates/s per card on the flagship workload.

Workload (BASELINE.md "high-resolution gray slab"): S_32 gray slab,
N = 2^20 cells, BDF2 — 4 sub-steps per timestep, each a batched
scan-parallel transport sweep. One "update" is one per-(cell, angle,
group) 2x2 upwind solve, i.e. 4*M*G*N updates per full BDF2 step
(matching the reference's innermost-loop trip count, src/solver.cpp:628-811).

dt is derived from a cell Courant number c*dt/dx = 0.4: the reference's
BDF2 predictor-corrector cycle is numerically unstable for cell Courant
>~ 0.5 (verified against the reference binary itself — both codes blow
up identically; see docs/QUIRKS.md "BDF2 stability envelope"), so a
fixed dt=1e-5 at N=2^20 would time exponentially-diverging garbage.
The timing itself is dt-independent (same FLOPs per step).

The engine is the one ``--engine auto`` picks for one card
(``parallel.make_multichip_engine``). Timing: compile and one warm-up
call untimed, then the fastest of several calls that each end in
``block_until_ready``. A machine without a GPU is an error: no CPU
number is ever printed under the device metric.

`vs_baseline`: the reference publishes no numbers (BASELINE.md), so the
comparison point is the reference miniapp compiled against the
Eigen-subset shim and timed on a host CPU with BE stepping. The
denominator is FROZEN (benchmarks/results/reference_baseline_frozen.json)
so vs_baseline is comparable between runs.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "updates/s", "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": N}
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def flagship_config(N=1 << 20, steps=64, M=32, G=1):
    """The high-resolution gray slab: S_M, N cells, BDF2, reflective left
    / source right, dt at cell Courant 0.4."""
    from radiative_transfer.config.config import Config
    from radiative_transfer.constants import SPEED_OF_LIGHT

    dt = 0.4 * (1.0 / N) / SPEED_OF_LIGHT
    return Config(
        M=M, G=G, N=N, X=1.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(4.0931 for _ in range(G)) for _ in range(M)),
        rho=1.0, kappa_grey=1.0, T=1.0,
        ts_method=3, dt=dt, max_timesteps=steps,
        include_validation=False,
    )


def llnl_config(N=1 << 14, steps=20):
    """The reference's 124-group LLNL deck (prm/llnl_slab_test.prm:
    tabulated bounds and opacities, correction on) with N cells and dt
    cut to cell Courant 0.4 — at the shipped dt=1e-3 the reference's
    BDF2 cycle is unstable at high N (docs/QUIRKS.md)."""
    from radiative_transfer import load_config
    from radiative_transfer.constants import SPEED_OF_LIGHT

    deck = os.path.join(HERE, "prm", "llnl_slab_test.prm")
    X = load_config(deck).X
    return load_config(deck, N=N, dt=0.4 * (X / N) / SPEED_OF_LIGHT,
                       max_timesteps=steps)


def check_bounded(state, limit=1e3):
    """Refuse a rate measured on diverged garbage: every leaf finite and
    below ``limit`` (the gray equilibrium is ~4.09)."""
    import jax
    import jax.numpy as jnp

    for leaf in jax.tree_util.tree_leaves(state):
        m = float(jnp.max(jnp.abs(leaf)))
        if not np.isfinite(m) or m > limit:
            raise RuntimeError(f"state diverged (max|x|={m:.3e})")


def device_updates_per_s(N=1 << 20, steps=64, dtype="float32"):
    import jax
    import jax.numpy as jnp

    from radiative_transfer import parallel
    from radiative_transfer.models import transport

    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    from timing import time_best

    cfg = flagship_config(N=N, steps=steps)
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    tables, _, _ = transport.build_tables(cfg, dtype=jdt)
    eng = parallel.make_multichip_engine(cfg, tables, None, dtype=jdt)
    run = jax.jit(lambda s: eng.solve(s, num_steps=steps))
    best, out = time_best(run, eng.init_state(), repeats=4)
    check_bounded(out)
    return cfg.M * cfg.G * cfg.N * 4 * steps / best, type(eng).__name__


def reference_updates_per_s():
    """The reference miniapp's frozen CPU rate (updates/s)."""
    with open(os.path.join(HERE, "benchmarks", "results",
                           "reference_baseline_frozen.json")) as fh:
        return float(json.load(fh)["updates_per_s"])


def main():
    import jax

    from radiative_transfer import backend

    if backend.platform() != "gpu":
        raise SystemExit("bench.py measures the GPU and JAX found none")
    value, engine = device_updates_per_s()
    dev = jax.devices()
    print(json.dumps({
        "metric": "cell_angle_group_updates_per_s_per_card",
        "value": value,
        "unit": "updates/s",
        "vs_baseline": value / reference_updates_per_s(),
        "engine": engine,
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
    }))


if __name__ == "__main__":
    main()
