#!/usr/bin/env python
"""Production-scale soak: a long LLNL 124-group run on the attached device.

Drives the auto-selected engine through a transient far longer than any
test (default 20k BDF2 steps at benchmark resolution) with periodic
exact checkpoints, asserting at every chunk that the state stays finite
and that the run reaches a steady state. Prints one JSON line per chunk
plus a final summary.

Earlier runs of this deck's BDF2 transient at Courant 0.4 showed
NON-NORMAL growth — psi_max rising six decades before decaying to the
true steady state, as a stable-but-highly-non-normal upwind operator can
— with f32 engines tracking the f64 trajectory to ~1e-4 relative.

The per-chunk `updates_per_s` includes the full-state materialisation
and the checkpoint write — this is a STABILITY artifact, not a
throughput benchmark (rates live in benchmarks/suite.py).

Usage: python benchmarks/soak.py [--steps 20480] [--chunk 2048]
       [--dtype float32|float64]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_C = 299.79245800


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20480)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--n-cells", type=int, default=1 << 12)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"),
                    help="float64: the reference-precision soak")
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from radiative_transfer import load_config, parallel
    from radiative_transfer.models import transport
    from radiative_transfer.utils import checkpoint as ckpt
    from radiative_transfer.utils.debug import make_ends_checker

    deck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "prm", "llnl_slab_test.prm")
    cfg0 = load_config(deck)
    N = args.n_cells
    cfg = load_config(deck, N=N, max_timesteps=args.steps,
                      dt=0.4 * (cfg0.X / N) / _C)
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng = parallel.make_multichip_engine(cfg, tables, None,
                                         dtype=jnp.dtype(args.dtype))
    check = make_ends_checker()
    print(json.dumps({"deck": "llnl_slab_test", "engine":
                      type(eng).__name__, "M": cfg.M, "G": cfg.G,
                      "N": cfg.N, "steps": args.steps, "dt": cfg.dt}),
          flush=True)

    psi_max_hist = []
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckdir:
        state, done = eng.init_state(), 0
        while done < args.steps:
            n = min(args.chunk, args.steps - done)
            t0 = time.perf_counter()
            state = eng.solve(state, num_steps=n)
            ends = jnp.asarray(eng.ends(state), jnp.float64)
            ends_h = np.asarray(ends)   # host copy: the timing waits for it
            wall = time.perf_counter() - t0
            done += n
            check(ends, done)                       # finite guard
            ckpt.save_checkpoint(
                ckdir, transport.State(ends_h, ends_h, ends_h), done, cfg)
            psi = transport.psi_from_ends(ends)
            phi = transport.compute_phi(psi, jnp.asarray(tables.wt,
                                                         jnp.float64))
            bal = np.asarray(transport.compute_balance(cfg, tables, ends,
                                                       phi))
            psi_max = float(np.abs(np.asarray(psi)).max())
            psi_max_hist.append(psi_max)
            print(json.dumps({
                "step": done, "wall_s": round(wall, 3),
                "updates_per_s": round(4 * cfg.M * cfg.G * cfg.N * n
                                       / wall / 1e9, 2),
                "balance_max": float(bal.max()),
                "balance_mean": float(bal.mean()),
                "psi_max": psi_max,
            }), flush=True)

    total = time.perf_counter() - t_all
    # Steady state reached: psi_max of the last two chunks identical to
    # f32 print precision (the module-doc excursion has died away). The
    # balance diagnostic is NOT a convergence metric for this deck: its
    # optically-thin groups end with source terms at underflow scale, so
    # their |sinks-sources|/sources ratio is noise ~ 1.
    assert psi_max_hist[-1] == psi_max_hist[-2], psi_max_hist[-4:]
    print(json.dumps({
        "soak": "ok", "total_steps": args.steps,
        "total_wall_s": round(total, 1),
        "psi_max_excursion": max(psi_max_hist),
        "psi_max_steady": psi_max_hist[-1],
    }), flush=True)


if __name__ == "__main__":
    main()
