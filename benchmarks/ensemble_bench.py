#!/usr/bin/env python
"""Measure the stacked-ensemble payoff on decks with few rows.

Claim under test (radiative_transfer/ensemble.py): a deck with few
direction-half rows (gray S_8: Bh = M/2*G = 4) cannot fill the device
alone, but an ensemble of K such members stacked along the group axis
(G' = K*G, Bh' = K*Bh) runs the WHOLE ensemble at near-headline
aggregate rate — i.e. K members for roughly the price of one.

Compares, at fixed per-member workload (benchmarks/timing.py):
  baseline  — one member on the auto-selected one-device engine,
              aggregate rate = K * (member rate) if run back-to-back;
  stacked   — solve_ensemble_stacked's engine on the G'=K*G problem.

Usage: python benchmarks/ensemble_bench.py [--N 131072] [--steps 64]
       [--K 4 16 64] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from radiative_transfer.config.config import Config
from radiative_transfer.models import transport
from radiative_transfer import ensemble
from radiative_transfer.parallel import make_multichip_engine
from benchmarks.timing import time_best

C = 299.79245800  # cm/sh


def gray_cfg(M, G, N, steps):
    dt = 0.4 * (1.0 / N) / C
    return Config(
        M=M, G=G, N=N, X=1.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(4.0931 for _ in range(G)) for _ in range(M)),
        rho=1.0, kappa_grey=1.0, T=1.0,
        ts_method=3, dt=dt, max_timesteps=steps,
        include_validation=False,
    )


def rate_engine(eng, cfg, steps, K_members=1):
    run = lambda st: eng.solve(st, num_steps=steps)  # noqa: E731
    best, _ = time_best(run, eng.init_state())
    return 4.0 * cfg.M * cfg.G * cfg.N * steps / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--G", type=int, default=1)
    ap.add_argument("--N", type=int, default=1 << 17)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--K", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    args = ap.parse_args()

    cfg = gray_cfg(args.M, args.G, args.N, args.steps)
    tables, _, _ = transport.build_tables(cfg)

    rows = []
    dtype = np.dtype(args.dtype)
    eng1 = make_multichip_engine(cfg, tables, None, dtype=dtype)
    r1 = rate_engine(eng1, cfg, args.steps)
    print(f"single member  Bh={cfg.M // 2 * cfg.G:4d}  "
          f"{type(eng1).__name__:20s} {r1 / 1e9:8.1f} G/s")
    rows.append({"K": 1, "engine": type(eng1).__name__, "rate": r1,
                 "aggregate": r1})

    for K in args.K:
        kappas = np.full((K, cfg.G), cfg.kappa_grey)
        cfg_s, tables_s, _ = ensemble.stack_ensemble(
            cfg, tables, {"kappa": kappas})
        eng = make_multichip_engine(cfg_s, tables_s, None, dtype=dtype)
        agg = rate_engine(eng, cfg_s, args.steps)
        # Serial baseline: K members back-to-back still process updates
        # at r1 overall, so the ensemble speedup is agg / r1.
        print(f"stacked K={K:4d}  Bh={cfg_s.M // 2 * cfg_s.G:4d}  "
              f"{type(eng).__name__:20s} {agg / 1e9:8.1f} G/s aggregate "
              f"({agg / r1:5.2f}x vs serial members)")
        rows.append({"K": K, "engine": type(eng).__name__,
                     "rate": agg / K, "aggregate": agg,
                     "speedup_vs_serial": agg / r1})

    if args.json:
        import jax

        dev = jax.devices()[0]
        doc = {"cfg": {"M": args.M, "G": args.G, "N": args.N,
                       "steps": args.steps, "dtype": args.dtype},
               "platform": dev.platform, "device_kind": dev.device_kind,
               "rows": rows}
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
