#!/usr/bin/env python
"""Benchmark suite: updates/s per device across workloads and engines.

Extends the headline bench.py (which prints one JSON line)
with the BASELINE.md workload matrix: the gray high-resolution slab,
multigroup slabs with correction sources, the LLNL 124-group deck, every
engine and both precisions. Prints one JSON line per case (with the
device it ran on) plus a summary table.

Usage:
    python benchmarks/suite.py [--quick] [--engines auto,triton,fast,general]
        [--check-auto]

The triton engine needs a GPU. Timing: compile and one warm-up call
untimed, then the fastest of ``--repeats`` calls that end in
block_until_ready (benchmarks/timing.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _mk_cfg(M, G, N, steps, use_correction=False, courant=0.4):
    """Gray/multigroup slab with dt from a cell Courant number (the BDF2
    4-phase cycle is unstable above cell Courant ~0.5, docs/QUIRKS.md)."""
    from bench import flagship_config

    cfg = flagship_config(N=N, steps=steps, M=M, G=G)
    return cfg.replace(V=1.0 if use_correction else 0.0,
                       use_correction=use_correction,
                       dt=cfg.dt * courant / 0.4)


def make_engine(engine, cfg, tables, dtype, scan_tol):
    from radiative_transfer import parallel
    from radiative_transfer.ops.fast_sweep import FastEngine
    from radiative_transfer.ops.triton_sweep import TritonEngine

    if engine == "auto":
        return parallel.make_multichip_engine(cfg, tables, None, dtype=dtype,
                                              scan_tol=scan_tol)
    if engine == "triton":
        return TritonEngine(cfg, tables, scan_tol=scan_tol)
    if engine == "fast":
        return FastEngine(cfg, tables, dtype=dtype)
    raise ValueError(f"unknown engine {engine!r}")


def run_case(engine, cfg, dtype_name, scan_tol=1e-10, repeats=3):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from radiative_transfer.models import transport
    from timing import time_best

    dtype = jnp.float32 if dtype_name == "float32" else jnp.float64
    steps = cfg.max_timesteps
    tables, _, _ = transport.build_tables(cfg, dtype=dtype)
    if engine == "general":
        state = transport.initial_state(cfg, tables, dtype=dtype)
        step = transport.make_step_fn(cfg, tables)

        @jax.jit
        def run(s):
            return lax.fori_loop(0, steps, lambda _, x: step(x), s)
    else:
        eng = make_engine(engine, cfg, tables, dtype, scan_tol)
        state = eng.init_state()

        def run(s):
            return eng.solve(s, num_steps=steps)

    best, _ = time_best(run, state, repeats)
    return 4 * cfg.M * cfg.G * cfg.N * steps / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--engines", default="auto,triton,fast")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--check-auto", action="store_true",
                    help="exit nonzero if the auto engine loses to any "
                         "sibling row by more than 10%% (the selection "
                         "contract, tests/test_engine_auto.py)")
    args = ap.parse_args()

    import jax

    from bench import llnl_config

    dev = jax.devices()[0]
    scale = 16 if args.quick else 1

    # (name, builder(N, steps), N, steps, scan_tol). The [full-scan] rows
    # pin scan_tol=0: the kernel's exact two-pass scan instead of the
    # truncated look-back (only the triton engine reads scan_tol).
    def slab(M, G, corr=False):
        return lambda N, steps: _mk_cfg(M, G, N, steps, corr)

    cases = [
        ("gray_hires_s32", slab(32, 1), (1 << 20) // scale, 64, 1e-10),
        ("gray_hires_s32[full-scan]", slab(32, 1), (1 << 20) // scale, 64,
         0.0),
        ("gray_s8", slab(8, 1), (1 << 18) // scale, 64, 1e-10),
        ("mg16_correction_s8", slab(8, 16, True), (1 << 16) // scale, 32,
         1e-10),
        ("mg128_s4", slab(4, 128), (1 << 13) // scale, 32, 1e-10),
        # The real LLNL 124-group deck (tabulated bounds, kappa_a over 8
        # decades, correction on) at the Courant-0.4 dt.
        ("llnl_124g", lambda N, s: llnl_config(N=N, steps=s),
         (1 << 14) // scale, 64, 1e-10),
        ("llnl_124g[full-scan]", lambda N, s: llnl_config(N=N, steps=s),
         (1 << 14) // scale, 64, 0.0),
    ]
    engines = args.engines.split(",")

    rows = []
    for name, build, N, steps, tol in cases:
        for engine in engines:
            if "full-scan" in name and engine != "triton":
                continue  # the control row only varies the kernel's scan
            dtypes = (["float32"] if engine == "triton"
                      else ["float32", "float64"])
            for dt in dtypes:
                cfg = build(N, steps)
                ups = run_case(engine, cfg, dt, scan_tol=tol,
                               repeats=args.repeats)
                rec = {
                    "case": name, "engine": engine, "dtype": dt,
                    "M": cfg.M, "G": cfg.G, "N": N, "steps": steps,
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                    "updates_per_s": ups,
                }
                rows.append(rec)
                print(json.dumps(rec), flush=True)

    print("\ncase                        engine   dtype    G updates/s",
          file=sys.stderr)
    for r in rows:
        print(f"{r['case']:<27} {r['engine']:<8} {r['dtype']:<8} "
              f"{r['updates_per_s'] / 1e9:8.2f}", file=sys.stderr)

    if args.check_auto:
        # The selection contract: per case and dtype, auto must never
        # lose to a sibling engine by more than the 10% noise floor.
        bad = []
        for key in {(r["case"], r["dtype"]) for r in rows}:
            same = [r for r in rows if (r["case"], r["dtype"]) == key]
            autos = [r["updates_per_s"] for r in same
                     if r["engine"] == "auto"]
            sibs = [r["updates_per_s"] for r in same
                    if r["engine"] not in ("auto", "general")]
            if autos and sibs and max(autos) < 0.9 * max(sibs):
                bad.append((key, max(autos) / 1e9, max(sibs) / 1e9))
        for key, a, s in bad:
            print(f"AUTO LOSES on {key}: {a:.2f} vs {s:.2f} G",
                  file=sys.stderr)
        if bad:
            sys.exit(1)
        print("auto >= 0.9x best sibling on every case", file=sys.stderr)


if __name__ == "__main__":
    main()
