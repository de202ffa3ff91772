"""f32 drift characterization: f32 engines vs the f64 general solve.

VERDICT round-1 item #4: the perf engines run float32 — this script
quantifies what that costs in accuracy on *transient* workloads over
their real step counts, not just a handful of steps.

Workloads (the three reference decks, at their shipped dt where the
BDF2 4-phase cycle is stable — see docs/QUIRKS.md #14):

- gray (single_group.prm):   1000 steps, cell Courant 0.30
- multigroup-equilibrium:     500 steps, cell Courant 0.30
- llnl (llnl_slab_test.prm):    2 steps (its real run), then a longer
  transient at a Courant-0.4-stable dt (its shipped dt=1e-3 is Courant
  ~7.5e4 — unstable for BDF2 in ANY precision; reference property).

For each deck, the f64 general engine (models/transport) is advanced
in chunks and at each checkpoint the f32 fast engine (ops/fast_sweep)
and the f32 GPU kernel engine (ops/triton_sweep) are compared on the
cell averaged psi: max over (direction, group, cell) of
|f32 - f64| / max|f64|.

Usage:
    python benchmarks/f32_drift.py [--quick] [--json] [--engines fast,triton]

The triton engine needs a GPU; on the CPU pass ``--engines fast``.
Results feed docs/PERFORMANCE.md section "f32 accuracy" and the bounds
asserted in tests/test_f32_drift.py.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

from radiative_transfer import load_config
from radiative_transfer.models import transport
from radiative_transfer.ops import fast_sweep, triton_sweep

C_LIGHT = 299.79245800  # cm/sh (Constants.h)


def stable_dt(cfg, courant: float = 0.4) -> float:
    return courant * (cfg.X / cfg.N) / C_LIGHT


def psi_of_state(ends) -> np.ndarray:
    return np.asarray(transport.psi_from_ends(jnp.asarray(ends)))


ENGINES = {
    "fast_f32": lambda cfg, tables: fast_sweep.FastEngine(
        cfg, tables, dtype=jnp.float32),
    "triton_f32": lambda cfg, tables: triton_sweep.TritonEngine(cfg, tables),
}


def run_deck(name: str, cfg, checkpoints, engines=ENGINES):
    """Advance the f64 reference and each engine of ``engines`` (name ->
    factory(cfg, tables)) in lockstep; report drift per checkpoint."""
    tables, _, _ = transport.build_tables(cfg)

    ref_state = transport.initial_state(cfg, tables)
    live = {}
    for key, make in engines.items():
        eng = make(cfg, tables)
        live[key] = (eng, eng.init_state())

    rows = []
    done = 0
    for n in checkpoints:
        k = n - done
        ref_state = transport.solve(cfg, tables, ref_state, k)
        want = psi_of_state(ref_state.ends)
        scale = np.max(np.abs(want))
        row = {"deck": name, "steps": n}
        for key, (eng, st) in live.items():
            st = eng.solve(st, k)
            live[key] = (eng, st)
            got = psi_of_state(eng.ends(st))
            row[key] = float(np.max(np.abs(got - want)) / scale)
        rows.append(row)
        done = n
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="short horizons (CI-scale)")
    ap.add_argument("--json", action="store_true", help="JSON lines output")
    ap.add_argument("--engines", default="fast,triton",
                    help="comma list of fast, triton")
    args = ap.parse_args()
    engines = {f"{e}_f32": ENGINES[f"{e}_f32"]
               for e in args.engines.split(",")}

    prm = Path(__file__).resolve().parent.parent / "prm"
    rows = []

    # gray transient: reflective/source BCs, the 1000-step shipped run
    cfg = load_config(str(prm / "single_group.prm"))
    cps = (50, 250) if args.quick else (100, 250, 500, 1000)
    rows += run_deck("gray", cfg, cps, engines)

    # multigroup equilibrium with v/c correction, 500-step shipped run
    cfg = load_config(str(prm / "multi_group_equilibrium.prm"))
    cps = (50, 200) if args.quick else (100, 250, 500)
    rows += run_deck("mg-equilib", cfg, cps, engines)

    # LLNL 124-group: its real 2-step run at shipped dt...
    cfg = load_config(str(prm / "llnl_slab_test.prm"))
    rows += run_deck("llnl-shipped", cfg, (2,), engines)
    # ...and a longer transient at a BDF2-stable dt (QUIRKS.md #14).
    cfg2 = load_config(str(prm / "llnl_slab_test.prm"))
    cfg2 = cfg2.replace(dt=stable_dt(cfg2))
    cps = (20, 60) if args.quick else (50, 200, 500)
    rows += run_deck("llnl-transient", cfg2, cps, engines)

    if args.json:
        for r in rows:
            print(json.dumps(r))
    else:
        keys = list(engines)
        hdr = f"{'deck':16s} {'steps':>6s}" + "".join(f" {k:>12s}"
                                                      for k in keys)
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            print(f"{r['deck']:16s} {r['steps']:6d}"
                  + "".join(f" {r[k]:12.3e}" for k in keys))


if __name__ == "__main__":
    main()
