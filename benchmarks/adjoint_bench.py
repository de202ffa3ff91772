#!/usr/bin/env python
"""Gradient-step cost against the forward solve on the same shape.

Times, with benchmarks/timing.py (warm-up untimed, block_until_ready):

  fwd   — the one-device auto engine's forward solve (float32)
  grad  — value_and_grad of a loss through adjoint.make_diff_solve_fast
          (the XLA engine, float64, exact discrete adjoint)

and reports grad / fwd. Usage: python benchmarks/adjoint_bench.py [out.json]
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from timing import time_best

from radiative_transfer import backend, parallel
from radiative_transfer.adjoint import make_diff_solve_fast
from radiative_transfer.models import transport
from suite import _mk_cfg


def main():
    on_gpu = backend.platform() == "gpu"
    M, N = (32, 1 << 17) if on_gpu else (4, 1 << 10)
    steps = 96 if on_gpu else 8
    cfg = _mk_cfg(M, 1, N, steps)
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)

    eng = parallel.make_multichip_engine(cfg, tables, None)
    t_fwd, _ = time_best(lambda s: eng.solve(s, num_steps=steps),
                         eng.init_state())

    solve = make_diff_solve_fast(cfg, tables, num_steps=steps)
    grad = jax.jit(jax.grad(
        lambda p: jnp.sum(solve(p, None).ends ** 2) * 1e-3))

    def run(p):
        g = grad(p)
        return {"kappa": p["kappa"] - 0.0 * g["kappa"]}

    params = {"kappa": jnp.asarray([cfg.kappa_grey], jnp.float64)}
    t_grad, _ = time_best(run, params)
    dev = jax.devices()[0]
    rows = {"M": M, "N": N, "steps": steps,
            "platform": dev.platform, "device_kind": dev.device_kind,
            "fwd_engine": type(eng).__name__,
            "fwd_seconds": t_fwd,
            "fwd_updates_per_s": 4 * M * N * steps / t_fwd,
            "grad_seconds": t_grad, "grad_vs_fwd": t_grad / t_fwd}
    print(json.dumps(rows, indent=1))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
