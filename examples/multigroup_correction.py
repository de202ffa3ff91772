#!/usr/bin/env python
"""Example 2: multigroup slab with v/c correction sources.

Runs the 4-group comoving-equilibrium deck (moving material, V = 1 cm/sh,
relativistic correction sources on) with the FAST engine, prints the
physics tables and the per-group balance, and writes the CSVs + plots.

    python examples/multigroup_correction.py [outdir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import radiative_transfer as rt
from radiative_transfer.ops.fast_sweep import FastEngine
from radiative_transfer.utils import diagnostics, io as io_mod


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "out_multigroup"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = rt.load_config(os.path.join(root, "prm", "multi_group_equilibrium.prm"),
                         max_timesteps=100)

    import jax.numpy as jnp

    tables, grid, ct = rt.transport.build_tables(cfg)
    print(diagnostics.render_table(
        diagnostics.planck_table(grid.edisc, ct.B, ct.dBdT)))

    eng = FastEngine(cfg, tables, dtype=jnp.float64)
    fst = eng.solve()
    ends = eng.ends(fst)
    psi = rt.transport.psi_from_ends(ends)
    phi = rt.transport.compute_phi(psi, tables.wt)
    bal = np.asarray(rt.transport.compute_balance(cfg, tables, ends, phi))
    print(diagnostics.render_table(diagnostics.balance_table(bal)))

    result = rt.transport.SolveResult(
        psi=psi, phi=phi,
        phi_plus=rt.transport.compute_phi_plus(psi, tables.wt),
        F=rt.transport.compute_F(psi, tables.mu, tables.wt),
        balance=bal,
        left_ends=rt.transport.compute_group_ends(cfg, tables, ends)[0],
        right_ends=rt.transport.compute_group_ends(cfg, tables, ends)[1],
        state=None,
    )
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    io_mod.write_solution_csvs(outdir, result, x, np.asarray(grid.e_ave))
    try:
        from radiative_transfer import plot as plot_mod

        plot_mod.plot_solution(plot_mod.read_solution(outdir), outdir)
        print(f"CSVs + figures in {os.path.abspath(outdir)}")
    except ImportError:
        print(f"CSVs in {os.path.abspath(outdir)} (matplotlib not available)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
