#!/usr/bin/env python
"""Example 1: gray equilibrium slab — the GrayTest invariant.

Runs the shipped single-group deck (reflective left, equilibrium source
right, started from psi = B) and checks the radiative flux stays at zero:
the reference's pass criterion max|F| < 1e-6 after 1000 BDF2 steps
(reference: tests/test_gray.cpp:89-98).

    python examples/gray_equilibrium.py [--steps N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import radiative_transfer as rt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args()

    deck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "prm", "single_group.prm")
    cfg = rt.load_config(deck, max_timesteps=args.steps)
    print(f"gray slab: M={cfg.M} G={cfg.G} N={cfg.N}, "
          f"{args.steps} BDF2 steps of dt={cfg.dt}")

    res = rt.transport.run_problem(cfg)
    F = np.asarray(res.F)
    max_elem = float(F.max())          # the reference criterion:
    max_abs = float(np.abs(F).max())   # F.maxCoeff() is the SIGNED max
    if args.steps >= 1000:
        # The deck's source 4.0931 is acT^4 to 5 digits only, which
        # injects a small NEGATIVE flux (~ -8e-6); the reference's pass
        # criterion `F.maxCoeff() < 1e-6` (tests/test_gray.cpp:89) is on
        # the signed max element and tolerates it. See tests/test_gray.py.
        print(f"max element of F = {max_elem:.3e}  (pass bar 1e-6, "
              f"reference tests/test_gray.cpp:89); max |F| = {max_abs:.3e}")
        print("equilibrium preserved" if max_elem < 1e-6 else "FAILED")
        return 0 if max_elem < 1e-6 else 1
    print(f"max element of F = {max_elem:.3e} after {args.steps} steps "
          f"(run >= 1000 steps for the 1e-6 criterion)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
