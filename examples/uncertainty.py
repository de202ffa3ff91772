#!/usr/bin/env python
"""Example 6: uncertainty propagation via ensemble solves.

The serial C++ reference runs one deck per process; propagating opacity
uncertainty through it means shell-scripting N independent runs. Here
the whole Monte-Carlo ensemble is ONE compiled XLA program
(`radiative_transfer/ensemble.py`): `jax.vmap` stacks the member
solves along a batch axis that fuses into the solver's existing (M, G)
batch, and on a multi-device mesh the axis shards with zero
collectives (each member solves wholly on one device).

Scenario: the group opacities carry log-normal uncertainty (e.g. from
an opacity-table fit). Draw K samples, propagate each through the full
implicit transport solve, and report the induced spread of the exit
flux. Then cross-check the Monte-Carlo spread against the linearised
(first-order adjoint) estimate sigma_lin = |J sigma_kappa|, where J is
the exact gradient of the observable from `adjoint.py` — agreement at
small input noise validates both paths against each other.

    python examples/uncertainty.py [--samples 32] [--sigma 0.1]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import radiative_transfer as rt
from radiative_transfer import adjoint, ensemble
from radiative_transfer.models import transport


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8, help="timesteps per solve")
    ap.add_argument("--sigma", type=float, default=0.1,
                    help="relative (log-normal) opacity uncertainty")
    args = ap.parse_args()

    G = args.groups
    cfg = rt.Config(
        M=4, G=G, N=64, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(
            tuple(0.02 + 0.005 * g for g in range(G)) for _ in range(4)
        ),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.001,
        use_correction=True, ts_method=3, dt=5e-5,
        max_timesteps=args.steps, include_validation=False,
    )
    tables, _, _ = transport.build_tables(cfg)
    state0 = transport.initial_state(cfg, tables)
    wt = np.asarray(tables.wt)
    k_nom = np.asarray(tables.kappa)

    # --- Monte-Carlo ensemble: K log-normal opacity samples, one program.
    rng = np.random.default_rng(11)
    K = args.samples
    kappas = k_nom * np.exp(args.sigma * rng.standard_normal((K, G)))
    final = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=args.steps, state=state0)
    phi = np.asarray(ensemble.observe_phi(cfg, tables, final))  # (K, G, N)

    # Observable: group-summed exit flux at the right face.
    q = phi[:, :, -1].sum(axis=1)                               # (K,)
    q_mean, q_std = float(q.mean()), float(q.std(ddof=1))

    # --- Linearised cross-check: sigma_lin^2 = sum_g (dq/dk_g * sd_g)^2.
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=args.steps)

    def observable(kappa):
        f = solve_fn({"kappa": kappa}, state0)
        p = transport.compute_phi(transport.psi_from_ends(f.ends), wt)
        return jnp.sum(p[:, -1])

    grad = np.asarray(jax.grad(observable)(jnp.asarray(k_nom)))
    q_nom = float(observable(jnp.asarray(k_nom)))
    sd_k = k_nom * np.sqrt(np.exp(args.sigma**2) - 1.0)  # log-normal sd
    q_std_lin = float(np.sqrt(np.sum((grad * sd_k) ** 2)))

    print(f"ensemble: K={K} members, {args.steps} BDF2 steps each, "
          f"one compiled program")
    print(f"exit flux  nominal      : {q_nom:.6e}")
    print(f"exit flux  MC mean      : {q_mean:.6e}")
    print(f"exit flux  MC std       : {q_std:.3e}")
    print(f"exit flux  linearised sd: {q_std_lin:.3e}  (adjoint x input sd)")
    ratio = q_std / q_std_lin
    print(f"MC / linearised ratio   : {ratio:.3f}")
    # With ~10% input noise the delta method should agree to the MC
    # sampling error (~1/sqrt(2K) relative on the std itself).
    tol = 4.0 / np.sqrt(2 * K) + 0.15
    if abs(ratio - 1.0) < tol:
        print("PASS: Monte-Carlo spread matches the adjoint linearisation")
    else:
        print("NOTE: disagreement beyond tolerance — raise --samples "
              "or lower --sigma")


if __name__ == "__main__":
    main()
