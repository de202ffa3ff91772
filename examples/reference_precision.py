#!/usr/bin/env python
"""Example 7: reference-grade precision, and what float32 costs.

The C++ reference computes everything in `double` and accepts results
at 1e-6 absolute tolerances. This example runs the same gray transient
two ways and reports drift against the f64 ground truth plus runtime:

  * the f64 XLA fast engine (exact: ``--engine auto`` at float64)
  * the f32 engine ``auto`` picks (the fused sweep kernel on a GPU,
    the XLA engine on the CPU): ~1e-6 drift

Then it differentiates the solve: fit_params with solver='fast' recovers
a perturbed opacity through the exact f64 adjoint of the fast engine.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import radiative_transfer as rt


def main():
    import jax
    import jax.numpy as jnp

    from radiative_transfer import backend, parallel
    from radiative_transfer.models import transport
    from radiative_transfer.ops.fast_sweep import FastEngine

    deck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "prm", "single_group.prm")
    on_gpu = backend.platform() == "gpu"
    N = 1 << 14 if on_gpu else 256
    steps = 400 if on_gpu else 40
    cfg = rt.load_config(deck, M=8, N=N, X=N * 0.01, max_timesteps=steps)
    tables, _, _ = transport.build_tables(cfg)

    def timed(eng):
        st = jax.block_until_ready(eng.solve(num_steps=steps))  # compile
        t0 = time.perf_counter()
        st = jax.block_until_ready(eng.solve(num_steps=steps))
        return st, time.perf_counter() - t0

    # 1. f64 ground truth (XLA fast engine).
    fe = FastEngine(cfg, tables, dtype=jnp.float64)
    st64, t64 = timed(fe)
    ref = np.asarray(fe.ends(st64))
    scale = np.abs(ref).max()
    print(f"f64 XLA engine : {t64 * 1e3:7.1f} ms   (ground truth)")

    # 2. The f32 engine auto picks here.
    e32 = parallel.make_multichip_engine(cfg, tables, None)
    st32, t32 = timed(e32)
    drift = np.abs(np.asarray(e32.ends(st32)) - ref).max() / scale
    print(f"f32 {type(e32).__name__:11s}: {t32 * 1e3:7.1f} ms   "
          f"drift {drift:.2e}   ({t64 / t32:.1f}x the f64 engine)")

    # 3. Gradients: recover a perturbed opacity. The target comes from a
    # plain (non-differentiable) solve at the perturbed kappa.
    from radiative_transfer import adjoint

    cfg_t = cfg.replace(kappa_grey=cfg.kappa_grey * 1.3,
                        max_timesteps=8)
    tab_t, _, _ = transport.build_tables(cfg_t)
    fe_t = FastEngine(cfg_t, tab_t, dtype=jnp.float64)
    target_ends = fe_t.ends(fe_t.solve(num_steps=8))

    def loss(state, params):
        return jnp.mean((state.ends - target_ends) ** 2)

    params, hist = adjoint.fit_params(
        cfg, tables, None, loss,
        {"kappa": jnp.asarray([cfg.kappa_grey])},
        num_steps=8, learning_rate=0.05, iterations=60, solver="fast")
    kap = float(np.asarray(params["kappa"])[0])
    print(f"inverse opacity (solver='fast'): recovered kappa = "
          f"{kap:.4f} (target {cfg.kappa_grey * 1.3:.4f}), "
          f"loss {hist[0]:.3e} -> {hist[-1]:.3e}")


if __name__ == "__main__":
    main()
