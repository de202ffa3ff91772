#!/usr/bin/env python
"""Example 4: the production story on the real LLNL 124-group deck.

Loads the reference's shipped multigroup deck (tabulated group bounds +
absorption opacities spanning 8 decades), widens it to a benchmark
resolution at a stable Courant number, and runs the full production
path: shape-aware engine auto-selection, periodic exact checkpoints,
live balance diagnostics, and end-of-run conservation reporting.

Works on a GPU (auto picks the fused sweep kernel) or the CPU (the XLA
engine). Several devices: set a mesh via the CLI instead —
    python -m radiative_transfer.cli prm/llnl_slab_test.prm \
        --engine auto --mesh 1x8 --checkpoint-dir ck/
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import radiative_transfer as rt


def main():
    import jax.numpy as jnp

    from radiative_transfer import parallel
    from radiative_transfer.models import transport
    from radiative_transfer.utils import checkpoint as ckpt

    deck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "prm", "llnl_slab_test.prm")
    C = 299.79245800
    N, steps = 1 << 10, 40
    cfg0 = rt.load_config(deck)
    # Courant-0.4 dt: the shipped dt=1e-3 exceeds the BDF2 stability
    # envelope at this resolution (docs/QUIRKS.md).
    cfg = rt.load_config(deck, N=N, max_timesteps=steps,
                         dt=0.4 * (cfg0.X / N) / C)
    print(f"LLNL deck: M={cfg.M} G={cfg.G} N={cfg.N} steps={steps}")

    tables, grid, _ = transport.build_tables(cfg, dtype=jnp.float32)
    eng = parallel.make_multichip_engine(cfg, tables, None)
    print(f"auto-selected engine: {type(eng).__name__}")

    with tempfile.TemporaryDirectory() as ckdir:
        # First 20 steps with per-10-step checkpoints...
        st, resumed = ckpt.solve_with_checkpoints_engine(
            eng, cfg, ckdir, every=10, num_steps=20)
        assert resumed == 0
        # ... then "crash" and resume for the remainder (exact restart:
        # the trajectory equals an uninterrupted run bit-for-bit).
        st, resumed = ckpt.solve_with_checkpoints_engine(
            eng, cfg, ckdir, every=10)
        print(f"resumed from checkpointed step {resumed}")

    ends = jnp.asarray(eng.ends(st), jnp.float64)
    result = transport.result_from_ends(cfg, tables, ends)
    bal = np.asarray(result.balance)
    print(f"per-group balance: max={bal.max():.3e} mean={bal.mean():.3e}")

    # Spot conservation: total emission matches kappa_grey * a*c*T^4 and
    # the group Planck integrals sum to the grey integral (the
    # reference's own validation identities, src/correction.cpp:39-122).
    B = np.asarray(tables.B, dtype=np.float64)
    acT4 = rt.constants.AC * cfg.T ** 4
    print(f"|sum B_g - acT^4| = {abs(B.sum() - acT4):.2e} (tol 1e-6)")
    assert abs(B.sum() - acT4) < 1e-6
    assert np.isfinite(np.asarray(result.phi)).all()
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
