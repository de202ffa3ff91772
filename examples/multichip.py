#!/usr/bin/env python
"""Example 3: multi-chip solve on a device mesh.

Shards a high-resolution gray slab over all visible devices with the
production sharded fast engine and checks the result against a
single-device run. Works on real multi-chip hardware or on a virtual CPU
mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import radiative_transfer as rt


def main():
    import jax
    import jax.numpy as jnp

    from radiative_transfer.ops.fast_sweep import FastEngine
    from radiative_transfer.parallel import distributed, sharded_fast

    info = distributed.initialize()
    print("processes:", info)

    n_dev = len(jax.devices())
    cfg = rt.Config(
        M=8, G=4, N=256 * max(n_dev, 1), X=float(max(n_dev, 1)),
        bc_left_indicator=2, bc_right_indicator=1,
        # use_mg_equilib replaces psi_source with the comoving-equilibrium
        # Planckian (+ Doppler term) at setup.
        use_correction=True, V=1.0, use_mg_equilib=True,
        ts_method=3, dt=1e-5, max_timesteps=20,
        include_validation=False,
    )
    tables, _, _ = rt.transport.build_tables(cfg, dtype=jnp.float64)

    if n_dev % 2 == 0 and n_dev > 2:
        mesh = sharded_fast.make_mesh_2d(2, n_dev // 2)
    else:
        mesh = sharded_fast.make_mesh_1d(n_dev)
    distributed.assert_mesh_spans_hosts(mesh)
    print(f"mesh: {dict(mesh.shape)} over {n_dev} devices")

    seng = sharded_fast.ShardedFastEngine(cfg, tables, mesh, dtype=jnp.float64)
    sharded_ends = np.asarray(seng.ends(seng.solve()))

    eng = FastEngine(cfg, tables, dtype=jnp.float64)
    single_ends = np.asarray(eng.ends(eng.solve()))

    scale = np.abs(single_ends).max()
    err = np.abs(sharded_ends - single_ends).max() / scale
    print(f"sharded vs single-device max rel diff: {err:.2e}")
    assert err < 1e-12, "sharded result diverged"
    print("multi-chip solve matches single-device")

    # The production f32 path: parallel.make_multichip_engine picks the
    # sharded XLA engine on a mesh of several devices. The f32 bar is the
    # documented drift class for correction-coupled multigroup decks
    # (docs/PERFORMANCE.md "f32 accuracy").
    from radiative_transfer import parallel

    peng = parallel.make_multichip_engine(cfg, tables, mesh)
    pends = np.asarray(peng.ends(peng.solve()))
    perr = np.abs(pends - single_ends).max() / scale
    print(f"{type(peng).__name__} (f32) vs f64 max rel diff: {perr:.2e}")
    assert perr < 2e-3, "f32 multi-device engine diverged"
    print("f32 multi-device engine matches at f32 accuracy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
