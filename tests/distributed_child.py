"""Child program for the two-process jax.distributed test.

Launched (twice) by tests/test_distributed.py with a localhost
coordinator; runs the production sharded engine on a mesh spanning both
processes and (process 0) writes the gathered final state to disk.

Run standalone:  python distributed_child.py <pid> <nprocs> <port> <outdir>
                                            [mode]

mode (argv[5], optional):
  (absent)  full run: sharded-fast solves on a spatial and a group
            mesh spanning the processes (default)
  ckpt1     first 2 of 5 steps with per-step checkpoints, then exit —
            simulates a run killed mid-way (multi-host checkpoint write:
            gather + process-0-only file + barrier)
  ckpt2     resume from the ckpt1 directory, finish the 5 steps, write
            ckpt_ends.npy — must equal the uninterrupted run bit-exactly
"""

import os
import sys

# Must run before jax import: each process is a single-CPU-device "host".
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=1"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = int(sys.argv[3])
    outdir = sys.argv[4]

    import jax as _jax

    # The env var above is not enough if jax was imported before it was
    # set (cf. tests/conftest.py).
    _jax.config.update("jax_platforms", "cpu")

    from radiative_transfer.parallel import distributed

    # initialize() must precede any backend touch (module doc).
    info = distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    assert info["process_count"] == num_processes, info
    assert info["global_devices"] == num_processes, info

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from radiative_transfer.config.config import Config
    from radiative_transfer.models import transport
    from radiative_transfer.parallel import sharded_fast

    mesh = sharded_fast.make_mesh_1d(num_processes)
    distributed.assert_mesh_spans_hosts(mesh)

    cfg = Config(
        M=4, G=2, N=64, efirst=0.1, elast=10.0, X=1.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(4.0931 for _ in range(2)) for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=1.0, use_correction=True,
        ts_method=3, dt=1e-4, max_timesteps=5,
        include_validation=False,
    )
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng = sharded_fast.ShardedFastEngine(
        cfg, tables, mesh, dtype=jnp.float64, chunk=8
    )

    mode = sys.argv[5] if len(sys.argv) > 5 else ""
    if mode in ("ckpt1", "ckpt2"):
        # Multi-host checkpoint/resume across the REAL process boundary
        # (utils/checkpoint.py: process_allgather + process-0-only write
        # + barrier). ckpt1 = the killed run; ckpt2 = the relaunch.
        from radiative_transfer.utils import checkpoint as ckpt_mod

        ckdir = os.path.join(outdir, "ck")
        if mode == "ckpt1":
            _, resumed = ckpt_mod.solve_with_checkpoints_engine(
                eng, cfg, ckdir, every=1, num_steps=2)
            assert resumed == 0, resumed
            return
        st, resumed = ckpt_mod.solve_with_checkpoints_engine(
            eng, cfg, ckdir, every=2)
        assert resumed == 2, resumed
        ends = eng.ends(st)
        local = np.asarray(
            multihost_utils.process_allgather(ends, tiled=True))
        if process_id == 0:
            np.save(os.path.join(outdir, "ckpt_ends.npy"), local)
        multihost_utils.sync_global_devices("ckpt-done")
        return

    st = eng.solve()
    ends = eng.ends(st)  # global array spanning both processes
    # tiled=True: reassemble the (already-global) sharded array so every
    # process holds the full (M, G, N, 2) result.
    local = np.asarray(multihost_utils.process_allgather(ends, tiled=True))
    assert local.shape == (cfg.M, cfg.G, cfg.N, 2), local.shape

    if process_id == 0:
        np.save(os.path.join(outdir, "ends.npy"), local)
    multihost_utils.sync_global_devices("fast-done")

    # float32 across the SAME process boundary on a wider deck: the
    # spatial ppermute / all_gather exchange at the f32 engine precision.
    cfgh = Config(
        M=2, G=1, N=1024 * num_processes, efirst=0.1, elast=10.0,
        X=10.24 * num_processes,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=((4.0931,), (4.0931,)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.0, use_correction=True,
        ts_method=3, dt=1e-5, max_timesteps=3,
        include_validation=False,
    )
    tablesh, _, _ = transport.build_tables(cfgh, dtype=jnp.float64)
    heng = sharded_fast.ShardedFastEngine(cfgh, tablesh, mesh,
                                          dtype=jnp.float32, chunk=32)
    hends = heng.ends(heng.solve())
    hlocal = np.asarray(multihost_utils.process_allgather(hends, tiled=True))
    assert hlocal.shape == (cfgh.M, cfgh.G, cfgh.N, 2), hlocal.shape
    if process_id == 0:
        np.save(os.path.join(outdir, "sharded_f32_ends.npy"), hlocal)
    multihost_utils.sync_global_devices("f32-done")

    # GROUP axis spanning the processes (mesh (g=2, x=1)): the rows are
    # split between the processes, and the reflective boundary's
    # mu<0 -> mu>0 coupling crosses the process boundary.
    mesh2d = sharded_fast.make_mesh_2d(num_processes, 1)
    distributed.assert_mesh_spans_hosts(mesh2d)
    cfgg = Config(
        M=4, G=2, N=1024, efirst=0.1, elast=10.0, X=10.24,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple((4.0931,) * 2 for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.0, use_correction=True,
        ts_method=3, dt=1e-5, max_timesteps=3,
        include_validation=False,
    )
    tablesg, _, _ = transport.build_tables(cfgg, dtype=jnp.float64)
    geng = sharded_fast.ShardedFastEngine(cfgg, tablesg, mesh2d,
                                          dtype=jnp.float64, chunk=32)
    assert geng.NG == num_processes and geng.K == 1
    gends = geng.ends(geng.solve())
    glocal = np.asarray(multihost_utils.process_allgather(gends, tiled=True))
    if process_id == 0:
        np.save(os.path.join(outdir, "sharded_g_ends.npy"), glocal)
    multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
