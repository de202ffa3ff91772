#!/usr/bin/env python
"""Weak scaling of the mesh path (parallel/sharded_fast.ShardedFastEngine):
updates/s against spatial shards at fixed cells per device.

For each K in 1, 2, 4, ... up to the device count, solves the workload
with N = cells_per_shard * K on a 1xK mesh and reports
efficiency(K) = rate(K) / (K * rate(1)).

``--virtual`` runs the ladder on a forced CPU host mesh. Its raw rates
measure core contention, not a device, so each virtual rung can also
time a zero-communication control (K independent one-device engines,
same per-shard work) and report comm_efficiency = control / ladder,
which cancels the host and isolates the exchange and synchronisation
cost.

Usage:
    python benchmarks/weak_scaling.py [--cells-per-shard 1048576]
        [--steps 16] [--workload gray|llnl|llnl-shipped] [--virtual]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells-per-shard", type=int, default=None)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--workload", default="gray",
                    choices=("gray", "llnl", "llnl-shipped"),
                    help="gray: S_32 single-group flagship; llnl: the "
                         "124-group LLNL deck at the Courant-0.4 dt; "
                         "llnl-shipped: the deck's own dt=1e-3")
    ap.add_argument("--virtual", action="store_true",
                    help="force a virtual CPU host mesh (overhead "
                         "trends only, not device rates)")
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual mode: host-mesh device count")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--control", choices=("all", "last", "none"),
                    default="all",
                    help="virtual mode: time the zero-communication "
                         "control at every rung (all), only the deepest "
                         "(last), or never (none)")
    args = ap.parse_args()

    if args.virtual:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count="
                + str(args.devices)
            ).strip()

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from bench import flagship_config, llnl_config
    from radiative_transfer import load_config
    from radiative_transfer.models import transport
    from radiative_transfer.parallel.sharded_fast import (
        ShardedFastEngine,
        make_mesh_1d,
    )
    from timing import time_best

    n_dev = len(jax.devices())
    if args.workload.startswith("llnl"):
        cells = args.cells_per_shard or (
            (1 << 10) if args.virtual else (1 << 16))
        M, G = 2, 124
    else:
        cells = args.cells_per_shard or (
            (1 << 10) if args.virtual else (1 << 20))
        M, G = 32, 1

    def ladder_cfg(n):
        if args.workload == "llnl-shipped":
            deck = os.path.join(os.path.dirname(HERE), "prm",
                                "llnl_slab_test.prm")
            return load_config(deck, N=n, max_timesteps=args.steps)
        if args.workload == "llnl":
            return llnl_config(N=n, steps=args.steps)
        return flagship_config(N=n, steps=args.steps)

    def control_wall(cfg_ladder, K):
        """K independent one-device meshes of the same engine on K
        distinct devices: the ladder rung's per-shard work with zero
        cross-shard exchange."""
        import dataclasses
        import time

        cfg1 = dataclasses.replace(cfg_ladder, N=cfg_ladder.N // K,
                                   X=cfg_ladder.X / K)
        tb1, _, _ = transport.build_tables(cfg1, dtype=jnp.float32)
        engs = []
        for k in range(K):
            e = ShardedFastEngine(cfg1, tb1, make_mesh_1d(
                1, devices=jax.devices()[k:k + 1]), dtype=jnp.float32)
            engs.append((e, e.solve(e.init_state(), num_steps=args.steps)))
        states = jax.block_until_ready([s for _, s in engs])
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            states = [e.solve(s, num_steps=args.steps)
                      for (e, _), s in zip(engs, states)]
            jax.block_until_ready(states)
            best = min(best, time.perf_counter() - t0)
        return best

    rows = []
    base_rate = None
    K = 1
    while K <= n_dev:
        cfg = ladder_cfg(cells * K)
        tables, _, _ = transport.build_tables(cfg, dtype=jnp.float32)
        eng = ShardedFastEngine(cfg, tables, make_mesh_1d(K),
                                dtype=jnp.float32)
        best, _ = time_best(
            lambda s: eng.solve(s, num_steps=args.steps),
            eng.init_state(), repeats=args.repeats)
        rate = 4 * M * G * cells * K * args.steps / best
        if base_rate is None:
            base_rate = rate
        dev = jax.devices()[0]
        rec = {
            "engine": "sharded-fast", "workload": args.workload,
            "shards": K, "cells_per_shard": cells, "total_cells": cells * K,
            "updates_per_s": rate, "per_shard": rate / K,
            "efficiency": rate / (K * base_rate),
            "platform": dev.platform, "device_kind": dev.device_kind,
        }
        want_control = (args.control == "all"
                        or (args.control == "last" and K * 2 > n_dev))
        if args.virtual and want_control:
            ctrl = control_wall(cfg, K)
            rec["control_wall_s"] = ctrl
            rec["ladder_wall_s"] = best
            rec["comm_efficiency"] = ctrl / best
        rows.append(rec)
        print(json.dumps(rec), flush=True)
        K *= 2

    print("\nshards  G upd/s   per-shard   efficiency  comm-eff",
          file=sys.stderr)
    for r in rows:
        ce = (f"{r['comm_efficiency']:.3f}"
              if "comm_efficiency" in r else "     -")
        print(f"{r['shards']:>6}  {r['updates_per_s'] / 1e9:8.2f}  "
              f"{r['per_shard'] / 1e9:9.2f}   {r['efficiency']:.3f}"
              f"     {ce}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
