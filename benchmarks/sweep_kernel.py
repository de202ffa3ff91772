#!/usr/bin/env python
"""Fused GPU sweep kernel (ops/triton_sweep.TritonEngine) against the XLA
engine (ops/fast_sweep.FastEngine) at the two smoke shapes, end to end.

Shapes: the flagship gray slab (S_32, N=2^20, BDF2, bench.flagship_config)
and the 124-group LLNL deck at N=2^14, dt at cell Courant 0.4
(bench.llnl_config). Each engine runs the same number of steps from the
same initial state: compile (timed apart), one warm-up call, then
``--repeats`` timed calls ending in block_until_ready. Every result is
compared with FastEngine float64 after the same steps.

    python benchmarks/sweep_kernel.py [--out results.json]

Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def measure(label, eng, steps, repeats):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from statistics import median

    from timing import compile_run, time_runs

    init = eng.init_state()
    compiled, csec = compile_run(lambda s: eng.solve(s, num_steps=steps),
                                 init)
    mem = compiled.memory_analysis()
    times, out = time_runs(compiled, init, repeats)
    ends = np.asarray(jnp.asarray(eng.ends(out), jnp.float64))
    if not np.all(np.isfinite(ends)):
        raise RuntimeError(f"{label}: non-finite state")
    cfg = eng.cfg
    ups = 4 * cfg.M * cfg.G * cfg.N * steps
    rec = {
        "engine": label, "steps_per_call": steps,
        "compile_s": csec, "times_s": times,
        "median_ms_per_step": median(times) / steps * 1e3,
        "best_updates_per_s": ups / min(times),
        "median_updates_per_s": ups / median(times),
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "arg_bytes": getattr(mem, "argument_size_in_bytes", None),
    }
    jax.block_until_ready(out)
    return rec, ends


def run_shape(name, cfg, steps, repeats, variants):
    import jax.numpy as jnp
    import numpy as np

    from radiative_transfer.models import transport
    from radiative_transfer.ops.fast_sweep import FastEngine
    from radiative_transfer.ops.triton_sweep import TritonEngine

    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    ref_rec, ref = measure("fastfloat64_chunk256_unroll4",
                           FastEngine(cfg, tables, dtype=jnp.float64),
                           steps, repeats)
    ref_rec["rel_err_vs_fast_f64"] = 0.0
    recs = [ref_rec]
    print(json.dumps({"shape": name, **ref_rec}), flush=True)
    scale = np.max(np.abs(ref))
    for kind, kw in variants:
        if kind == "triton":
            eng = TritonEngine(cfg, tables, **kw)
        else:
            eng = FastEngine(cfg, tables, dtype=jnp.dtype(kind[4:]), **kw)
        label = kind + "".join(f"_{k}{v}" for k, v in kw.items())
        rec, ends = measure(label, eng, steps, repeats)
        rec["rel_err_vs_fast_f64"] = float(np.max(np.abs(ends - ref)) / scale)
        if kind == "triton":
            rec["lookback_cells"] = {str(k): v for k, v in eng.H.items()}
        recs.append(rec)
        print(json.dumps({"shape": name, **rec}), flush=True)
        del eng
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--shapes", default="gray,llnl")
    args = ap.parse_args()

    import jax

    from bench import flagship_config, llnl_config
    from radiative_transfer import backend

    backend.require_gpu("benchmarks/sweep_kernel.py")
    dev = jax.devices()[0]
    result = {"card": card(), "device_kind": dev.device_kind, "shapes": {}}
    print("card:", result["card"], flush=True)
    variants = [
        ("fastfloat32", {"chunk": 256, "unroll": 4}),
        ("fastfloat32", {"chunk": 64, "unroll": 4}),
        ("fastfloat32", {"chunk": 1024, "unroll": 8}),
        ("fastfloat64", {"chunk": 64, "unroll": 4}),
        ("fastfloat64", {"chunk": 32, "unroll": 4}),
        ("triton", {"chunk": 64}),
        ("triton", {"chunk": 32}),
        ("triton", {"chunk": 128}),
    ]
    shapes = {
        "gray_s32_n2e20": (flagship_config(N=1 << 20), 32),
        "llnl_124g_n2e14": (llnl_config(N=1 << 14), 64),
    }
    for name, (cfg, steps) in shapes.items():
        if name.split("_")[0] not in args.shapes.split(","):
            continue
        result["shapes"][name] = run_shape(name, cfg, steps, args.repeats,
                                           variants)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
