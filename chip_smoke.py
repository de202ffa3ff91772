#!/usr/bin/env python
"""Smoke proof that the solver runs on an NVIDIA GPU, in one JAX process.

    python chip_smoke.py            # one GPU: phases (a)-(e)
    python chip_smoke.py --four     # four GPUs: phase (f) only

Phases:
  (a) print the card (jax.devices(); nvidia-smi name and power limit).
  (b) flagship gray slab: S_32, N=2^20, BDF2, float32, 64 steps on the
      one-device ``auto`` engine; compile seconds, memory analysis, rate
      and the finite/bounded guard.
  (c) the LLNL 124-group deck at N=2^14, dt at cell Courant 0.4, 20 steps
      through ``cli.main`` (in-process) at the default float64 and at
      float32, writing the 8 CSVs to a temporary directory.
  (d) parity on the card with the general float64 engine
      (models/transport.py): (c) at full width, (b) at N=2^16, and both
      decks at N=256 against the NumPy oracle (tests/oracle.py) on the
      host. Each error is printed beside its bar.
  (e) the on-card tests (pytest tests_gpu -m gpu, in this process).
  (f) ``--four``: the sharded engine on a 1x4 mesh, LLNL deck at 2^16
      cells per card, against a one-card run of the same deck.

Any failure raises, so the exit code is non-zero. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

FLAGSHIP_N, FLAGSHIP_STEPS, PARITY_N = 1 << 20, 64, 1 << 16
LLNL_N, LLNL_STEPS, PARITY_STEPS = 1 << 14, 20, 16
ORACLE_N = 256
FOUR_N_PER_CARD, FOUR_STEPS = 1 << 16, 20
# Bars: native f64 against the f64 general engine; the float32 drift
# bars of tests/test_f32_drift.py (gray 1e-5, LLNL transient 1e-4).
F64_BAR, F32_BAR = 1e-11, {"gray": 1e-5, "llnl": 1e-4}


def card_lines():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def rel_err(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.all(np.isfinite(got)):
        raise AssertionError("non-finite values")
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def check(label, err, bar, precision):
    print(f"  parity {label}: rel err {err:.3e}  bar {bar:.0e}  "
          f"({precision})", flush=True)
    if not err <= bar:
        raise AssertionError(f"{label}: {err:.3e} > {bar:.0e}")


def general_ends(cfg, steps):
    """The f64 general engine on the card, contractions at full
    precision (no TF32)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radiative_transfer.models import transport

    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    state = transport.initial_state(cfg, tables, dtype=jnp.float64)
    with jax.default_matmul_precision("highest"):
        out = transport.solve(cfg, tables, state, steps)
    return tables, np.asarray(out.ends)


def phase_a():
    import jax

    devs = jax.devices()
    for d in devs:
        print(f"(a) device {d.id}: platform={d.platform} "
              f"kind={d.device_kind}", flush=True)
    print(f"(a) jax {jax.__version__}, {len(devs)} device(s)")
    for ln in card_lines():
        print(f"(a) card: {ln}", flush=True)


def phase_b():
    import jax.numpy as jnp

    from bench import check_bounded, flagship_config
    from benchmarks.timing import compile_run, time_runs
    from radiative_transfer import parallel
    from radiative_transfer.models import transport

    cfg = flagship_config(N=FLAGSHIP_N, steps=FLAGSHIP_STEPS)
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng = parallel.make_multichip_engine(cfg, tables, None)
    init = eng.init_state()
    compiled, csec = compile_run(
        lambda s: eng.solve(s, num_steps=FLAGSHIP_STEPS), init)
    print(f"(b) engine {type(eng).__name__}, S_{cfg.M} N={cfg.N} BDF2 "
          f"float32, {FLAGSHIP_STEPS} steps; compile {csec:.2f} s",
          flush=True)
    print(f"(b) memory_analysis: {compiled.memory_analysis()}")
    times, out = time_runs(compiled, init, repeats=3)
    check_bounded(out)
    best = min(times)
    ups = 4 * cfg.M * cfg.G * cfg.N * FLAGSHIP_STEPS / best
    print(f"(b) {best / FLAGSHIP_STEPS * 1e3:.4f} ms/step, "
          f"{ups:.6g} updates/s (best of {len(times)}); state finite and "
          "bounded (max|x| < 1e3)", flush=True)


def write_deck(cfg_path_out, N=1 << 14, steps=20):
    """Write the Courant-0.4 LLNL deck (bench.llnl_config) as a .prm file
    next to copies of its opacity tables, for the CLI."""
    import shutil

    from radiative_transfer import load_config
    from radiative_transfer.constants import SPEED_OF_LIGHT

    src = os.path.join(HERE, "prm", "llnl_slab_test.prm")
    X = load_config(src).X
    out_dir = os.path.dirname(os.path.abspath(cfg_path_out))
    for t in ("llnl_slab_test_group_bounds.txt",
              "llnl_slab_test_group_kappa_a.txt"):
        shutil.copy(os.path.join(HERE, "prm", t), os.path.join(out_dir, t))
    lines = []
    with open(src) as fh:
        for ln in fh:
            key = ln.split("=", 1)[0].strip()
            if key == "N":
                ln = f"N={N}\n"
            elif key == "dt":
                ln = f"dt={0.4 * (X / N) / SPEED_OF_LIGHT!r}\n"
            elif key == "max_timesteps":
                ln = f"max_timesteps={steps}\n"
            lines.append(ln)
    with open(cfg_path_out, "w") as fh:
        fh.writelines(lines)
    return cfg_path_out


def run_cli(argv):
    """cli.main in this process; returns its console text."""
    from radiative_transfer import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}:\n"
                           f"{text[-3000:]}")
    keep = ("auto engine", "wall:", "  max =", "wrote ")
    for ln in text.splitlines():
        if ln.startswith(keep):
            print(f"(c)   {ln}", flush=True)
    return text


def phase_c_d(tmp):
    """(c) the LLNL deck through the CLI, and its (d) parity at full
    width against the general engine."""
    import numpy as np

    from radiative_transfer import load_config

    deck = write_deck(os.path.join(tmp, "llnl_c04.prm"), N=LLNL_N,
                      steps=LLNL_STEPS)
    outs = {}
    for dtype in ("float64", "float32"):
        out = os.path.join(tmp, f"llnl_{dtype}")
        print(f"(c) cli --engine auto --dtype {dtype} (N={LLNL_N}, "
              f"{LLNL_STEPS} steps)", flush=True)
        argv = [deck, "--outdir", out, "--engine", "auto", "--profile"]
        if dtype == "float32":
            argv += ["--dtype", "float32"]
        text = run_cli(argv)
        want = ("FastEngine (one device, float64)" if dtype == "float64"
                else "TritonEngine (one device, float32)")
        if f"auto engine: {want}" not in text:
            raise AssertionError(f"auto picked another engine:\n{text}")
        csvs = sorted(f for f in os.listdir(out) if f.endswith(".csv"))
        if len(csvs) != 8:
            raise AssertionError(f"expected 8 CSVs, got {csvs}")
        outs[dtype] = out

    cfg = load_config(deck)
    tables, ends = general_ends(cfg, LLNL_STEPS)
    from radiative_transfer.models import transport

    ref = transport.result_from_ends(cfg, tables, ends)
    for dtype, out in outs.items():
        for name, field in (("phi", ref.phi), ("psi", ref.psi)):
            got = np.loadtxt(os.path.join(out, f"{name}.csv"), ndmin=2)
            want = np.asarray(field)
            if name == "psi":   # M rows, columns n*G + g (utils/io.py)
                want = want.transpose(0, 2, 1).reshape(cfg.M, -1)
            err = rel_err(got.reshape(want.shape), want)
            bar = F64_BAR if dtype == "float64" else F32_BAR["llnl"]
            check(f"(d) llnl N={cfg.N} cli {dtype} {name}.csv vs general "
                  "f64", err, bar, dtype)


def phase_d_engines():
    """(d) the flagship deck at N=2^16 and both decks at N=256 (oracle)."""
    import jax.numpy as jnp

    from bench import flagship_config, llnl_config
    from radiative_transfer.ops.fast_sweep import FastEngine
    from radiative_transfer.ops.triton_sweep import TritonEngine

    def engines(cfg, tables):
        return (("FastEngine f64", FastEngine(cfg, tables,
                                              dtype=jnp.float64), "float64"),
                ("FastEngine f32", FastEngine(cfg, tables,
                                              dtype=jnp.float32), "float32"),
                ("TritonEngine f32", TritonEngine(cfg, tables), "float32"))

    cfg = flagship_config(N=PARITY_N, steps=PARITY_STEPS)
    tables, ref = general_ends(cfg, PARITY_STEPS)
    for label, eng, prec in engines(cfg, tables):
        err = rel_err(eng.ends(eng.solve(num_steps=PARITY_STEPS)), ref)
        bar = F64_BAR if prec == "float64" else F32_BAR["gray"]
        check(f"(d) gray S_32 N={cfg.N} {label} vs general f64", err, bar,
              prec)

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from oracle import Oracle

    for deck, cfg, steps in (
            ("gray", flagship_config(N=ORACLE_N, steps=4), 4),
            ("llnl", llnl_config(N=ORACLE_N, steps=2), 2)):
        tables, gen = general_ends(cfg, steps)
        orc = Oracle(
            M=cfg.M, G=cfg.G, N=cfg.N, dx=cfg.dx, dt=cfg.dt,
            mu=tables.mu, wt=tables.wt, rho=tables.rho, kappa=tables.kappa,
            B=tables.B, psi_source=tables.psi_source,
            bc_left=cfg.bc_left_indicator, bc_right=cfg.bc_right_indicator,
            use_correction=cfg.use_correction, cor1=tables.cor1,
            cor2=tables.cor2, cor3=tables.cor3, beta=cfg.beta)
        orc.run(cfg.ts_method, steps)
        check(f"(d) {deck} N={cfg.N} general f64 vs oracle",
              rel_err(gen, orc.ends), F64_BAR, "float64")
        for label, eng, prec in engines(cfg, tables):
            err = rel_err(eng.ends(eng.solve(num_steps=steps)), orc.ends)
            bar = F64_BAR if prec == "float64" else F32_BAR[deck]
            check(f"(d) {deck} N={cfg.N} {label} vs oracle", err, bar, prec)


class _Count:
    """pytest plugin: count outcomes of the test phase."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def phase_e():
    import pytest

    counts = _Count()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(HERE, "tests_gpu")], plugins=[counts])
    print(f"(e) tests_gpu: {counts.passed} passed, {counts.failed} failed, "
          f"{counts.skipped} skipped (pytest rc {rc})", flush=True)
    if rc != 0 or counts.failed or counts.skipped or not counts.passed:
        raise AssertionError("on-card tests did not all pass")


def phase_f():
    """Four cards: the sharded engine on a 1x4 mesh vs one card."""
    import jax
    import jax.numpy as jnp

    from bench import llnl_config
    from benchmarks.timing import time_runs
    from radiative_transfer import parallel
    from radiative_transfer.models import transport
    from radiative_transfer.ops.fast_sweep import FastEngine
    from radiative_transfer.parallel import distributed, sharded_fast

    info = distributed.initialize()
    print(f"(f) distributed.initialize() with no coordinator: {info}")
    if info["process_count"] != 1:
        raise AssertionError("one host must run as a single process")
    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 GPUs, found "
                             f"{len(jax.devices())}")
    cfg = llnl_config(N=4 * FOUR_N_PER_CARD, steps=FOUR_STEPS)
    tables, _, _ = transport.build_tables(cfg, dtype=jnp.float64)
    mesh = sharded_fast.make_mesh_1d(4)
    upd = 4 * cfg.M * cfg.G * cfg.N * FOUR_STEPS

    def timed(eng):
        return time_runs(lambda s: eng.solve(s, num_steps=FOUR_STEPS),
                         eng.init_state(), repeats=2)

    one64 = FastEngine(cfg, tables, dtype=jnp.float64)
    t1_64, ref = timed(one64)
    ref = one64.ends(ref)
    for name, dtype, bar in (("float64", jnp.float64, F64_BAR),
                             ("float32", jnp.float32, F32_BAR["llnl"])):
        t1 = t1_64 if name == "float64" else timed(
            FastEngine(cfg, tables, dtype=dtype))[0]
        eng = parallel.make_multichip_engine(cfg, tables, mesh, dtype=dtype)
        if not isinstance(eng, sharded_fast.ShardedFastEngine):
            raise AssertionError(f"auto on 1x4 picked {type(eng).__name__}")
        t4, out = timed(eng)
        devs = out.e0.sharding.device_set
        print(f"(f) {name}: state sharded over {len(devs)} devices "
              f"({sorted(d.id for d in devs)}); one card FastEngine "
              f"{upd / min(t1):.6g} updates/s, 1x4 mesh "
              f"{upd / min(t4):.6g} updates/s ({min(t1) / min(t4):.3f}x)",
              flush=True)
        if len(devs) != 4:
            raise AssertionError("shards did not land on four devices")
        # Both runs were chained 3 times from the initial state.
        check(f"(f) llnl N={cfg.N} 1x4 ShardedFastEngine {name} vs one-card "
              "FastEngine f64", rel_err(eng.ends(out), ref), bar, name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase (f)")
    args = ap.parse_args()

    import jax

    from radiative_transfer import backend

    if backend.platform() != "gpu":
        raise SystemExit("chip_smoke.py needs a GPU; JAX found "
                         f"{jax.devices()[0].platform!r}")
    t0 = time.perf_counter()
    phase_a()
    if args.four:
        phase_f()
    else:
        phase_b()
        with tempfile.TemporaryDirectory() as tmp:
            phase_c_d(tmp)
        phase_d_engines()
        phase_e()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    for ln in card_lines():
        print(ln)
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))


if __name__ == "__main__":
    main()
