"""Command-line driver: deck in, CSVs out.

Equivalent of the reference's main() (reference: src/main.cc:60-136): read
a .prm deck (same grammar, same defaults), echo the input quantities
(ParameterHandler::display_input_quantities, src/ParameterHandler.cpp:20-96),
solve, print the per-group balance diagnostic, and write the 8 CSVs the
reference plot scripts consume.

Usage:
    python -m radiative_transfer.cli [deck.prm] [options]

Options:
    --outdir DIR     output directory for CSVs (default: CWD)
    --steps K        override max_timesteps
    --engine E       'general' (float64 scan path, default), 'fast'
                     (tiled float32/float64 XLA engine), 'triton' (fused
                     float32 GPU sweep kernel), 'auto' (the engine
                     parallel.make_multichip_engine picks)
    --dtype D        float64 (default) or float32
    --profile        print per-step wall-clock and updates/s
    --check          numeric guards per solve chunk (named checkify checks)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _echo_inputs(cfg) -> None:
    """Byte-format replica of display_input_quantities
    (src/ParameterHandler.cpp:20-96): same lines, same default-`cout`
    number formatting (%g at 6 significant digits), same BC wording and
    blank-line placement. psi_source prints Eigen-style (column-aligned
    matrix; one value per line when G==1, matching a column vector)."""
    from .constants import SPEED_OF_LIGHT

    g = lambda v: f"{v:.6g}"  # noqa: E731 - cout's default double format
    bc_name = {0: "vacuum", 2: "reflective", 1: "source"}

    out = ["", "--- Input Parameters ---"]
    out.append(f"Angle quadrature order: {cfg.M}")
    out.append(f"Number of energy groups: {cfg.G}")
    if cfg.have_group_bounds:
        out.append("Group bounds (keV) specified in file: "
                   f"{cfg.filename_group_bounds}")
    else:
        out.append("Group bounds (keV) will be computed logarithmically, "
                   f"with first group edge at {g(cfg.efirst)} and last "
                   f"group edge at {g(cfg.elast)}")
    out.append(f"Slab thickness (cm): {g(cfg.X)}")
    out.append(f"Number of cells: {cfg.N}")
    out.append(f"Material density (g/cm^3): {g(cfg.rho)}")
    if cfg.have_group_absorption_opacities:
        out.append("Group opacities (cm^2/g) specified in file: "
                   f"{cfg.filename_group_kappa}")
    else:
        out.append("Group opacities will be set to the constant grey "
                   f"opacity (cm^2/g): {g(cfg.kappa_grey)}")
    out.append(f"Material temperature (keV): {g(cfg.T)}")
    out.append(f"Material velocity (cm/shake): {g(cfg.V)}")
    out.append(f"Beta: {g(cfg.V / SPEED_OF_LIGHT)}")
    out.append("Right boundary condition: "
               + bc_name.get(cfg.bc_right_indicator,
                             "Incorrect boundary conditions provided."))
    out.append("Left boundary condition: "
               + bc_name.get(cfg.bc_left_indicator,
                             "Incorrect boundary conditions provided."))
    out.append("")
    out.append("Psi_source: ")
    src = [[g(v) for v in row] for row in cfg.psi_source] or [[]]
    w = max((len(s) for row in src for s in row), default=0)
    for row in src:
        out.append(" ".join(s.rjust(w) for s in row).rstrip())
    print("\n".join(out))


def _echo_solver_tables(cfg) -> None:
    """Byte-format replica of the quadrature and energy-group tables the
    reference prints at Solver construction (src/solver.cpp:80-87,
    107-122): setw/left iostream layout, showpos on the quadrature
    values, %g-6 number formatting, same trailing blank lines."""
    from .ops.groups import build_group_grid
    from .ops.quadrature import gauss_legendre

    g = lambda v: f"{v:.6g}"        # noqa: E731 - cout default format
    gp = lambda v: f"{v:+.6g}"      # noqa: E731 - with showpos

    mu, wt = gauss_legendre(cfg.M)
    out = ["Mu".ljust(16) + "Wt".ljust(16),
           "--".ljust(16) + "--".ljust(16)]
    for i in range(cfg.M):
        out.append(gp(mu[i]).ljust(16) + gp(wt[i]).ljust(16))
    out.append("")

    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast,
                            cfg.group_bounds_array())
    out.append("Group Index".ljust(13) + "Average Energy".ljust(16)
               + "Upper Energy".ljust(14) + "Group Width".ljust(13))
    out.append("-----------".ljust(13) + "(keV)---------".ljust(16)
               + "(keV)-------".ljust(14) + "(keV)------".ljust(13))
    for gi in range(cfg.G):
        out.append(str(gi).ljust(13) + g(grid.e_ave[gi]).ljust(16)
                   + g(grid.e_edge[gi + 1]).ljust(14)
                   + g(grid.de_ave[gi]).ljust(13))
    out.append("")
    out.append("")
    print("\n".join(ln.rstrip() for ln in out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="radiative_transfer",
        description="1-D multigroup S_N thermal radiative transfer",
    )
    default_deck = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "prm", "default.prm",
    )
    ap.add_argument("deck", nargs="?", default=default_deck,
                    help=".prm input deck (reference grammar)")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--engine",
                    choices=("general", "fast", "triton", "auto"),
                    default="general",
                    help="general: f64 scan path (default); fast: tiled "
                         "XLA engine (float32 or float64); triton: fused "
                         "float32 sweep kernel (GPU only); auto: the "
                         "triton kernel for float32 on one GPU, fast for "
                         "float64 or on the CPU, the sharded fast engine "
                         "with --mesh")
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write .npz checkpoints here and resume from the "
                         "newest one (exact restart)")
    ap.add_argument("--checkpoint-every", type=int, default=100,
                    help="full timesteps between checkpoints")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing checkpoints in --checkpoint-dir")
    ap.add_argument("--print-tables", action="store_true",
                    help="print every physics table (quadrature, groups, "
                         "Planck integrals, correction components) and "
                         "write them as CSVs to --outdir")
    ap.add_argument("--check", action="store_true",
                    help="numeric guards: verify the intensity state is "
                         "finite after every solve chunk (and at the end), "
                         "aborting with the failing check named (the "
                         "solver.cpp:609-612 assert analogue)")
    ap.add_argument("--check-positivity", action="store_true",
                    help="with --check, also enforce strictly positive "
                         "edge intensities (reference debug-build assert, "
                         "solver.cpp:402; off by default because vacuum "
                         "boundaries legitimately reach ~0)")
    ap.add_argument("--trace", default=None, metavar="LOGDIR",
                    help="write a jax.profiler device trace to LOGDIR")
    ap.add_argument("--metrics-json", default=None, metavar="FILE",
                    help="write one JSON object of run metrics (wall "
                         "time, steps, updates/s, balance, engine/mesh/"
                         "dtype) to FILE — machine-readable counterpart "
                         "of the console diagnostics")
    ap.add_argument("--balance-every", type=int, default=None, metavar="K",
                    help="run in K-step chunks, printing the per-group "
                         "balance diagnostic and step metrics after each "
                         "(every engine and mesh mode; incompatible with "
                         "--checkpoint-dir, whose chunking owns the loop)")
    ap.add_argument("--scan-tol", type=float, default=1e-10,
                    help="triton engine: accuracy bound for its "
                         "truncated upstream look-back (neglected upwind "
                         "tail a^(2^k)/(1-a) < tol; 0 = exact two-pass "
                         "scan)")
    ap.add_argument("--mesh", default=None, metavar="GxX",
                    help="multi-chip solve on a (group, spatial) device "
                         "mesh, e.g. 2x4 (requires G divisible by the "
                         "group factor for --engine general, M*G/2 "
                         "divisible for --engine fast); 1xN is a pure "
                         "spatial decomposition")
    ap.add_argument("--steady", action="store_true",
                    help="solve for the steady state DIRECTLY instead of "
                         "time-marching (steady.py): one modified sweep "
                         "(plus a short fixed-point iteration when "
                         "use_correction couples the source to psi); "
                         "writes the same CSV set")
    ap.add_argument("--steady-method", choices=("direct", "cycle"),
                    default="direct",
                    help="direct: the spatial discretization's steady "
                         "solution (exact BE/CN march limit); cycle: the "
                         "exact fixed point of the configured "
                         "integrator's full step map via matrix-free "
                         "GMRES — where a BDF2 march actually settles "
                         "(differs from direct by the reference's "
                         "predictor-corrector bias, docs/QUIRKS.md #16)")
    ap.add_argument("--ensemble-kappa", default=None, metavar="FILE",
                    help="opacity ensemble: FILE has K rows x G columns "
                         "(whitespace-separated, # comments); all K "
                         "members run in ONE stacked program "
                         "(ensemble.solve_ensemble_stacked; --engine "
                         "general uses the vmapped f64 solver) and each "
                         "member writes its 8-CSV set to "
                         "OUTDIR/member_NNN/")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from . import load_config
    from .models import transport
    from .utils import io as io_mod

    if not os.path.exists(args.deck):
        print(f"deck not found: {args.deck}", file=sys.stderr)
        return 2
    if args.balance_every and args.checkpoint_dir:
        ap.error("--balance-every and --checkpoint-dir both chunk the "
                 "solve loop; pick one")
    if args.steady_method != "direct" and not args.steady:
        ap.error("--steady-method requires --steady")
    if args.steady:
        # Loud refusal over silent no-op (driver flag-hygiene contract,
        # tests/test_cli_flags.py): a steady solve has no time loop to
        # checkpoint/chunk and no marching engine to select.
        for val, name in ((args.checkpoint_dir, "--checkpoint-dir"),
                          (args.balance_every, "--balance-every"),
                          (args.mesh, "--mesh"),
                          (args.ensemble_kappa, "--ensemble-kappa"),
                          (args.steps, "--steps"),
                          (args.check, "--check")):
            if val:
                ap.error(f"--steady does not support {name}")
        if args.engine != "general":
            ap.error("--steady has a single implementation (the tiled "
                     "f64/f32 sweep); drop --engine")
    if args.ensemble_kappa:
        # Loud refusal over silent no-op (driver flag-hygiene contract,
        # tests/test_cli_flags.py).
        for val, name in ((args.checkpoint_dir, "--checkpoint-dir"),
                          (args.balance_every, "--balance-every"),
                          (args.mesh, "--mesh"),
                          (args.check, "--check")):
            if val:
                ap.error(f"--ensemble-kappa does not support {name} "
                         "(use the library API ensemble.solve_ensemble"
                         "_stacked for meshes/custom loops)")
        if args.engine == "triton":
            ap.error("--ensemble-kappa supports --engine "
                     "general/fast/auto")

    # Multi-process wiring must precede any backend touch; doing it here
    # (not in _run_sharded) also lets every console/file write below gate
    # on process 0 — a shared --outdir must not see concurrent writers.
    if args.mesh:
        from .parallel import distributed

        distributed.initialize()
    import jax

    is_p0 = jax.process_index() == 0

    overrides = {}
    if args.steps is not None:
        overrides["max_timesteps"] = args.steps
    cfg = load_config(args.deck, **overrides)
    if is_p0:
        print(f"filename: {args.deck}")
        _echo_inputs(cfg)
        _echo_solver_tables(cfg)

    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32

    if args.print_tables and is_p0:
        from .utils import diagnostics

        tbls, grid_, ct_ = transport.build_tables(cfg, dtype=jnp.float64)
        print(diagnostics.full_report(cfg, tbls, grid_, ct_))
        for p in diagnostics.write_tables_csv(args.outdir, cfg, tbls, grid_, ct_):
            print(f"wrote {p}")

    if args.ensemble_kappa:
        return _run_ensemble(args, cfg, dtype, is_p0)

    from .utils.profiling import trace as profiler_trace

    t0 = time.perf_counter()
    with profiler_trace(args.trace):
        result, e_ave, steps_run = _run(args, cfg, dtype)
    wall = time.perf_counter() - t0

    from .utils.profiling import updates_per_step

    if args.profile:
        # steps_run excludes any checkpoint-resumed prefix.
        ups = updates_per_step(cfg) * steps_run
        print(f"wall: {wall:.3f} s for {steps_run} steps "
              f"({wall / max(steps_run, 1) * 1e3:.2f} ms/step, "
              f"{ups / wall / 1e6:.1f} M updates/s)")

    # Balance diagnostic (printed, not asserted) in the reference's
    # per-group console format (solver.cpp:277-282), plus a summary.
    bal = np.asarray(result.balance)
    if is_p0 and result.sources is not None:
        srcs = np.asarray(result.sources)
        snks = np.asarray(result.sinks)
        for gi in range(bal.shape[0]):
            print(f"sources: {srcs[gi]:.6g}")
            print(f"sinks: {snks[gi]:.6g}")
            print(f"balance at ({gi}): {bal[gi]:.6g}")
    if is_p0:
        print("balance |sinks-sources|/sources per group:")
        print("  max = %.3e   mean = %.3e" % (bal.max(), bal.mean()))

    paths = {}
    if is_p0:
        x = (np.arange(cfg.N) + 0.5) * cfg.dx
        paths = io_mod.write_solution_csvs(args.outdir, result, x, e_ave)
        print(f"wrote {len(paths)} CSVs to {os.path.abspath(args.outdir)}")

    if args.metrics_json and is_p0:
        import json

        ups = updates_per_step(cfg) * steps_run
        with open(args.metrics_json, "w") as f:
            json.dump({
                "deck": args.deck,
                "engine": args.engine,
                "mesh": args.mesh,
                "dtype": args.dtype,
                "steps_run": steps_run,
                "wall_s": wall,
                "updates_per_s": ups / wall if wall > 0 else None,
                "balance_max": float(bal.max()),
                "balance_mean": float(bal.mean()),
                "outputs": {n: os.path.abspath(p)
                            for n, p in paths.items()},
            }, f, indent=1)
            f.write("\n")
        print(f"wrote metrics to {args.metrics_json}")
    return 0


def _run_ensemble(args, cfg, dtype, is_p0) -> int:
    """--ensemble-kappa: K opacity members in ONE compiled program.

    The K-row table becomes a {'kappa': (K, G)} ensemble; the stacked
    path (ensemble.solve_ensemble_stacked) folds all members into the
    perf engines' lane batch (--engine general runs the vmapped f64
    solver instead). Each member writes the full reference 8-CSV output
    set (src/main.cc:117-133) to OUTDIR/member_NNN/ plus a one-line
    balance summary — the per-deck loop a reference user would shell-
    script, in one launch."""
    import jax.numpy as jnp

    from . import ensemble
    from .models import transport
    from .utils import io as io_mod
    from .utils.profiling import updates_per_step

    try:
        kappas = np.loadtxt(args.ensemble_kappa, ndmin=2, dtype=np.float64)
    except OSError as e:
        print(f"cannot read --ensemble-kappa table: {e}", file=sys.stderr)
        return 2
    if kappas.shape[1] != cfg.G:
        print(f"--ensemble-kappa needs G={cfg.G} columns per row, got "
              f"{kappas.shape[1]}", file=sys.stderr)
        return 2
    K = kappas.shape[0]
    params = {"kappa": kappas}

    tables, _, ct = transport.build_tables(cfg, dtype=jnp.float64)
    if cfg.include_validation:
        assert transport.validate_tables(cfg, ct), "Invalid Correction Terms"

    t0 = time.perf_counter()
    if args.engine == "general":
        final = ensemble.solve_ensemble(cfg, tables, params)
    else:
        kw = {"dtype": dtype}
        if args.engine == "auto":
            kw["scan_tol"] = args.scan_tol
        final = ensemble.solve_ensemble_stacked(
            cfg, tables, params, engine=args.engine, **kw)
    ends = np.asarray(jnp.asarray(final.ends, jnp.float64))
    wall = time.perf_counter() - t0

    if not is_p0:
        return 0
    if args.profile:
        ups = updates_per_step(cfg) * cfg.max_timesteps * K
        print(f"wall: {wall:.3f} s for {K} members x {cfg.max_timesteps} "
              f"steps ({ups / wall / 1e6:.1f} M updates/s aggregate)")
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    e_ave = np.asarray(tables.e_ave)
    for k in range(K):
        tab_k = ensemble._host_member_tables(
            cfg, tables, {"kappa": kappas[k]})
        res = transport.result_from_ends(cfg, tab_k, ends[k])
        sub = os.path.join(args.outdir, f"member_{k:03d}")
        io_mod.write_solution_csvs(sub, res, x, e_ave)
        bal = np.asarray(res.balance)
        print(f"member {k:3d}: balance max {bal.max():.3e} "
              f"mean {bal.mean():.3e} -> {sub}")
    print(f"wrote {K} member output sets under "
          f"{os.path.abspath(args.outdir)}")
    return 0


def _make_check_fn(args):
    """--check guard, or None (shared by every engine path)."""
    if not args.check:
        return None
    from .utils.debug import make_ends_checker

    return make_ends_checker(positivity=args.check_positivity)


def _run(args, cfg, dtype):
    """Dispatch to the selected engine; returns (SolveResult, e_ave,
    steps_actually_run_this_process)."""
    import jax.numpy as jnp

    from .models import transport
    from .utils import io as io_mod  # noqa: F401  (kept for parity of imports)

    if args.steady:
        from .steady import run_steady_problem

        result, sr = run_steady_problem(cfg, dtype=dtype,
                                        method=args.steady_method)
        unit = "matvecs" if args.steady_method == "cycle" else "sweeps"
        print(f"steady solve ({args.steady_method}): {sr.iterations} "
              f"{unit}, residual {sr.residual:.3e}")
        _, grid, _ = transport.build_tables(cfg, dtype=jnp.float64)
        return result, np.asarray(grid.e_ave), sr.iterations

    check_fn = _make_check_fn(args)
    if args.mesh:
        return _run_sharded(args, cfg, dtype)
    if args.engine in ("fast", "triton", "auto"):
        tables, grid, ct = transport.build_tables(cfg, dtype=jnp.float64)
        if cfg.include_validation:
            assert transport.validate_tables(cfg, ct), "Invalid Correction Terms"
        if args.engine == "auto":
            from . import parallel

            eng = parallel.make_multichip_engine(cfg, tables, None,
                                                 dtype=dtype,
                                                 scan_tol=args.scan_tol)
            print(f"auto engine: {type(eng).__name__} (one device, "
                  f"{args.dtype})")
        elif args.engine == "triton":
            from .ops.triton_sweep import TritonEngine

            if args.dtype != "float32":
                print("note: the triton engine is float32-only")
            eng = TritonEngine(cfg, tables, scan_tol=args.scan_tol)
        else:
            from .ops.fast_sweep import FastEngine

            eng = FastEngine(cfg, tables, dtype=dtype)
        if args.checkpoint_dir:
            from .utils import checkpoint as ckpt_mod

            fst, resumed = ckpt_mod.solve_with_checkpoints_engine(
                eng, cfg, args.checkpoint_dir, every=args.checkpoint_every,
                resume=not args.no_resume, check_fn=check_fn,
            )
            steps_run = cfg.max_timesteps - resumed
            if resumed:
                print(f"resumed from step {resumed}")
        elif args.balance_every:
            fst = _engine_balance_loop(eng, cfg, args, tables, check_fn)
            steps_run = cfg.max_timesteps
        else:
            fst = eng.solve()
            steps_run = cfg.max_timesteps
        ends = eng.ends(fst)
        if check_fn is not None:
            check_fn(ends, steps_run)
        result = transport.result_from_ends(cfg, tables, ends)
        e_ave = np.asarray(grid.e_ave)
    elif args.checkpoint_dir:
        from .utils import checkpoint as ckpt_mod

        tables, grid, ct = transport.build_tables(cfg, dtype=dtype)
        if cfg.include_validation:
            assert transport.validate_tables(cfg, ct), "Invalid Correction Terms"
        state = transport.initial_state(cfg, tables, dtype=dtype)
        state, resumed = ckpt_mod.solve_with_checkpoints(
            cfg, tables, state, args.checkpoint_dir,
            every=args.checkpoint_every, resume=not args.no_resume,
            check_fn=check_fn,
        )
        steps_run = cfg.max_timesteps - resumed
        if resumed:
            print(f"resumed from step {resumed}")
        result = transport.result_from_ends(cfg, tables, state.ends,
                                            state=state)
        e_ave = np.asarray(grid.e_ave)
    elif args.balance_every:
        result, e_ave = _run_with_balance(args, cfg, dtype)
        steps_run = cfg.max_timesteps
    else:
        result = transport.run_problem(cfg, dtype=dtype)
        _, grid, _ = transport.build_tables(cfg, dtype=dtype)
        e_ave = np.asarray(grid.e_ave)
        steps_run = cfg.max_timesteps
        if check_fn is not None and result.state is not None:
            check_fn(result.state.ends, steps_run)
    return result, e_ave, steps_run


def _engine_balance_loop(eng, cfg, args, tables, check_fn):
    """--balance-every for the engine paths (fast/triton on one device
    and every mesh engine): run in K-step chunks, printing the per-group
    balance summary and step metrics after each. The general engine's
    equivalent is _run_with_balance."""
    import time as time_mod

    import jax
    import jax.numpy as jnp

    from .models import transport
    from .parallel.distributed import host_array
    from .utils.profiling import StepMetrics, updates_per_step

    is_p0 = jax.process_index() == 0
    state = eng.init_state()
    metrics = StepMetrics(updates_per_step=updates_per_step(cfg))
    done, total, every = 0, cfg.max_timesteps, args.balance_every
    while done < total:
        n = min(every, total - done)
        t0 = time_mod.perf_counter()
        state = eng.solve(state, num_steps=n)
        ends = jnp.asarray(host_array(eng.ends(state)), jnp.float64)
        metrics.add(n, time_mod.perf_counter() - t0)
        done += n
        if check_fn is not None:
            check_fn(ends, done)
        psi = transport.psi_from_ends(ends)
        phi = transport.compute_phi(psi, jnp.asarray(tables.wt, jnp.float64))
        bal = np.asarray(transport.compute_balance(cfg, tables, ends, phi))
        if is_p0:
            print(f"step {done:>6d}: balance max={bal.max():.3e} "
                  f"mean={bal.mean():.3e}   [{metrics.summary()}]")
    return state


def _run_sharded(args, cfg, dtype):
    """Multi-chip solve on a (group, spatial) device mesh (--mesh GxX).
    jax.distributed is already initialized by main()."""
    import jax

    from .models import transport
    from .parallel import distributed, sharded, sharded_fast

    try:
        ng, nx = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh must look like 2x4, got {args.mesh!r}")
    n_dev = len(jax.devices())
    if ng * nx > n_dev:
        raise SystemExit(f"--mesh {args.mesh} needs {ng * nx} devices, "
                         f"have {n_dev}")

    tables, grid, ct = transport.build_tables(cfg, dtype=dtype)
    if cfg.include_validation:
        assert transport.validate_tables(cfg, ct), "Invalid Correction Terms"

    if args.engine in ("fast", "triton", "auto"):
        if args.engine == "triton":
            raise SystemExit("--engine triton runs on one device; use "
                             "--engine auto or fast with --mesh")
        from . import parallel

        mesh = sharded_fast.make_mesh_2d(ng, nx) if ng > 1 else \
            sharded_fast.make_mesh_1d(nx)
        distributed.assert_mesh_spans_hosts(mesh)
        eng = parallel.make_multichip_engine(
            cfg, tables, mesh, engine=args.engine, dtype=dtype,
            scan_tol=args.scan_tol)
        print(f"{args.engine} engine: {type(eng).__name__} (mesh "
              f"{args.mesh}, {args.dtype})")
        check_fn = _make_check_fn(args)
        resumed = 0
        if args.checkpoint_dir:
            from .utils import checkpoint as ckpt_mod

            fst, resumed = ckpt_mod.solve_with_checkpoints_engine(
                eng, cfg, args.checkpoint_dir, every=args.checkpoint_every,
                resume=not args.no_resume, check_fn=check_fn,
            )
            if resumed:
                print(f"resumed from step {resumed}")
        elif args.balance_every:
            fst = _engine_balance_loop(eng, cfg, args, tables, check_fn)
        else:
            fst = eng.solve()
        ends = eng.ends(fst)
        state = None
    else:
        mesh = sharded.make_mesh(nx, ng)
        distributed.assert_mesh_spans_hosts(mesh)
        check_fn = _make_check_fn(args)
        resumed = 0
        state = transport.initial_state(cfg, tables, dtype=dtype)
        if args.checkpoint_dir:
            from .utils import checkpoint as ckpt_mod

            state, resumed = ckpt_mod.solve_with_checkpoints(
                cfg, tables, state, args.checkpoint_dir,
                every=args.checkpoint_every, resume=not args.no_resume,
                check_fn=check_fn, solve_fn=lambda s, n:
                    sharded.solve_sharded(cfg, tables, s, mesh, num_steps=n),
            )
            if resumed:
                print(f"resumed from step {resumed}")
        elif args.balance_every:

            class _GeneralShardedEngine:
                """Adapter giving the general sharded path the engine
                protocol _engine_balance_loop expects."""

                def init_state(self):
                    return state

                def solve(self, s, num_steps=None):
                    return sharded.solve_sharded(cfg, tables, s, mesh,
                                                 num_steps=num_steps)

                def ends(self, s):
                    return s.ends

            state = _engine_balance_loop(_GeneralShardedEngine(), cfg,
                                         args, tables, check_fn)
        else:
            state = sharded.solve_sharded(cfg, tables, state, mesh)
        ends = state.ends

    import jax.numpy as jnp

    from .parallel.distributed import host_array

    ends64 = jnp.asarray(host_array(ends), jnp.float64)
    if check_fn is not None:
        check_fn(ends64, cfg.max_timesteps)
    result = transport.result_from_ends(cfg, tables, ends64, state=state)
    return result, np.asarray(grid.e_ave), cfg.max_timesteps - resumed


def _run_with_balance(args, cfg, dtype):
    """Chunked solve streaming the balance diagnostic + step metrics
    (the reference prints balance only at the end, solver.cpp:275-282;
    here it doubles as a live convergence/health monitor)."""
    import functools
    import time as time_mod

    import jax
    from jax import lax

    from .models import transport
    from .utils.profiling import StepMetrics, updates_per_step

    tables, grid, ct = transport.build_tables(cfg, dtype=dtype)
    if cfg.include_validation:
        assert transport.validate_tables(cfg, ct), "Invalid Correction Terms"
    state = transport.initial_state(cfg, tables, dtype=dtype)
    step = transport.make_step_fn(cfg, tables)

    @functools.partial(jax.jit, static_argnums=1)
    def run_chunk(s, n):
        return lax.fori_loop(0, n, lambda _, x: step(x), s)

    check_fn = _make_check_fn(args)
    metrics = StepMetrics(updates_per_step=updates_per_step(cfg))
    done, total, every = 0, cfg.max_timesteps, args.balance_every
    while done < total:
        n = min(every, total - done)
        t0 = time_mod.perf_counter()
        state = jax.block_until_ready(run_chunk(state, n))
        metrics.add(n, time_mod.perf_counter() - t0)
        done += n
        if check_fn is not None:
            check_fn(state.ends, done)
        psi = transport.psi_from_ends(state.ends)
        phi = transport.compute_phi(psi, tables.wt)
        bal = np.asarray(transport.compute_balance(cfg, tables, state.ends, phi))
        print(f"step {done:>6d}: balance max={bal.max():.3e} "
              f"mean={bal.mean():.3e}   [{metrics.summary()}]")

    result = transport.result_from_ends(cfg, tables, state.ends,
                                        state=state)
    return result, np.asarray(grid.e_ave)


if __name__ == "__main__":
    sys.exit(main())
