"""GOLDEN parity: our solver vs the reference C++ binary itself.

The image ships no Eigen, so the reference miniapp is compiled against a
minimal Eigen-compatible shim written for this project
(tests/eigen_shim/ — original code implementing only the API subset the
reference uses). The build must be -O0: the reference's param-library
get<T> specializations live in param.cpp without header declarations, so
an optimizing build inlines the generic template (which returns the
default for every key!) — upstream's default CMake build is unoptimized,
which is why it works there. A lowercase `constants.h` alias is also
needed (the reference includes "constants.h" but ships "Constants.h" —
it only builds on case-insensitive filesystems).

Each deck runs through BOTH codes end-to-end and every output CSV is
compared. Tolerance 1e-5 relative-to-field-max: the reference prints 6
significant digits.

These runs also pinned down a real behavioral quirk now replicated in
every engine: the BDF2 half_ends snapshot applies the CN output only to
the mu<0 half (solver.cpp:733 sits in the mu<0 branch only; the mu>0
half keeps the phase-0 BE predictor output).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from conftest import deck_edit, reference_deck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"

SOURCES = [
    "src/main.cc", "src/solver.cpp", "src/correction.cpp", "src/Planck.cpp",
    "src/GLQuad.cpp", "src/ParameterHandler.cpp", "src/param.cpp",
]


@pytest.fixture(scope="session")
def transfer_binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    if not os.path.isdir(REF):
        pytest.skip("reference sources not mounted")
    build = tmp_path_factory.mktemp("refbuild")
    (build / "constants.h").write_text('#include "Constants.h"\n')
    (build / "var-config.h").write_text(f'#define TRANSFER_DIR "{REF}/"\n')
    out = build / "transfer"
    cmd = [
        "g++", "-O0", "-std=c++14",
        f"-I{REF}/include",
        f"-I{os.path.join(REPO, 'tests', 'eigen_shim')}",
        f"-I{build}",
        *[os.path.join(REF, s) for s in SOURCES],
        "-o", str(out),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip(f"reference build failed:\n{res.stderr[-2000:]}")
    return str(out)


def _run_reference(binary, deck_path, workdir):
    """Run the reference binary with the cwd layout it expects (aux
    tables resolve at ../prm/ relative to the run directory)."""
    rundir = os.path.join(workdir, "build")
    prmdir = os.path.join(workdir, "prm")
    os.makedirs(rundir, exist_ok=True)
    os.makedirs(prmdir, exist_ok=True)
    for name in os.listdir(os.path.join(REF, "prm")):
        if name.endswith(".txt"):
            shutil.copy(os.path.join(REF, "prm", name), prmdir)
    res = subprocess.run(
        [binary, deck_path], cwd=rundir, capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-500:]
    return rundir


def _run_ours(deck_path, outdir):
    import jax.numpy as jnp

    from radiative_transfer.config.config import load_config
    from radiative_transfer.models import transport
    from radiative_transfer.utils import io as io_mod

    cfg = load_config(deck_path)
    result = transport.run_problem(cfg, dtype=jnp.float64)
    _, grid, _ = transport.build_tables(cfg)
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    io_mod.write_solution_csvs(outdir, result, x, np.asarray(grid.e_ave))
    return outdir


FIELDS = ("phi", "phi_plus", "F", "psi", "left_ends", "right_ends", "e_ave",
          "x")


def _compare(refdir, ourdir, tol=1e-5):
    report = {}
    for name in FIELDS:
        a = np.loadtxt(os.path.join(refdir, name + ".csv"))
        b = np.loadtxt(os.path.join(ourdir, name + ".csv"))
        assert a.shape == b.shape, name
        scale = max(np.abs(a).max(), 1e-300)
        report[name] = float(np.abs(a - b).max() / scale)
    bad = {k: v for k, v in report.items() if v > tol}
    assert not bad, f"golden mismatch vs reference binary: {bad}"
    return report


def _deck_with_steps(src, steps, tmpdir):
    """Copy a deck with a reduced max_timesteps (same physics, faster).
    Aux tables are copied alongside so both loaders resolve them."""
    for name in os.listdir(os.path.join(REF, "prm")):
        if name.endswith(".txt"):
            shutil.copy(os.path.join(REF, "prm", name), tmpdir)
    text = open(src).read()
    out = os.path.join(tmpdir, os.path.basename(src))
    lines = []
    for line in text.splitlines():
        if line.startswith("max_timesteps="):
            line = f"max_timesteps={steps}"
        lines.append(line)
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return out


@pytest.mark.parametrize("deck,steps", [
    ("single_group.prm", 100),
    ("multi_group_equilibrium.prm", 100),
    ("llnl_slab_test.prm", 2),
])
def test_deck_matches_reference_binary(transfer_binary, tmp_path, deck, steps):
    deck_path = _deck_with_steps(reference_deck(deck), steps, str(tmp_path))
    refdir = _run_reference(transfer_binary, deck_path, str(tmp_path))
    ourdir = _run_ours(deck_path, str(tmp_path / "ours"))
    report = _compare(refdir, ourdir)
    # sanity: the comparison actually saw non-trivial fields
    assert np.abs(np.loadtxt(os.path.join(refdir, "phi.csv"))).max() > 0


def _echo_block(text, M):
    """The display_input_quantities block: from the banner through the
    M psi_source rows (src/ParameterHandler.cpp:20-96)."""
    lines = [ln.rstrip() for ln in text.splitlines()]
    start = lines.index("--- Input Parameters ---")
    psi = lines.index("Psi_source:", start)
    return lines[start:psi], [ln for ln in lines[psi + 1: psi + 1 + M + 2]
                              if ln.strip()][:M]


@pytest.mark.parametrize("deck,steps", [
    ("single_group.prm", 1),
    ("llnl_slab_test.prm", 1),
])
def test_input_echo_matches_reference_binary(transfer_binary, tmp_path,
                                             deck, steps):
    """Console parity: our CLI's input echo reproduces
    display_input_quantities byte-for-byte on the non-matrix lines
    (same wording, ordering, %g-6 number format, blank-line placement);
    psi_source rows compare token-wise (Eigen pads columns, the shim
    build does not)."""
    deck_path = _deck_with_steps(reference_deck(deck), steps, str(tmp_path))
    rundir = os.path.join(str(tmp_path), "build")
    os.makedirs(rundir, exist_ok=True)
    prmdir = os.path.join(str(tmp_path), "prm")
    os.makedirs(prmdir, exist_ok=True)
    for name in os.listdir(os.path.join(REF, "prm")):
        if name.endswith(".txt"):
            shutil.copy(os.path.join(REF, "prm", name), prmdir)
    res = subprocess.run([transfer_binary, deck_path], cwd=rundir,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:]

    import io
    from contextlib import redirect_stdout

    from radiative_transfer.cli import _echo_inputs
    from radiative_transfer.config.config import load_config

    cfg = load_config(deck_path)
    buf = io.StringIO()
    with redirect_stdout(buf):
        _echo_inputs(cfg)

    ref_head, ref_psi = _echo_block(res.stdout, cfg.M)
    our_head, our_psi = _echo_block(buf.getvalue(), cfg.M)
    # "Psi_source: " keeps a trailing space in the reference; rstrip'd
    # lines above make the header comparison whitespace-exact otherwise.
    assert our_head == ref_head
    assert [ln.split() for ln in our_psi] == [ln.split() for ln in ref_psi]

    # The Solver-construction quadrature + group tables
    # (solver.cpp:80-87, 107-122), byte-exact after rstrip.
    from radiative_transfer.cli import _echo_solver_tables

    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        _echo_solver_tables(cfg)

    def table_block(text):
        lines = [ln.rstrip() for ln in text.splitlines()]
        start = next(i for i, ln in enumerate(lines) if ln.startswith("Mu"))
        end = next(i for i, ln in enumerate(lines[start:], start)
                   if ln.startswith("Group Index"))
        return lines[start: end + 2 + cfg.G]

    assert table_block(buf2.getvalue()) == table_block(res.stdout)

    # Balance console lines (solver.cpp:277-282): identical labels and
    # ordering; values to golden tolerance (sources/sinks 1e-4 rel; the
    # balance ratio is |sinks-sources|/sources, a cancellation-level
    # quantity, so it gets an absolute floor).
    import jax.numpy as jnp

    from radiative_transfer.models import transport

    ref_bal = [ln for ln in res.stdout.splitlines()
               if ln.startswith(("sources:", "sinks:", "balance at"))]
    assert len(ref_bal) == 3 * cfg.G
    result = transport.run_problem(cfg, dtype=jnp.float64)
    srcs = np.asarray(result.sources)
    snks = np.asarray(result.sinks)
    bal = np.asarray(result.balance)
    ours = []
    for gi in range(cfg.G):
        ours += [f"sources: {srcs[gi]:.6g}", f"sinks: {snks[gi]:.6g}",
                 f"balance at ({gi}): {bal[gi]:.6g}"]
    for a, b in zip(ours, ref_bal):
        (la, va), (lb, vb) = a.rsplit(":", 1), b.rsplit(":", 1)
        assert la == lb
        fa, fb = float(va), float(vb)
        tol = 1e-4 * abs(fb) + (1e-6 if la.startswith("balance") else 0.0)
        assert abs(fa - fb) <= tol, f"{a!r} vs {b!r}"


def _run_ours_pallas(deck_path, outdir):
    """Same deck through the f32 Pallas-Triton GPU kernel, run in the
    Pallas interpreter here (diagnostics in f64)."""
    import jax.numpy as jnp

    from radiative_transfer.config.config import load_config
    from radiative_transfer.models import transport
    from radiative_transfer.ops.triton_sweep import TritonEngine
    from radiative_transfer.utils import io as io_mod

    cfg = load_config(deck_path)
    tables, grid, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng = TritonEngine(cfg, tables, interpret=True)
    result = transport.result_from_ends(cfg, tables, eng.ends(eng.solve()))
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    io_mod.write_solution_csvs(outdir, result, x, np.asarray(grid.e_ave))
    return outdir


def test_gray_pallas_f32_matches_reference_binary(transfer_binary, tmp_path):
    """GOLDEN parity for the f32 perf engine itself (not just via the
    engine-equivalence chain): the GPU kernel's CSVs vs the reference
    binary at the documented gray f32 drift bar (~1e-6 vs f64 at 100
    steps, docs/PERFORMANCE.md) plus the binary's 6-digit print floor."""
    deck_path = _deck_with_steps(
        reference_deck("single_group.prm"), 100, str(tmp_path))
    refdir = _run_reference(transfer_binary, deck_path, str(tmp_path))
    ourdir = _run_ours_pallas(deck_path, str(tmp_path / "ours_pallas"))
    for name in FIELDS:
        if name == "F":
            continue
        a = np.loadtxt(os.path.join(refdir, name + ".csv"))
        b = np.loadtxt(os.path.join(ourdir, name + ".csv"))
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert err < 5e-5, f"{name}: {err:.3e}"
    # F ~ 0 at equilibrium (that IS the GrayTest invariant), so a
    # relative-to-F-max metric compares two roundoff-level fields;
    # bound it against the physical flux scale phi instead.
    F = np.loadtxt(os.path.join(ourdir, "F.csv"))
    Fref = np.loadtxt(os.path.join(refdir, "F.csv"))
    phi_scale = np.abs(np.loadtxt(os.path.join(refdir, "phi.csv"))).max()
    assert np.abs(F - Fref).max() / phi_scale < 5e-5


def _run_ours_multichip(deck_path, outdir, dtype):
    """The deck through the multi-device engine on the virtual 8-device
    mesh (1-D spatial decomposition) at ``dtype``, diagnostics in f64."""
    import jax
    import jax.numpy as jnp

    from radiative_transfer.config.config import load_config
    from radiative_transfer.models import transport
    from radiative_transfer.parallel import make_multichip_engine
    from radiative_transfer.parallel.sharded_fast import make_mesh_1d
    from radiative_transfer.utils import io as io_mod

    assert len(jax.devices()) >= 8
    mesh = make_mesh_1d(8)
    cfg = load_config(deck_path)
    tables, grid, _ = transport.build_tables(cfg, dtype=jnp.float64)
    eng = make_multichip_engine(cfg, tables, mesh, dtype=jnp.dtype(dtype))
    ends = jnp.asarray(eng.ends(eng.solve()), jnp.float64)
    result = transport.result_from_ends(cfg, tables, ends)
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    io_mod.write_solution_csvs(outdir, result, x, np.asarray(grid.e_ave))
    return outdir


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gray_multichip_matches_reference_binary(transfer_binary, tmp_path,
                                                 dtype):
    """DIRECT golden parity for the multi-device engine: the virtual-8-
    mesh ShardedFastEngine at f32 and f64 straight against the reference
    binary's CSVs — no equivalence chain. The gray deck is widened to
    N=1024 at the same dx (power-of-two per-shard chunks; the binary
    runs the identical widened deck). Tolerance = the f32 engine drift
    bar of test_gray_pallas_f32_matches_reference_binary."""
    deck_path = _deck_with_steps(
        reference_deck("single_group.prm"), 100, str(tmp_path))
    text = open(deck_path).read()
    text = deck_edit(text, "N=100", "N=1024")
    text = deck_edit(text, "X=1.", "X=10.24")
    open(deck_path, "w").write(text)

    refdir = _run_reference(transfer_binary, deck_path, str(tmp_path))
    ourdir = _run_ours_multichip(deck_path, str(tmp_path / "ours"), dtype)
    for name in FIELDS:
        if name == "F":
            continue
        a = np.loadtxt(os.path.join(refdir, name + ".csv"))
        b = np.loadtxt(os.path.join(ourdir, name + ".csv"))
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert err < 5e-5, f"{name}: {err:.3e}"
    F = np.loadtxt(os.path.join(ourdir, "F.csv"))
    Fref = np.loadtxt(os.path.join(refdir, "F.csv"))
    phi_scale = np.abs(np.loadtxt(os.path.join(refdir, "phi.csv"))).max()
    assert np.abs(F - Fref).max() / phi_scale < 5e-5


def test_be_and_cn_match_reference_binary(transfer_binary, tmp_path):
    """The pure BE and CN integrators, via modified decks — through the
    general f64 engine AND directly through the f32 GPU kernel (its BE
    and CN sub-steps get their own binary-parity link, not just the
    engine-equivalence chain)."""
    base = open(reference_deck("multi_group_equilibrium.prm")).read()
    for ts in (1, 2):
        work = tmp_path / f"ts{ts}"
        work.mkdir()
        deck = os.path.join(work, "deck.prm")
        text = deck_edit(base, "ts_method=3", f"ts_method={ts}")
        text = deck_edit(text, "max_timesteps=500", "max_timesteps=50")
        open(deck, "w").write(text)
        refdir = _run_reference(transfer_binary, deck, str(work))
        ourdir = _run_ours(deck, str(work / "ours"))
        _compare(refdir, ourdir)

        pdir = _run_ours_pallas(deck, str(work / "ours_pallas"))
        phi_scale = np.abs(
            np.loadtxt(os.path.join(refdir, "phi.csv"))).max()
        for name in FIELDS:
            a = np.loadtxt(os.path.join(refdir, name + ".csv"))
            b = np.loadtxt(os.path.join(pdir, name + ".csv"))
            assert a.shape == b.shape, name
            # F ~ 0 near equilibrium: relative-to-own-max would compare
            # two cancellation-level fields — bound it against the
            # physical flux scale phi instead (as the gray pallas test).
            scale = phi_scale if name == "F" else max(np.abs(a).max(),
                                                      1e-300)
            err = np.abs(a - b).max() / scale
            # f32 drift bar for the correction-coupled multigroup deck
            # (docs/PERFORMANCE.md "f32 accuracy": ~3e-5 plateau).
            assert err < 2e-4, f"ts={ts} {name}: {err:.3e}"
