"""CLI flag-combination hygiene: every advertised flag either works or
refuses loudly in each engine/mesh mode (VERDICT r2 #7 — --balance-every
used to be a silent no-op off the general path).

Runs the CLI in-process via cli.main(argv) (cheap; the subprocess
end-to-end path is covered by test_engine_auto / test_tools)."""

import io
import os
import re
from contextlib import redirect_stdout

import conftest  # noqa: F401
from conftest import deck_edit, reference_deck

import numpy as np
import pytest

from radiative_transfer import cli

BAL_RE = re.compile(r"step\s+\d+: balance max=", re.M)


def _deck(tmp_path, steps=4, N=64):
    text = open(reference_deck("single_group.prm")).read()
    text = deck_edit(text, "max_timesteps=1000", f"max_timesteps={steps}")
    text = deck_edit(text, "N=100", f"N={N}")
    path = os.path.join(tmp_path, "deck.prm")
    open(path, "w").write(text)
    return path


MODES = [
    (["--engine", "general"], 4),
    (["--engine", "fast"], 4),
    (["--engine", "fast", "--dtype", "float32"], 4),
    (["--engine", "auto", "--dtype", "float32"], 4),
    (["--engine", "general", "--mesh", "1x2"], 4),
    (["--engine", "fast", "--mesh", "1x2"], 4),
    (["--engine", "auto", "--mesh", "1x2", "--dtype", "float64"], 4),
    (["--engine", "auto", "--mesh", "1x4", "--dtype", "float32"], 4),
]


@pytest.mark.parametrize("extra,steps", MODES,
                         ids=[" ".join(m[0]) for m in MODES])
def test_balance_every_prints_in_every_mode(tmp_path, extra, steps):
    """--balance-every must stream the balance diagnostic (not silently
    no-op) for every engine and mesh mode."""
    deck = _deck(str(tmp_path), steps=steps)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([deck, "--outdir", str(tmp_path), "--balance-every",
                       "2", *extra])
    out = buf.getvalue()
    assert rc == 0, out[-2000:]
    lines = BAL_RE.findall(out)
    assert len(lines) == steps // 2, out[-2000:]
    assert "wrote 8 CSVs" in out


def test_balance_every_with_checkpoint_refuses(tmp_path):
    deck = _deck(str(tmp_path))
    with pytest.raises(SystemExit) as ei:
        cli.main([deck, "--outdir", str(tmp_path), "--balance-every", "2",
                  "--checkpoint-dir", str(tmp_path / "ck")])
    assert ei.value.code == 2


def test_balance_every_matches_plain_run(tmp_path):
    """Chunking with the balance stream must not change the solution."""
    deck = _deck(str(tmp_path), steps=4)
    a, b = tmp_path / "a", tmp_path / "b"
    with redirect_stdout(io.StringIO()):
        assert cli.main([deck, "--outdir", str(a), "--engine", "fast",
                         "--dtype", "float32"]) == 0
        assert cli.main([deck, "--outdir", str(b), "--engine", "fast",
                         "--dtype", "float32", "--balance-every", "1"]) == 0
    for f in ("phi.csv", "F.csv", "psi.csv"):
        np.testing.assert_array_equal(np.loadtxt(a / f), np.loadtxt(b / f))


def _ensemble_table(tmp_path, K=3, G=1):
    rows = np.linspace(0.5, 2.0, K * G).reshape(K, G)
    path = os.path.join(tmp_path, "kappas.txt")
    np.savetxt(path, rows)
    return path, rows


@pytest.mark.parametrize("engine,dtype", [
    ("general", "float64"), ("auto", "float32"), ("fast", "float64"),
    ("auto", "float64")])
def test_ensemble_kappa_writes_member_sets(tmp_path, engine, dtype):
    """--ensemble-kappa runs every member in one program and writes one
    8-CSV set per member; each member matches its own single-deck run
    (the shell-script sweep a reference user would do, in one launch)."""
    deck = _deck(str(tmp_path), steps=3)
    table, rows = _ensemble_table(str(tmp_path))
    out = os.path.join(str(tmp_path), "ens")
    extra = ["--dtype", dtype]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([deck, "--outdir", out, "--engine", engine,
                       "--ensemble-kappa", table, *extra])
    text = buf.getvalue()
    assert rc == 0, text[-2000:]
    assert f"wrote {len(rows)} member output sets" in text
    for k, kap in enumerate(rows):
        sub = os.path.join(out, f"member_{k:03d}")
        assert os.path.exists(os.path.join(sub, "phi.csv")), text[-2000:]
        # member k == a plain run of the same deck with kappa_grey=k
        deck_k = _deck(str(tmp_path), steps=3)
        txt = deck_edit(open(deck_k).read(),
                        "kappa_grey=1", f"kappa_grey={float(kap[0])!r}")
        open(deck_k, "w").write(txt)
        single = os.path.join(str(tmp_path), f"single{k}")
        with redirect_stdout(io.StringIO()):
            assert cli.main([deck_k, "--outdir", single, "--engine",
                             engine, *extra]) == 0
        a = np.loadtxt(os.path.join(single, "phi.csv"))
        b = np.loadtxt(os.path.join(sub, "phi.csv"))
        tol = 1e-12 if dtype == "float64" else 5e-5
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=tol * np.max(np.abs(a)))


def test_ensemble_kappa_refusals(tmp_path):
    """Unsupported combinations refuse loudly (no silent no-ops)."""
    deck = _deck(str(tmp_path), steps=2)
    table, _ = _ensemble_table(str(tmp_path))
    base = [deck, "--outdir", str(tmp_path), "--ensemble-kappa", table]
    for bad in (["--checkpoint-dir", str(tmp_path)],
                ["--balance-every", "1"],
                ["--mesh", "1x2"],
                ["--check"],
                ["--engine", "triton"]):
        with pytest.raises(SystemExit) as e:
            cli.main(base + bad)
        assert e.value.code == 2

    # Wrong column count: clear error, nonzero exit.
    badtab = os.path.join(str(tmp_path), "bad.txt")
    np.savetxt(badtab, np.ones((2, 3)))
    rc = cli.main([deck, "--outdir", str(tmp_path),
                   "--ensemble-kappa", badtab])
    assert rc == 2


def test_steady_flag_runs_and_writes_csvs(tmp_path):
    """--steady produces the full 8-CSV output set and reports the
    sweep count; on the near-equilibrium gray deck the steady phi
    equals the long-marched phi to f64 tightness."""
    deck = _deck(str(tmp_path), steps=400)
    out_s = os.path.join(str(tmp_path), "steady")
    out_m = os.path.join(str(tmp_path), "march")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main([deck, "--steady", "--outdir", out_s]) == 0
    text = buf.getvalue()
    assert "steady solve (direct)" in text
    for f in ("phi.csv", "F.csv", "psi.csv", "x.csv"):
        assert os.path.exists(os.path.join(out_s, f))
    # long march on the same deck (BE, large dt -> the same fixed point)
    deck_m = _deck(str(tmp_path), steps=60)
    txt = deck_edit(open(deck_m).read(), "ts_method=3", "ts_method=1")
    txt = deck_edit(txt, "dt=0.00001", "dt=1.0")
    open(deck_m, "w").write(txt)
    with redirect_stdout(io.StringIO()):
        assert cli.main([deck_m, "--outdir", out_m]) == 0
    a = np.loadtxt(os.path.join(out_m, "phi.csv"))
    b = np.loadtxt(os.path.join(out_s, "phi.csv"))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.max(np.abs(a)))


def test_steady_cycle_method(tmp_path):
    deck = _deck(str(tmp_path), steps=4)
    out = os.path.join(str(tmp_path), "cyc")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main([deck, "--steady", "--steady-method", "cycle",
                         "--outdir", out]) == 0
    assert "steady solve (cycle)" in buf.getvalue()
    assert os.path.exists(os.path.join(out, "phi.csv"))


def test_steady_refusals(tmp_path):
    """--steady refuses every time-loop flag loudly (no silent no-ops)."""
    deck = _deck(str(tmp_path), steps=4)
    base = [deck, "--outdir", str(tmp_path), "--steady"]
    for bad in (["--checkpoint-dir", str(tmp_path)],
                ["--balance-every", "1"],
                ["--mesh", "1x2"],
                ["--steps", "5"],
                ["--check"],
                ["--engine", "fast"]):
        with pytest.raises(SystemExit) as e:
            cli.main(base + bad)
        assert e.value.code == 2
    # --steady-method without --steady
    with pytest.raises(SystemExit) as e:
        cli.main([deck, "--outdir", str(tmp_path),
                  "--steady-method", "cycle"])
    assert e.value.code == 2


def test_auto_f64_engine_writes_csvs_and_matches_general(tmp_path):
    """--engine auto at the default float64 (the XLA engine in native
    f64) produces the same 8 CSVs as the general path to 1e-11."""
    deck = _deck(tmp_path, steps=4, N=64)
    out_auto = os.path.join(tmp_path, "auto")
    out_gen = os.path.join(tmp_path, "gen")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main([deck, "--outdir", out_auto, "--engine", "auto"]) == 0
        assert cli.main([deck, "--outdir", out_gen,
                         "--engine", "general"]) == 0
    assert "auto engine: FastEngine (one device, float64)" in buf.getvalue()
    for name in ("phi.csv", "psi.csv", "left_ends.csv", "right_ends.csv"):
        a = np.loadtxt(os.path.join(out_auto, name), ndmin=2)
        b = np.loadtxt(os.path.join(out_gen, name), ndmin=2)
        scale = np.abs(b).max() + 1e-300
        assert np.abs(a - b).max() / scale < 1e-11, name


def test_auto_f64_engine_checkpoint_resume(tmp_path):
    """Checkpoints written under --engine auto (float64) resume
    exactly."""
    deck = _deck(tmp_path, steps=8, N=64)
    ck = os.path.join(tmp_path, "ck")
    full = os.path.join(tmp_path, "full")
    resumed = os.path.join(tmp_path, "resumed")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main([deck, "--outdir", full, "--engine", "auto"]) == 0
        # first run checkpoints every 3 steps, then dies at step 6
        assert cli.main([deck, "--outdir", os.path.join(tmp_path, "x"),
                         "--engine", "auto", "--steps", "6",
                         "--checkpoint-dir", ck,
                         "--checkpoint-every", "3"]) == 0
        # resume completes the remaining steps from the checkpoint
        assert cli.main([deck, "--outdir", resumed, "--engine", "auto",
                         "--checkpoint-dir", ck,
                         "--checkpoint-every", "3"]) == 0
    assert "resumed from step" in buf.getvalue()
    for name in ("phi.csv", "left_ends.csv"):
        a = np.loadtxt(os.path.join(resumed, name), ndmin=2)
        b = np.loadtxt(os.path.join(full, name), ndmin=2)
        scale = np.abs(b).max() + 1e-300
        assert np.abs(a - b).max() / scale < 1e-11, name


def test_triton_engine_needs_gpu(tmp_path):
    """--engine triton on a machine without a GPU fails with a clear
    error instead of interpreting or falling back."""
    deck = _deck(tmp_path, steps=2, N=64)
    with redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="GPU kernel"):
            cli.main([deck, "--outdir", str(tmp_path), "--engine", "triton",
                      "--dtype", "float32"])
