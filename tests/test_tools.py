"""Standalone input decks, the LLNL data module, and the plot CLI."""

import dataclasses
import os

import numpy as np
import pytest

from conftest import reference_deck

from radiative_transfer.config.config import load_config
from radiative_transfer.data import llnl_opacity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OWN_PRM = os.path.join(REPO, "prm")

DECKS = [
    "default.prm",
    "single_group.prm",
    "multi_group_equilibrium.prm",
    "llnl_slab_test.prm",
]


@pytest.mark.parametrize("name", DECKS)
def test_own_decks_match_reference(name):
    """Our shipped decks define the same problems as the reference's."""
    ours = load_config(os.path.join(OWN_PRM, name))
    theirs = load_config(reference_deck(name))
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_template_deck_is_all_defaults():
    from radiative_transfer.config.config import Config

    cfg = load_config(os.path.join(OWN_PRM, "template.prm"))
    default = Config()
    for f in dataclasses.fields(cfg):
        if f.name == "psi_source":
            continue  # loader materialises the zeros (M, G) matrix
        assert getattr(cfg, f.name) == getattr(default, f.name), f.name
    assert not np.any(cfg.psi_source_array())


def test_llnl_data_module_matches_reference_tables():
    b = np.loadtxt(reference_deck("llnl_slab_test_group_bounds.txt"))
    k = np.loadtxt(reference_deck("llnl_slab_test_group_kappa_a.txt"))
    assert np.array_equal(llnl_opacity.GROUP_BOUNDS, b)
    assert np.array_equal(llnl_opacity.GROUP_KAPPA_A, k)
    assert llnl_opacity.NUM_GROUPS == 124


def test_llnl_table_writer_roundtrip(tmp_path):
    bp, kp = llnl_opacity.write_tables(str(tmp_path))
    assert np.array_equal(np.loadtxt(bp), llnl_opacity.GROUP_BOUNDS)
    assert np.array_equal(np.loadtxt(kp), llnl_opacity.GROUP_KAPPA_A)


def test_plot_cli_roundtrip(tmp_path):
    """CSV write -> read_solution -> figures, on a tiny solved problem."""
    import jax.numpy as jnp

    from radiative_transfer import plot as plot_mod
    from radiative_transfer.models import transport
    from radiative_transfer.utils import io as io_mod

    cfg = load_config(os.path.join(OWN_PRM, "default.prm"), max_timesteps=3)
    result = transport.run_problem(cfg, dtype=jnp.float64)
    _, grid, _ = transport.build_tables(cfg)
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    io_mod.write_solution_csvs(str(tmp_path), result, x, grid.e_ave)

    sol = plot_mod.read_solution(str(tmp_path))
    assert sol["psi"].shape == (cfg.M, cfg.G, cfg.N)
    np.testing.assert_allclose(sol["psi"], np.asarray(result.psi), rtol=1e-12)
    np.testing.assert_allclose(sol["phi"], np.asarray(result.phi), rtol=1e-12)

    made = plot_mod.plot_solution(sol, str(tmp_path / "figs"))
    assert len(made) == 5
    for p in made:
        assert os.path.getsize(p) > 0


def test_reference_plot_scripts_consume_our_csvs(tmp_path):
    """The reference's own scripts/plot_results.py must run unmodified on
    our CSV output (it hardcodes ../build/ relative paths, so recreate
    that layout and execute it as-is from a scripts/ dir)."""
    import shutil
    import subprocess

    import jax.numpy as jnp

    from radiative_transfer.models import transport
    from radiative_transfer.utils import io as io_mod

    script_src = "/root/reference/scripts/plot_results.py"
    if not os.path.exists(script_src):
        pytest.skip("reference scripts not mounted")

    cfg = load_config(os.path.join(OWN_PRM, "default.prm"), max_timesteps=3)
    result = transport.run_problem(cfg, dtype=jnp.float64)
    _, grid, _ = transport.build_tables(cfg)
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    build = tmp_path / "build"
    scripts = tmp_path / "scripts"
    scripts.mkdir()
    io_mod.write_solution_csvs(str(build), result, x, grid.e_ave)
    shutil.copy(script_src, scripts)

    env = dict(os.environ, MPLBACKEND="Agg")
    res = subprocess.run(
        ["python", "plot_results.py"], cwd=str(scripts), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    for png in ("F.png", "phi.png", "phi_plus.png", "psi.png", "ends.png"):
        assert (scripts / png).exists(), png


def test_bench_frozen_baseline_reproducible():
    """VERDICT r4 #7: vs_baseline's denominator is the FROZEN committed
    median (benchmarks/results/reference_baseline_frozen.json), so two
    invocations agree exactly (the live re-measure was +-25% noisy and
    polluted the longitudinal number)."""
    import importlib.util
    import json
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(repo, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    a = bench.reference_updates_per_s()
    b = bench.reference_updates_per_s()
    assert a == b
    frozen = json.load(open(os.path.join(
        repo, "benchmarks", "results", "reference_baseline_frozen.json")))
    assert a == frozen["updates_per_s"]
    assert frozen["spread_pct"] < 25
