"""Diagnostics tables, profiling helpers, and the Planck-mean opacity
generator."""

import os

import numpy as np

from conftest import reference_deck

from radiative_transfer import constants
from radiative_transfer.config.config import load_config
from radiative_transfer.models import transport
from radiative_transfer.ops import correction as corr_mod
from radiative_transfer.utils import diagnostics, profiling


def _setup(deck="multi_group_equilibrium.prm", **over):
    cfg = load_config(reference_deck(deck), **over)
    tables, grid, ct = transport.build_tables(cfg)
    return cfg, tables, grid, ct


class TestPlanckMeanOpacities:
    def test_emission_normalisation_exact(self):
        """sum kappa_g B_g == kappa_grey * a c T^4 by construction
        (the reference's TestPlanckian check, tests/test_planckian.cpp:336-349)."""
        cfg, tables, grid, ct = _setup()
        out = corr_mod.planck_mean_opacities(
            cfg.T, grid.e_edge, grid.e_ave, ct.B, cfg.kappa_grey
        )
        total = float(np.sum(out["kappa"] * ct.B))
        assert abs(total - cfg.kappa_grey * constants.AC * cfg.T**4) < 1e-10
        assert np.all(out["kappa"] > 0)
        assert out["emission_spectrum"].shape == (cfg.G,)

    def test_llnl_group_structure(self):
        cfg, tables, grid, ct = _setup("llnl_slab_test.prm")
        out = corr_mod.planck_mean_opacities(
            cfg.T, grid.e_edge, grid.e_ave, ct.B, cfg.kappa_grey
        )
        total = float(np.sum(out["kappa"] * ct.B))
        assert abs(total - cfg.kappa_grey * constants.AC * cfg.T**4) < 1e-8
        assert np.all(np.isfinite(out["kappa"]))
        # the 1/E^3 shape: opacity decreases toward high energy overall
        assert out["kappa"][0] > out["kappa"][-1]


class TestDiagnosticsTables:
    def test_shapes_and_render(self):
        cfg, tables, grid, ct = _setup()
        q = diagnostics.quadrature_table(tables.mu, tables.wt)
        assert len(q[1]) == cfg.M
        g = diagnostics.group_table(grid.e_ave, grid.e_edge, grid.de_ave)
        assert len(g[1]) == cfg.G
        p = diagnostics.planck_table(grid.edisc, ct.B, ct.dBdT)
        assert len(p[1]) == cfg.G
        c = diagnostics.correction_components_table(ct)
        assert len(c[1]) == cfg.G
        text = diagnostics.full_report(cfg, tables, grid, ct)
        for needle in ("quadrature", "Planck", "correction", "Mu", "cor3"):
            assert needle in text

    def test_csv_dump(self, tmp_path):
        cfg, tables, grid, ct = _setup()
        paths = diagnostics.write_tables_csv(str(tmp_path), cfg, tables, grid, ct)
        assert len(paths) == 4
        for p in paths:
            assert os.path.getsize(p) > 0
        # quadrature weights in the CSV sum to 4*pi
        rows = np.loadtxt(
            os.path.join(tmp_path, "table_quadrature.csv"),
            delimiter=",", skiprows=1,
        )
        assert abs(rows[:, 1].sum() - constants.FOUR_PI) < 1e-12


class TestProfiling:
    def test_updates_per_step(self):
        cfg, *_ = _setup()
        assert profiling.updates_per_step(cfg) == 4 * cfg.M * cfg.G * cfg.N
        assert (
            profiling.updates_per_step(cfg.replace(ts_method=1))
            == cfg.M * cfg.G * cfg.N
        )

    def test_step_metrics(self):
        m = profiling.StepMetrics(updates_per_step=100)
        m.add(10, 0.5)
        m.add(10, 0.5)
        assert m.steps == 20
        assert abs(m.ms_per_step - 50.0) < 1e-9
        assert abs(m.updates_per_s - 2000.0) < 1e-9
        assert "20 steps" in m.summary()

    def test_measure_solve(self):
        cfg, tables, grid, ct = _setup(max_timesteps=2)
        import jax

        state = transport.initial_state(cfg, tables)
        step = transport.make_step_fn(cfg, tables)
        run = jax.jit(step)
        out, secs = profiling.measure_solve(run, state, repeats=1)
        assert secs > 0
        assert out.ends.shape == state.ends.shape


def test_cli_metrics_json(tmp_path):
    """--metrics-json writes one machine-readable object mirroring the
    console diagnostics (wall time, steps, updates/s, balance, outputs)."""
    import json
    import os

    from conftest import reference_deck
    from radiative_transfer import cli

    out = str(tmp_path / "o")
    mpath = str(tmp_path / "metrics.json")
    assert cli.main([reference_deck("single_group.prm"), "--steps", "3",
                     "--outdir", out, "--metrics-json", mpath]) == 0
    with open(mpath) as f:
        m = json.load(f)
    assert m["steps_run"] == 3 and m["wall_s"] > 0
    assert m["updates_per_s"] > 0
    assert m["balance_max"] >= m["balance_mean"] >= 0
    assert os.path.exists(m["outputs"]["phi"])
    assert len(m["outputs"]) == 8
