"""Physics kernels: quadrature, group grid, Planck integrals, correction.

The assertions mirror the reference's own validation identities
(spec: tests/test_planckian.cpp conservation checks; src/correction.cpp
validate_* with tolerance 1e-6).
"""

import numpy as np
import pytest

from conftest import reference_deck
from radiative_transfer import constants, load_config
from radiative_transfer.ops import correction as corr_mod
from radiative_transfer.ops import planck
from radiative_transfer.ops.groups import build_group_grid, generate_group_edges
from radiative_transfer.ops.quadrature import gauss_legendre
from radiative_transfer.models import transport

TOL = constants.VALIDATION_TOLERANCE


class TestQuadrature:
    def test_s2(self):
        mu, wt = gauss_legendre(2)
        np.testing.assert_allclose(mu, [-1 / np.sqrt(3), 1 / np.sqrt(3)], rtol=1e-12)
        np.testing.assert_allclose(wt, [2 * constants.PI] * 2, rtol=1e-12)

    @pytest.mark.parametrize("n", [2, 4, 8, 32])
    def test_norm_and_symmetry(self, n):
        mu, wt = gauss_legendre(n)
        assert np.sum(wt) == pytest.approx(constants.FOUR_PI, rel=1e-13)
        np.testing.assert_allclose(mu, -mu[::-1], atol=1e-14)
        np.testing.assert_allclose(wt, wt[::-1], rtol=1e-13)
        assert np.all(mu[: n // 2] < 0) and np.all(mu[n // 2 :] > 0)
        # quadrature integrates mu^2 exactly: sum w mu^2 = 4pi/3
        assert np.sum(wt * mu * mu) == pytest.approx(constants.FOUR_PI / 3, rel=1e-12)


class TestGroups:
    def test_grey_grid(self):
        e = generate_group_edges(1, 0.1, 10.0)
        np.testing.assert_allclose(e, [0.0, 0.1])

    def test_log_grid(self):
        e = generate_group_edges(4, 0.1, 10.0)
        assert e[0] == 0.0 and e[1] == pytest.approx(0.1)
        # e[g+1]/e[g] = (elast/efirst)^(1/(G-1)) for g >= 1
        fac = (10.0 / 0.1) ** (1.0 / 3.0)
        np.testing.assert_allclose(e[2:] / e[1:-1], fac, rtol=1e-13)
        assert e[-1] == pytest.approx(10.0)

    def test_grid_from_file(self):
        cfg = load_config(reference_deck("llnl_slab_test.prm"))
        grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast, cfg.group_bounds_array())
        assert grid.e_edge.shape == (125,)
        np.testing.assert_allclose(
            grid.e_ave, 0.5 * (grid.e_edge[:-1] + grid.e_edge[1:])
        )
        assert np.all(grid.de_ave > 0)


class TestPlanck:
    """Conservation identities: sum_g B_g = a_long c T^4 (keV units) and
    sum_g dBdT_g = 4 a_long c T^3, for grids exercising all 3 regimes."""

    @pytest.mark.parametrize("T", [0.5, 1.0, 2.0])
    @pytest.mark.parametrize("G,efirst,elast", [(1, 0.1, 10.0), (4, 0.1, 10.0), (10, 0.01, 30.0)])
    def test_conservation(self, T, G, efirst, elast):
        grid = build_group_grid(G, efirst, elast)
        B, dBdT = planck.planck_group_integrals(T, grid.edisc)
        assert np.sum(B) == pytest.approx(planck.integrate_B_grey(T), rel=1e-12)
        assert np.sum(dBdT) == pytest.approx(planck.integrate_dBdT_grey(T), rel=1e-12)
        assert np.all(B >= 0)

    def test_llnl_bounds_conservation(self):
        cfg = load_config(reference_deck("llnl_slab_test.prm"))
        grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast, cfg.group_bounds_array())
        B, dBdT = planck.planck_group_integrals(1.0, grid.edisc)
        assert np.sum(B) == pytest.approx(planck.integrate_B_grey(1.0), rel=1e-10)
        assert np.all(B >= 0)

    def test_regimes_agree_at_boundaries(self):
        # the quadrature regime (z2<=0.7) and the series regime (z1>=0.5)
        # overlap for z in [0.5, 0.7]: both must give the same integral
        T = 1.0
        lo, hi = 0.55, 0.65  # z1=0.55>=0.5 series; also z2=0.65<=0.7 quad
        by_series = 2.0 * T**4 * planck._series_B(lo, hi, planck._EPS) / (
            planck._H**3 * planck._C**2
        ) * 4.0 * constants.PI
        by_quad = planck.integrate_B(T, lo * T, hi * T)
        assert by_quad == pytest.approx(by_series, rel=1e-10)

    def test_jk_scale_matches_gray_source(self):
        # kcon * a_long * c * T^4 == a*c*T^4 == 4.0931... — the equilibrium
        # intensity the single_group deck injects at its source boundary
        B_jk = constants.BOLTZMANN_CONSTANT_JPK * planck.integrate_B_grey(1.0)
        assert B_jk == pytest.approx(constants.AC, rel=5e-6)
        assert B_jk == pytest.approx(4.0931, abs=5e-4)


class TestCorrection:
    def _tables(self, deck="multi_group_equilibrium.prm"):
        cfg = load_config(reference_deck(deck))
        grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast, cfg.group_bounds_array())
        kappa = cfg.group_kappa_array()
        if kappa is None:
            kappa = np.full(cfg.G, cfg.kappa_grey)
        rho = np.full(cfg.G, cfg.rho)
        ct = corr_mod.build_correction_tables(
            cfg.T, rho, kappa, grid.e_edge, grid.e_ave, grid.de_ave, grid.edisc
        )
        return cfg, grid, kappa, ct

    def test_planck_validation(self):
        cfg, _, kappa, ct = self._tables()
        assert corr_mod.validate_planck_integrals(ct.B, ct.dBdT, cfg.T)
        assert corr_mod.validate_emission(kappa, ct.B, cfg.T, cfg.kappa_grey)

    def test_dEB_zero_sum(self):
        # telescoping differences must sum to ~0 for G > 1
        _, _, _, ct = self._tables()
        assert abs(np.sum(ct.dEB)) < 1e-12 * np.sum(np.abs(ct.dEB))
        assert abs(np.sum(ct.dkapEB)) < 1e-12 * np.sum(np.abs(ct.dkapEB))

    def test_edge_opacities_constant_kappa(self):
        _, _, kappa, ct = self._tables()
        # constant kappa interpolates to itself on every edge
        np.testing.assert_allclose(ct.kappa_edge, kappa[0], rtol=1e-13)

    def test_grey_special_case(self):
        cfg, grid, kappa, ct = self._tables("single_group.prm")
        e1 = grid.e_edge[1]
        pf1 = corr_mod.pf(e1, cfg.T)
        assert ct.dEB[0] == pytest.approx(e1 * pf1, rel=1e-13)
        # grey dsigEdE takes the (unguarded) last-group overwrite with the
        # UPPER edge — replicating the reference
        assert ct.dsigEdE[0] == pytest.approx(
            -ct.kappa_edge[1] * e1 / grid.de_ave[0], rel=1e-13
        )
        assert ct.dkapEB[0] == pytest.approx(ct.kappa_edge[1] * e1 * pf1, rel=1e-13)

    def test_equilibrium_sources(self):
        cfg, _, _, ct = self._tables()
        mu, _ = gauss_legendre(cfg.M)
        src = corr_mod.equilibrium_psi_source(ct.B, ct.dEB, mu, cfg.V)
        assert src.shape == (cfg.M, cfg.G)
        expect = ct.B[1] + (4 * ct.B[1] - ct.dEB[1]) * mu[0] * cfg.V / constants.SPEED_OF_LIGHT
        assert src[0, 1] == pytest.approx(expect, rel=1e-13)


class TestDkapEBZeroSum:
    """TestPlanckian's dkapEB zero-sum identity (tests/test_planckian.cpp:
    482-505): the energy differences of kappa*E*B telescope to exactly
    zero across groups (the last group's G-1 edge index makes the sum
    telescope with the first group's +edge-1 term)."""

    def test_uniform_kappa(self):
        cfg = load_config(reference_deck("multi_group_equilibrium.prm"))
        _, _, ct = transport.build_tables(cfg)
        s = float(np.sum(ct.dkapEB))
        sabs = float(np.sum(np.abs(ct.dkapEB)))
        assert abs(s) / max(sabs, 1e-300) < 1e-12

    def test_llnl_tabulated_kappa(self):
        cfg = load_config(reference_deck("llnl_slab_test.prm"))
        _, _, ct = transport.build_tables(cfg)
        s = float(np.sum(ct.dkapEB))
        sabs = float(np.sum(np.abs(ct.dkapEB)))
        assert abs(s) / max(sabs, 1e-300) < 1e-10
