"""Config layer: the reference's own decks must load unmodified."""

import numpy as np
import pytest

from conftest import reference_deck
from radiative_transfer import load_config
from radiative_transfer.config.config import PrmFile


def test_defaults():
    cfg = load_config(reference_deck("single_group.prm"))
    # keys present in the deck
    assert cfg.M == 2 and cfg.G == 1 and cfg.N == 100
    assert cfg.X == 1.0 and cfg.dx == pytest.approx(0.01)
    assert cfg.bc_left_indicator == 2 and cfg.bc_right_indicator == 1
    assert cfg.ts_method == 3 and cfg.max_timesteps == 1000
    assert cfg.dt == pytest.approx(1e-5)
    assert cfg.use_correction is True
    # psi_source packing: counter -> (m = k//G, g = k%G)
    np.testing.assert_allclose(
        cfg.psi_source_array(), np.array([[4.0931], [4.0931]])
    )
    # key absent -> default
    assert cfg.include_validation is True


def test_default_deck_inline_comments():
    cfg = load_config(reference_deck("default.prm"))
    # values with trailing inline comments parse like std::stoi/stod
    assert cfg.M == 2 and cfg.G == 2
    assert cfg.bc_left_indicator == 2
    np.testing.assert_allclose(cfg.psi_source_array(), [[1.1, 2.1], [0.0, 0.0]])
    assert cfg.max_timesteps == 50


def test_multigroup_equilibrium_deck():
    cfg = load_config(reference_deck("multi_group_equilibrium.prm"))
    assert cfg.G == 4 and cfg.use_mg_equilib and cfg.use_correction
    assert cfg.V == 1.0
    # psi_source is NOT read when use_mg_equilib is set
    np.testing.assert_allclose(cfg.psi_source_array(), np.zeros((2, 4)))


def test_llnl_deck_tables():
    cfg = load_config(reference_deck("llnl_slab_test.prm"))
    assert cfg.G == 124 and cfg.N == 50 and cfg.X == pytest.approx(0.4)
    gb = cfg.group_bounds_array()
    gk = cfg.group_kappa_array()
    assert gb.shape == (125,) and gk.shape == (124,)
    assert gb[0] == pytest.approx(1e-3) and gb[-1] == pytest.approx(30.0)
    assert gk.max() == pytest.approx(1e6)
    assert cfg.include_validation is False
    assert cfg.bc_left_indicator == 0 and cfg.bc_right_indicator == 0


def test_bool_exact_match_quirk(tmp_path):
    # trailing characters after a bool make it false (C++ string compare)
    p = tmp_path / "t.prm"
    p.write_text("a=true\nb=true \nc=True\nd=yes\ne=1\n")
    prm = PrmFile(str(p))
    assert prm.get_bool("a", False) is True
    assert prm.get_bool("b", True) is False
    assert prm.get_bool("c", False) is True
    assert prm.get_bool("d", False) is True
    assert prm.get_bool("e", False) is False


def test_duplicate_keys_keep_first(tmp_path):
    p = tmp_path / "t.prm"
    p.write_text("M=4\nM=8\n")
    prm = PrmFile(str(p))
    assert prm.get_int("M", 0) == 4


def test_psi_source_stops_at_bad_token(tmp_path):
    p = tmp_path / "t.prm"
    p.write_text("M=2\nG=2\npsi_source=1. 2. 3. # comment 9.\n")
    cfg = load_config(str(p))
    np.testing.assert_allclose(cfg.psi_source_array(), [[1.0, 2.0], [3.0, 0.0]])
