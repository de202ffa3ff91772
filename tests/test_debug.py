"""Numeric guards (utils/debug.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import reference_deck

from radiative_transfer.config.config import load_config
from radiative_transfer.models import transport
from radiative_transfer.utils import debug as dbg


def _setup(**over):
    cfg = load_config(reference_deck("single_group.prm"), **over)
    tables, _, _ = transport.build_tables(cfg)
    state = transport.initial_state(cfg, tables)
    return cfg, tables, state


def test_checked_step_passes_on_healthy_state():
    cfg, tables, state = _setup(max_timesteps=1)
    step = transport.make_step_fn(cfg, tables)
    err, new = jax.jit(dbg.checked_step(step))(state)
    err.throw()  # no error
    assert np.all(np.isfinite(np.asarray(new.ends)))


def test_checked_step_catches_nan():
    cfg, tables, state = _setup(max_timesteps=1)
    step = transport.make_step_fn(cfg, tables)
    poisoned = state._replace(
        ends=state.ends.at[0, 0, 0, 0].set(jnp.nan)
    )
    err, _ = jax.jit(dbg.checked_step(step))(poisoned)
    with pytest.raises(Exception, match="non-finite"):
        err.throw()


def test_checked_step_positivity():
    cfg, tables, state = _setup(max_timesteps=1)
    step = transport.make_step_fn(cfg, tables)
    err, new = jax.jit(dbg.checked_step(step, positivity=True))(state)
    err.throw()  # equilibrium state stays positive
    assert np.all(np.asarray(new.ends) > 0)


def test_assert_state_finite():
    cfg, tables, state = _setup(max_timesteps=1)
    dbg.assert_state_finite(state)  # fine
    poisoned = state._replace(
        prev_ends=state.prev_ends.at[0, 0, 0, 0].set(jnp.inf)
    )
    with pytest.raises(FloatingPointError, match="prev_ends"):
        dbg.assert_state_finite(poisoned)


def test_make_ends_checker_names_the_check_and_step():
    cfg, tables, state = _setup(max_timesteps=1)
    check = dbg.make_ends_checker()
    check(state.ends, step=3)  # healthy: no raise
    poisoned = state.ends.at[0, 0, 5, 1].set(jnp.nan)
    with pytest.raises(Exception, match="finite-intensity.*step 7"):
        check(poisoned, step=7)

    pos = dbg.make_ends_checker(positivity=True)
    with pytest.raises(Exception, match="positive-intensity"):
        pos(state.ends.at[0, 0, 0, 0].set(-1.0))


def test_cli_check_aborts_on_nan_injected_mid_run(tmp_path):
    """End-to-end --check: a NaN injected mid-run (via a poisoned
    checkpoint the run resumes from) aborts the CLI with the failing
    check NAMED, before any CSVs are written."""
    from radiative_transfer import cli
    from radiative_transfer.utils import checkpoint as ckpt

    deck = reference_deck("single_group.prm")
    cfg = load_config(deck, max_timesteps=6)
    tables, _, _ = transport.build_tables(cfg)
    state = transport.initial_state(cfg, tables)
    poisoned = state._replace(ends=state.ends.at[0, 0, 2, 0].set(jnp.nan))
    ckdir = tmp_path / "ck"
    ckpt.save_checkpoint(str(ckdir), poisoned, 3, cfg)

    outdir = tmp_path / "out"
    outdir.mkdir()
    argv = [deck, "--steps", "6", "--checkpoint-dir", str(ckdir),
            "--checkpoint-every", "3", "--outdir", str(outdir), "--check"]
    with pytest.raises(Exception, match="finite-intensity"):
        cli.main(argv)
    assert not list(outdir.glob("*.csv")), "CSVs written despite failed check"
    # Without --check the same poisoned run completes (NaNs propagate
    # silently) — the flag is what makes the difference.
    assert cli.main(argv[:-1]) == 0


def test_nan_debug_context_restores():
    prev = jax.config.jax_debug_nans
    with dbg.nan_debug():
        assert jax.config.jax_debug_nans is True
    assert jax.config.jax_debug_nans == prev
