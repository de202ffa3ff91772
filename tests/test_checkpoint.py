"""Checkpoint/resume: exact restart mid-run, fingerprint guard, CLI."""

import os

import numpy as np
import pytest

from conftest import deck_edit, reference_deck

from radiative_transfer.config.config import load_config
from radiative_transfer.models import transport
from radiative_transfer.utils import checkpoint as ck


def _setup(deck="single_group.prm", **over):
    cfg = load_config(reference_deck(deck), **over)
    tables, _, _ = transport.build_tables(cfg)
    state = transport.initial_state(cfg, tables)
    return cfg, tables, state


def test_save_load_roundtrip_bitexact(tmp_path):
    cfg, tables, state = _setup(max_timesteps=3)
    state = transport.solve(cfg, tables, state, num_steps=3)
    path = ck.save_checkpoint(str(tmp_path), state, 3, cfg)
    loaded, step = ck.load_checkpoint(path, cfg)
    assert step == 3
    for a, b in zip(state, loaded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_matches_uninterrupted(tmp_path):
    """4 steps + crash + resume for 6 == 10 straight, bitwise, including
    across BDF2 sub-cycle history (prev/half ends)."""
    cfg, tables, state0 = _setup(max_timesteps=10)
    straight = transport.solve(cfg, tables, state0, num_steps=10)

    # first process: checkpoint every 2, dies after 4 steps
    ck.solve_with_checkpoints(
        cfg, tables, state0, str(tmp_path), every=2, num_steps=4
    )
    assert ck.latest_checkpoint(str(tmp_path)).endswith("ckpt_000000004.npz")

    # second process: resumes and finishes
    final, resumed_from = ck.solve_with_checkpoints(
        cfg, tables, state0, str(tmp_path), every=3, num_steps=10
    )
    assert resumed_from == 4
    for a, b in zip(straight, final):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fingerprint_guard(tmp_path):
    cfg, tables, state = _setup(max_timesteps=2)
    path = ck.save_checkpoint(str(tmp_path), state, 2, cfg)
    # stopping criterion changes are allowed
    ck.load_checkpoint(path, cfg.replace(max_timesteps=50))
    # physics changes are not
    with pytest.raises(ValueError, match="different problem"):
        ck.load_checkpoint(path, cfg.replace(kappa_grey=2.0))


def test_latest_checkpoint_ordering(tmp_path):
    cfg, tables, state = _setup(max_timesteps=1)
    for s in (1, 10, 2):
        ck.save_checkpoint(str(tmp_path), state, s, cfg)
    assert ck.latest_checkpoint(str(tmp_path)).endswith("ckpt_000000010.npz")
    assert ck.latest_checkpoint(str(tmp_path / "empty")) is None


def test_cli_checkpoint_resume(tmp_path):
    from radiative_transfer import cli

    deck = reference_deck("single_group.prm")
    out1, out2 = str(tmp_path / "a"), str(tmp_path / "b")
    ckdir = str(tmp_path / "ck")
    # full run in one go
    assert cli.main([deck, "--steps", "6", "--outdir", out1]) == 0
    # interrupted run: 3 steps, then finish via resume
    assert cli.main([deck, "--steps", "3", "--outdir", str(tmp_path / "x"),
                     "--checkpoint-dir", ckdir, "--checkpoint-every", "3"]) == 0
    assert cli.main([deck, "--steps", "6", "--outdir", out2,
                     "--checkpoint-dir", ckdir, "--checkpoint-every", "3"]) == 0
    for name in ("phi.csv", "psi.csv", "F.csv"):
        with open(os.path.join(out1, name), "rb") as f1, \
             open(os.path.join(out2, name), "rb") as f2:
            assert f1.read() == f2.read(), name


def test_engine_checkpoint_resume_fast(tmp_path):
    """Fast-engine checkpointing: resume matches uninterrupted, and the
    checkpoints are portable to the general solver's State format."""
    import jax.numpy as jnp

    from radiative_transfer.ops import fast_sweep

    cfg = load_config(reference_deck("single_group.prm"), max_timesteps=8)
    tables, _, _ = transport.build_tables(cfg)
    eng = fast_sweep.FastEngine(cfg, tables, dtype=jnp.float64, chunk=10)

    straight = eng.solve(num_steps=8)

    ck.solve_with_checkpoints_engine(
        eng, cfg, str(tmp_path), every=3, num_steps=5
    )
    final, resumed = ck.solve_with_checkpoints_engine(
        eng, cfg, str(tmp_path), every=3, num_steps=8
    )
    assert resumed == 5
    np.testing.assert_allclose(
        np.asarray(eng.ends(final)), np.asarray(eng.ends(straight)),
        rtol=0, atol=1e-13,
    )
    # portability: the stored State loads under the general-path format
    gstate, step = ck.load_checkpoint(ck.latest_checkpoint(str(tmp_path)), cfg)
    assert step == 8 and gstate.ends.shape == (cfg.M, cfg.G, cfg.N, 2)


def test_cli_checkpoint_fast_engine(tmp_path):
    from radiative_transfer import cli

    deck = reference_deck("single_group.prm")
    out = str(tmp_path / "o")
    assert cli.main([deck, "--steps", "4", "--outdir", out,
                     "--engine", "fast",
                     "--checkpoint-dir", str(tmp_path / "ck"),
                     "--checkpoint-every", "2"]) == 0
    assert ck.latest_checkpoint(str(tmp_path / "ck")).endswith("04.npz")


def _csv_equal(dir1, dir2, names=("phi.csv", "psi.csv", "F.csv")):
    for name in names:
        with open(os.path.join(dir1, name), "rb") as f1, \
             open(os.path.join(dir2, name), "rb") as f2:
            assert f1.read() == f2.read(), name


def test_cli_checkpoint_sharded_engine(tmp_path):
    """--mesh with an engine path honours --checkpoint-dir (it used to
    silently skip checkpointing): resumed run == same-chunking run."""
    from radiative_transfer import cli

    deck = reference_deck("single_group.prm")
    out1, out2 = str(tmp_path / "a"), str(tmp_path / "b")
    ck1, ck2 = str(tmp_path / "ck1"), str(tmp_path / "ck2")
    common = [deck, "--mesh", "1x2", "--engine", "fast",
              "--checkpoint-every", "3"]
    assert cli.main(common + ["--steps", "6", "--outdir", out1,
                              "--checkpoint-dir", ck1]) == 0
    assert ck.latest_checkpoint(ck1).endswith("06.npz")
    # interrupted at 3, resumed to 6
    assert cli.main(common + ["--steps", "3",
                              "--outdir", str(tmp_path / "x"),
                              "--checkpoint-dir", ck2]) == 0
    assert cli.main(common + ["--steps", "6", "--outdir", out2,
                              "--checkpoint-dir", ck2]) == 0
    _csv_equal(out1, out2)


def test_cli_checkpoint_sharded_general(tmp_path):
    """--mesh on the general (f64 scan) path checkpoints through the
    mesh-bound solve_fn and resumes to the identical trajectory."""
    from radiative_transfer import cli

    deck = reference_deck("single_group.prm")
    out1, out2 = str(tmp_path / "a"), str(tmp_path / "b")
    ckdir = str(tmp_path / "ck")
    common = [deck, "--mesh", "1x2", "--checkpoint-every", "3"]
    # uninterrupted, no checkpointing
    assert cli.main([deck, "--mesh", "1x2", "--steps", "6",
                     "--outdir", out1]) == 0
    # interrupted at 3, resumed to 6 (general path chunking is
    # bit-identical to the straight solve, see solve_with_checkpoints)
    assert cli.main(common + ["--steps", "3",
                              "--outdir", str(tmp_path / "x"),
                              "--checkpoint-dir", ckdir]) == 0
    assert cli.main(common + ["--steps", "6", "--outdir", out2,
                              "--checkpoint-dir", ckdir]) == 0
    _csv_equal(out1, out2)


def test_cli_checkpoint_mesh_engine(tmp_path):
    """The mesh engine (--engine auto --mesh 1x2: ShardedFastEngine)
    honours --checkpoint-dir."""
    from radiative_transfer import cli

    with open(reference_deck("single_group.prm")) as f:
        text = deck_edit(deck_edit(f.read(), "N=100", "N=1024"),
                         "X=1.", "X=10.24")
    deck = str(tmp_path / "gray_hires.prm")
    with open(deck, "w") as f:
        f.write(text)
    out = str(tmp_path / "o")
    ckdir = str(tmp_path / "ck")
    assert cli.main([deck, "--steps", "4", "--outdir", out,
                     "--engine", "auto", "--mesh", "1x2",
                     "--dtype", "float32",
                     "--checkpoint-dir", ckdir,
                     "--checkpoint-every", "2"]) == 0
    assert ck.latest_checkpoint(ckdir).endswith("04.npz")
