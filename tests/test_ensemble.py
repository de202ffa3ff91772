"""Ensemble (vmapped parameter-sweep) solves.

Validates that the batched program is exactly the single-solve program
per member, that the batch axis shards over a device mesh with no
value change, and that per-member gradients compose (vmap(grad)).
"""

import jax
import jax.numpy as jnp
import numpy as np

from radiative_transfer import adjoint, ensemble
from radiative_transfer.models import transport
from test_adjoint import small_cfg, setup


def test_ensemble_matches_member_loop():
    cfg = small_cfg(ts_method=3, use_correction=True)
    tables, state0 = setup(cfg)
    rng = np.random.default_rng(1)
    K = 5
    kappas = np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, cfg.G))

    final = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=state0)
    assert final.ends.shape == (K, cfg.M, cfg.G, cfg.N, 2)

    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=2)
    for k in range(K):
        ref = solve_fn({"kappa": jnp.asarray(kappas[k])}, state0)
        np.testing.assert_allclose(
            np.asarray(final.ends[k]), np.asarray(ref.ends), rtol=1e-14)


def test_ensemble_T_per_member_initial_condition():
    """A temperature ensemble rebuilds psi = B(T_k) per member."""
    cfg = small_cfg(ts_method=2, use_mg_equilib=True, psi_source=())
    tables, _ = setup(cfg)
    Ts = np.array([0.9, 1.0, 1.1]) * cfg.T

    final = ensemble.solve_ensemble(
        cfg, tables, {"T": Ts}, num_steps=2, state=None)
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=2)
    for k, T in enumerate(Ts):
        ref = solve_fn({"T": jnp.asarray(T)}, None)
        np.testing.assert_allclose(
            np.asarray(final.ends[k]), np.asarray(ref.ends), rtol=1e-14)
    # Members genuinely differ (the IC and sources moved with T).
    assert not np.allclose(np.asarray(final.ends[0]),
                           np.asarray(final.ends[1]))


def test_ensemble_sharded_over_mesh_matches_unsharded():
    cfg = small_cfg(ts_method=1)
    tables, state0 = setup(cfg)
    rng = np.random.default_rng(2)
    K = 8
    kappas = np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, cfg.G))

    plain = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=state0)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("ens",))
    sharded = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=state0,
        mesh=mesh)
    # Each member solves wholly on one device; XLA may fuse/round the
    # partitioned program slightly differently, so tight-f64, not bitwise.
    np.testing.assert_allclose(
        np.asarray(plain.ends), np.asarray(sharded.ends),
        rtol=1e-12, atol=0)
    # The output really is sharded along the ensemble axis.
    shard_shapes = {s.data.shape for s in sharded.ends.addressable_shards}
    assert shard_shapes == {(1, cfg.M, cfg.G, cfg.N, 2)}


def test_ensemble_batched_gradients():
    """vmap(grad): per-member opacity gradients in one program."""
    cfg = small_cfg(ts_method=2)
    tables, state0 = setup(cfg)
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=2)
    wt = np.asarray(tables.wt)

    def loss(kappa):
        f = solve_fn({"kappa": kappa}, state0)
        phi = transport.compute_phi(transport.psi_from_ends(f.ends), wt)
        return jnp.sum(phi**2)

    rng = np.random.default_rng(3)
    K = 4
    kappas = jnp.asarray(
        np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, cfg.G)))
    g_batch = jax.vmap(jax.grad(loss))(kappas)
    for k in range(K):
        g_one = jax.grad(loss)(kappas[k])
        np.testing.assert_allclose(
            np.asarray(g_batch[k]), np.asarray(g_one), rtol=1e-12)


def test_ensemble_validation_errors():
    cfg = small_cfg()
    tables, state0 = setup(cfg)
    import pytest

    with pytest.raises(ValueError, match="nothing to batch"):
        ensemble.solve_ensemble(cfg, tables, {}, num_steps=1, state=state0)
    with pytest.raises(ValueError, match="disagree on the leading axis"):
        ensemble.solve_ensemble(
            cfg, tables,
            {"kappa": np.ones((3, cfg.G)), "rho": np.ones((4, cfg.G))},
            num_steps=1, state=state0)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("ens",))
    with pytest.raises(ValueError, match="divide evenly"):
        ensemble.solve_ensemble(
            cfg, tables, {"kappa": np.ones((3, cfg.G))},
            num_steps=1, state=state0, mesh=mesh)


def test_stacked_fast_f64_matches_vmap_general():
    """The stacked G'=K*G problem on the f64 tiled engine reproduces the
    vmapped general solver member-for-member to roundoff — the
    no-runtime-group-coupling argument of ensemble.stack_ensemble,
    verified end-to-end (BDF2 + v/c correction, shared initial state)."""
    cfg = small_cfg(ts_method=3, use_correction=True)
    tables, state0 = setup(cfg)
    rng = np.random.default_rng(5)
    K = 3
    kappas = np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, cfg.G))

    ref = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=3, state=state0)
    got = ensemble.solve_ensemble_stacked(
        cfg, tables, {"kappa": kappas}, num_steps=3, state=state0,
        engine="fast", dtype=jnp.float64)
    for name in ("ends", "prev_ends", "half_ends"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            rtol=1e-12, atol=1e-13)


def test_stacked_pallas_matches_vmap_general(monkeypatch):
    """The stacked problem through the fused GPU kernel (auto's f32 route
    on a GPU; here the platform is pinned and the Pallas-Triton kernel
    runs in the interpreter) at the f32 drift bar."""
    from radiative_transfer import backend

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    cfg = small_cfg(ts_method=3, use_correction=True)
    tables, state0 = setup(cfg)
    rng = np.random.default_rng(6)
    K = 4
    kappas = np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, cfg.G))

    ref = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=3, state=state0)
    got = ensemble.solve_ensemble_stacked(
        cfg, tables, {"kappa": kappas}, num_steps=3, state=state0,
        engine="auto", interpret=True)
    scale = np.max(np.abs(np.asarray(ref.ends)))
    np.testing.assert_allclose(
        np.asarray(got.ends), np.asarray(ref.ends),
        rtol=0, atol=5e-5 * scale)


def test_stacked_T_ensemble_exact_nonlinear_rebuild():
    """state=None gives each member its own psi = B(T_k) equilibrium IC,
    and the stacked path does the FULL nonlinear per-member table rebuild
    — member k must equal a from-scratch build_tables at T_k exactly
    (unlike the vmap/adjoint path, which linearises around the deck T)."""
    cfg = small_cfg(ts_method=2, use_mg_equilib=True, psi_source=())
    tables, _ = setup(cfg)
    Ts = np.array([0.8, 1.0, 1.25]) * cfg.T

    got = ensemble.solve_ensemble_stacked(
        cfg, tables, {"T": Ts}, num_steps=2, state=None,
        engine="fast", dtype=jnp.float64)
    for k, T in enumerate(Ts):
        cfg_k = cfg.replace(T=float(T))
        tab_k, _, _ = transport.build_tables(cfg_k)
        st_k = transport.initial_state(cfg_k, tab_k)
        ref_k = transport.solve(cfg_k, tab_k, st_k, num_steps=2)
        np.testing.assert_allclose(
            np.asarray(got.ends[k]), np.asarray(ref_k.ends),
            rtol=1e-12, atol=1e-13)
    assert not np.allclose(np.asarray(got.ends[0]), np.asarray(got.ends[1]))


def test_stacked_members_shard_over_group_mesh():
    """A 'g'-axis mesh shards stacked members across devices (zero
    cross-member collectives) with no value change vs the meshless run."""
    from radiative_transfer.parallel.sharded_fast import make_mesh_2d

    cfg = small_cfg(ts_method=1)
    tables, state0 = setup(cfg)
    rng = np.random.default_rng(7)
    K = 8
    kappas = np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, cfg.G))

    plain = ensemble.solve_ensemble_stacked(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=state0,
        engine="fast", dtype=jnp.float64)
    mesh = make_mesh_2d(8, 1)
    sharded = ensemble.solve_ensemble_stacked(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=state0,
        mesh=mesh, engine="fast", dtype=jnp.float64)
    np.testing.assert_allclose(
        np.asarray(plain.ends), np.asarray(sharded.ends),
        rtol=1e-12, atol=0)


def test_observe_phi_shape():
    cfg = small_cfg()
    tables, state0 = setup(cfg)
    K = 2
    kappas = np.broadcast_to(np.asarray(tables.kappa), (K, cfg.G))
    final = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=1, state=state0)
    phi = ensemble.observe_phi(cfg, tables, final)
    assert phi.shape == (K, cfg.G, cfg.N)


def test_vmap_ensemble_fast_solver_matches_general():
    """solve_ensemble(solver='fast') vmaps the differentiable fast
    engine; members must match the general vmap path to roundoff."""
    cfg = small_cfg(ts_method=3, use_correction=True)
    tables, state0 = setup(cfg)
    rng = np.random.default_rng(8)
    K = 3
    kappas = np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, cfg.G))

    ref = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=state0)
    got = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=state0,
        solver="fast")
    np.testing.assert_allclose(
        np.asarray(got.ends), np.asarray(ref.ends), rtol=1e-12, atol=1e-14)


def test_stacked_ensemble_f64_engine():
    """engine='auto' at float64 runs the stacked ensemble on the native
    f64 XLA engine: each member matches its own f64 solve to 1e-11."""
    import conftest
    from radiative_transfer import load_config

    cfg = load_config(conftest.reference_deck("single_group.prm"),
                      M=4, N=64, X=0.64, max_timesteps=3)
    tables, _, _ = transport.build_tables(cfg)
    kappas = np.array([[0.6], [1.0], [1.7]])
    params = {"kappa": jnp.asarray(kappas)}

    out = ensemble.solve_ensemble_stacked(cfg, tables, params,
                                          num_steps=3, engine="auto",
                                          dtype=jnp.float64)
    for k, kap in enumerate(kappas):
        cfg_k = cfg.replace(kappa_grey=float(kap[0]))
        tab_k, _, _ = transport.build_tables(cfg_k)
        from radiative_transfer.ops.fast_sweep import FastEngine

        fe = FastEngine(cfg_k, tab_k, dtype=jnp.float64)
        ref = np.asarray(fe.ends(fe.solve(num_steps=3)))
        got = np.asarray(out.ends[k])
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() / scale < 1e-11, k
