"""Differentiable-solve (adjoint) validation.

Three layers:
  1. traced_tables == build_tables at the deck's own parameter values
     (the jnp re-trace of src/correction.cpp:125-340 is value-identical
     to the host build, quirks included);
  2. jax.grad through full BE/CN/BDF2 solves matches central finite
     differences for kappa / rho / psi_source / the initial state, with
     and without the relativistic correction, G == 1 and G > 1;
  3. the end-to-end inverse problem recovers a perturbed opacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import adjoint
from radiative_transfer.config.config import Config
from radiative_transfer.models import transport


def small_cfg(**kw) -> Config:
    base = dict(
        M=4, G=3, N=16, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(
            tuple(0.01 * (m + 1) + 0.002 * g for g in range(3))
            for m in range(4)
        ),
        rho=2.0, kappa_grey=1.0, T=1.0, V=0.001,
        use_correction=True, ts_method=3, dt=1e-4, max_timesteps=3,
        include_validation=False,
    )
    base.update(kw)
    return Config(**base)


def loss_and_grad_fn(cfg, tables, state0, n, remat=True):
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=n, remat=remat)
    wt = np.asarray(tables.wt)

    def loss(params, state):
        final = solve_fn(params, state)
        phi = transport.compute_phi(transport.psi_from_ends(final.ends), wt)
        return jnp.sum(phi**2) * 1e3

    return loss


def central_fd(f, x, eps):
    """Central finite-difference gradient of scalar f at 1-D/2-D x.

    FD floor: the loss is O(1e4-1e5), so each difference carries
    ~|f|*eps_mach/(2*eps) of roundoff — callers compare with an atol
    proportional to the gradient's own max magnitude."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    for _ in it:
        idx = it.multi_index
        xp, xm = x.copy(), x.copy()
        xp[idx] += eps
        xm[idx] -= eps
        g[idx] = (float(f(xp)) - float(f(xm))) / (2 * eps)
    return g


def setup(cfg):
    tables, _, _ = transport.build_tables(cfg)
    state0 = transport.initial_state(cfg, tables)
    return tables, state0


# ---------------------------------------------------------------------------
# 1. traced_tables parity with the host build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 3, 8])
def test_traced_tables_match_host_build(G):
    cfg = small_cfg(G=G, psi_source=(), use_mg_equilib=False)
    tables, _, _ = transport.build_tables(cfg)
    traced = jax.jit(
        lambda k, r: adjoint.traced_tables(cfg, tables, kappa=k, rho=r)
    )(np.asarray(tables.kappa), np.asarray(tables.rho))
    for name in ("kappa", "rho", "rhokap", "cor1", "cor2", "cor3",
                 "psi_source", "B", "dEB", "mu", "wt"):
        np.testing.assert_allclose(
            np.asarray(getattr(traced, name)),
            np.asarray(getattr(tables, name)),
            rtol=1e-14, atol=0, err_msg=name,
        )


def test_traced_tables_rejects_unknown_param():
    cfg = small_cfg()
    tables, state0 = setup(cfg)
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=1)
    with pytest.raises(ValueError, match="unknown differentiable"):
        solve_fn({"dt": jnp.asarray(1e-4)}, state0)


# ---------------------------------------------------------------------------
# 2. grad vs central finite differences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ts_method", [1, 2, 3])
@pytest.mark.parametrize("use_correction", [False, True])
def test_grad_kappa_matches_fd(ts_method, use_correction):
    cfg = small_cfg(ts_method=ts_method, use_correction=use_correction)
    tables, state0 = setup(cfg)
    loss = loss_and_grad_fn(cfg, tables, state0, n=3)

    k0 = np.asarray(tables.kappa)
    g_ad = jax.grad(lambda k: loss({"kappa": k}, state0))(jnp.asarray(k0))
    g_fd = central_fd(lambda k: loss({"kappa": jnp.asarray(k)}, state0),
                      k0, eps=1e-5)
    np.testing.assert_allclose(np.asarray(g_ad), g_fd, rtol=2e-5,
                               atol=1e-6 * np.abs(g_fd).max())


def test_grad_rho_and_psi_source_match_fd():
    cfg = small_cfg()
    tables, state0 = setup(cfg)
    loss = loss_and_grad_fn(cfg, tables, state0, n=2)

    r0 = np.asarray(tables.rho)
    g_ad = jax.grad(lambda r: loss({"rho": r}, state0))(jnp.asarray(r0))
    g_fd = central_fd(lambda r: loss({"rho": jnp.asarray(r)}, state0),
                      r0, eps=1e-5)
    np.testing.assert_allclose(np.asarray(g_ad), g_fd, rtol=2e-5,
                               atol=1e-6 * np.abs(g_fd).max())

    s0 = np.asarray(tables.psi_source)
    g_ad = jax.grad(
        lambda s: loss({"psi_source": s}, state0))(jnp.asarray(s0))
    g_fd = central_fd(
        lambda s: loss({"psi_source": jnp.asarray(s)}, state0), s0, eps=1e-5)
    np.testing.assert_allclose(np.asarray(g_ad), g_fd, rtol=2e-5,
                               atol=1e-6 * np.abs(g_fd).max())


def test_grad_initial_state_matches_fd_sampled():
    """d loss / d ends0 at a handful of probe entries (full FD over
    (M,G,N,2) is too slow; probes cover both direction halves)."""
    cfg = small_cfg(ts_method=2, max_timesteps=2)
    tables, state0 = setup(cfg)
    loss = loss_and_grad_fn(cfg, tables, state0, n=2)

    g_ad = np.asarray(
        jax.grad(lambda s: loss({}, s))(state0).ends)
    e0 = np.asarray(state0.ends)
    eps = 1e-6
    rng = np.random.default_rng(0)
    for _ in range(6):
        idx = tuple(rng.integers(0, d) for d in e0.shape)
        ep, em = e0.copy(), e0.copy()
        ep[idx] += eps
        em[idx] -= eps
        fp = float(loss({}, state0._replace(ends=jnp.asarray(ep))))
        fm = float(loss({}, state0._replace(ends=jnp.asarray(em))))
        fd = (fp - fm) / (2 * eps)
        # FD noise floor: |loss| ~ 4e7, so the difference carries
        # ~|f|*eps_mach/(2*eps) ≈ 2e-3 of absolute roundoff.
        np.testing.assert_allclose(
            g_ad[idx], fd, rtol=1e-4, atol=1e-8 * np.abs(g_ad).max())


def test_grad_grey_single_group():
    """G == 1 exercises the dsigEdE overwrite quirk inside the trace."""
    cfg = small_cfg(G=1, psi_source=((0.1,), (0.2,), (0.3,), (0.4,)),
                    use_correction=True, ts_method=3)
    tables, state0 = setup(cfg)
    loss = loss_and_grad_fn(cfg, tables, state0, n=2)
    k0 = np.asarray(tables.kappa)
    g_ad = jax.grad(lambda k: loss({"kappa": k}, state0))(jnp.asarray(k0))
    g_fd = central_fd(lambda k: loss({"kappa": jnp.asarray(k)}, state0),
                      k0, eps=1e-5)
    np.testing.assert_allclose(np.asarray(g_ad), g_fd, rtol=2e-5,
                               atol=1e-6 * np.abs(g_fd).max())


def test_remat_matches_no_remat():
    cfg = small_cfg()
    tables, state0 = setup(cfg)
    k0 = jnp.asarray(np.asarray(tables.kappa))
    out = {}
    for remat in (True, False):
        loss = loss_and_grad_fn(cfg, tables, state0, n=3, remat=remat)
        out[remat] = (
            float(loss({"kappa": k0}, state0)),
            np.asarray(jax.grad(
                lambda k: loss({"kappa": k}, state0))(k0)),
        )
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-15)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-12)


def test_forward_matches_transport_solve():
    """The diff solve is the SAME discrete program as transport.solve."""
    cfg = small_cfg()
    tables, state0 = setup(cfg)
    ref = transport.solve(cfg, tables, state0, num_steps=3)
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=3)
    out = solve_fn({}, state0)
    # traced_tables' vectorized diffs round differently at the last ulp
    # than the host loop; the programs are otherwise identical.
    np.testing.assert_allclose(
        np.asarray(out.ends), np.asarray(ref.ends), rtol=1e-12)


# ---------------------------------------------------------------------------
# 3. inverse problem
# ---------------------------------------------------------------------------

def test_inverse_opacity_recovery():
    """Recover group opacities from the flux profile they produced."""
    cfg = small_cfg(ts_method=2, max_timesteps=4, use_correction=False)
    tables, state0 = setup(cfg)
    wt = np.asarray(tables.wt)

    k_true = np.asarray(tables.kappa) * np.array([1.4, 0.7, 1.2])
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=4)
    final_true = solve_fn({"kappa": jnp.asarray(k_true)}, state0)
    phi_target = transport.compute_phi(
        transport.psi_from_ends(final_true.ends), wt)

    def loss_of_state(final, params):
        phi = transport.compute_phi(
            transport.psi_from_ends(final.ends), wt)
        return jnp.mean((phi / phi_target - 1.0) ** 2)

    params0 = {"kappa": jnp.asarray(np.asarray(tables.kappa))}
    params, hist = adjoint.fit_params(
        cfg, tables, state0, loss_of_state, params0,
        num_steps=4, learning_rate=0.05, iterations=300,
    )
    assert hist[-1] < hist[0] * 1e-4, (hist[0], hist[-1])
    np.testing.assert_allclose(
        np.asarray(params["kappa"]), k_true, rtol=0.02)


# ---------------------------------------------------------------------------
# 4. temperature sensitivity (linearised-at-deck-T trace)
# ---------------------------------------------------------------------------

def _true_model_loss_at_T(cfg, n):
    """Loss of the TRUE model at temperature T: host tables rebuilt via
    the 3-regime Planck integrator, initial condition psi = B(T)."""
    def f(T):
        c = cfg.replace(T=float(T))
        tb, _, _ = transport.build_tables(c)
        st = transport.initial_state(c, tb)
        final = transport.solve(c, tb, st, num_steps=n)
        phi = transport.compute_phi(
            transport.psi_from_ends(final.ends), np.asarray(tb.wt))
        return float(jnp.sum(phi**2) * 1e3)
    return f


@pytest.mark.parametrize("use_mg_equilib", [False, True])
def test_grad_T_matches_true_model_fd(use_mg_equilib):
    """d loss / dT from the linearised trace equals the true model's
    central difference at the deck temperature — the linearisation is
    exact AT T0, so AD here is the true derivative, and FD of the
    full nonlinear rebuild (new Planck integrals, new equilibrium
    source, new initial condition) validates it end to end."""
    kw = dict(ts_method=3, max_timesteps=2)
    if use_mg_equilib:
        kw.update(use_mg_equilib=True, psi_source=())
    cfg = small_cfg(**kw)
    tables, _ = setup(cfg)
    n = 2

    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=n)
    wt = np.asarray(tables.wt)

    def loss(T):
        final = solve_fn({"T": T}, None)  # state from traced tables
        phi = transport.compute_phi(
            transport.psi_from_ends(final.ends), wt)
        return jnp.sum(phi**2) * 1e3

    g_ad = float(jax.grad(loss)(jnp.asarray(cfg.T)))

    f = _true_model_loss_at_T(cfg, n)
    eps = 1e-5
    g_fd = (f(cfg.T + eps) - f(cfg.T - eps)) / (2 * eps)
    np.testing.assert_allclose(g_ad, g_fd, rtol=2e-4)


def test_traced_tables_T_identity_at_deck_value():
    """T = deck T reproduces the host tables exactly (dT = 0)."""
    cfg = small_cfg(use_mg_equilib=True, psi_source=())
    tables, _, _ = transport.build_tables(cfg)
    traced = jax.jit(
        lambda T: adjoint.traced_tables(cfg, tables, T=T)
    )(jnp.asarray(cfg.T))
    for name in ("B", "dEB", "cor1", "cor2", "cor3", "psi_source",
                 "rhokap"):
        np.testing.assert_allclose(
            np.asarray(getattr(traced, name)),
            np.asarray(getattr(tables, name)),
            rtol=1e-13, err_msg=name,
        )


# ---------------------------------------------------------------------------
# 4. Differentiable FAST engine (make_diff_solve_fast)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_fast_diff_solve_forward_and_grad_match_general(ts_method):
    """The fast-engine differentiable path must reproduce the general
    path's forward values AND kappa gradients to roundoff — the adjoint
    of the tiled constant-coefficient scan is exactly the adjoint of the
    readable solver because both are the same discrete scheme."""
    cfg = small_cfg(ts_method=ts_method, use_correction=True)
    tables, state0 = setup(cfg)
    f_gen = adjoint.make_diff_solve(cfg, tables, num_steps=3)
    f_fast = adjoint.make_diff_solve_fast(cfg, tables, num_steps=3)
    kap = jnp.asarray(np.asarray(tables.kappa) * 1.3)
    wt = np.asarray(tables.wt)

    a = f_gen({"kappa": kap}, state0)
    b = f_fast({"kappa": kap}, state0)
    for name in ("ends", "prev_ends", "half_ends"):
        np.testing.assert_allclose(
            np.asarray(getattr(b, name)), np.asarray(getattr(a, name)),
            rtol=1e-12, atol=1e-14)

    def make_loss(f):
        def L(k):
            fin = f({"kappa": k}, state0)
            phi = transport.compute_phi(
                transport.psi_from_ends(fin.ends), wt)
            return jnp.sum(phi**2)
        return L

    ga = np.asarray(jax.grad(make_loss(f_gen))(kap))
    gb = np.asarray(jax.grad(make_loss(f_fast))(kap))
    np.testing.assert_allclose(gb, ga, rtol=1e-11)


def test_fast_diff_solve_T_and_boundary_grads():
    """T gradients (traced IC, equilibrium boundary rebuild) and
    psi_source gradients through the fast engine's boundary planes."""
    cfg = small_cfg(ts_method=3, use_mg_equilib=True, psi_source=())
    tables, _ = setup(cfg)
    f_gen = adjoint.make_diff_solve(cfg, tables, num_steps=2)
    f_fast = adjoint.make_diff_solve_fast(cfg, tables, num_steps=2)
    wt = np.asarray(tables.wt)

    def make_loss(f, key):
        def L(v):
            fin = f({key: v}, None if key == "T" else
                    transport.initial_state(cfg, tables))
            phi = transport.compute_phi(
                transport.psi_from_ends(fin.ends), wt)
            return jnp.sum(phi**2)
        return L

    gT_gen = float(jax.grad(make_loss(f_gen, "T"))(jnp.asarray(cfg.T)))
    gT_fast = float(jax.grad(make_loss(f_fast, "T"))(jnp.asarray(cfg.T)))
    np.testing.assert_allclose(gT_fast, gT_gen, rtol=1e-11)

    ps = jnp.asarray(np.asarray(tables.psi_source))
    gp_gen = np.asarray(jax.grad(make_loss(f_gen, "psi_source"))(ps))
    gp_fast = np.asarray(jax.grad(make_loss(f_fast, "psi_source"))(ps))
    np.testing.assert_allclose(gp_fast, gp_gen, rtol=1e-11,
                               atol=1e-11 * np.max(np.abs(gp_gen)))


def test_fit_params_fast_solver():
    """fit_params(solver='fast') converges on the same inverse problem
    (single Adam run, loss strictly decreasing)."""
    cfg = small_cfg(ts_method=2, G=2, psi_source=tuple(
        tuple(0.02 for _ in range(2)) for _ in range(4)))
    tables, state0 = setup(cfg)
    wt = np.asarray(tables.wt)
    k_true = np.asarray(tables.kappa) * np.array([0.7, 1.4])
    f = adjoint.make_diff_solve_fast(cfg, tables, num_steps=2)
    target = transport.compute_phi(transport.psi_from_ends(
        f({"kappa": jnp.asarray(k_true)}, state0).ends), wt)

    def loss_of_state(final, params):
        phi = transport.compute_phi(
            transport.psi_from_ends(final.ends), wt)
        return jnp.mean((phi / target - 1.0) ** 2)

    params, hist = adjoint.fit_params(
        cfg, tables, state0, loss_of_state,
        {"kappa": jnp.asarray(np.asarray(tables.kappa))},
        num_steps=2, learning_rate=0.05, iterations=60, solver="fast")
    assert hist[-1] < hist[0] * 1e-2
    np.testing.assert_allclose(
        np.asarray(params["kappa"]), k_true, rtol=0.2)
