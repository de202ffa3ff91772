"""Differentiable (adjoint) solves: exact gradients of the transport
solution with respect to physics parameters.

The serial C++ reference has no analogue of this module — it exists
because the solve is a pure-functional JAX program end to
end, so `jax.grad` composes with the same batched associative-scan sweep
(ops/sweep.py) and the same BE/CN/BDF2 integrators (models/transport.py)
used by the forward path, yielding the exact discrete adjoint of the
fully-implicit scheme (discretize-then-differentiate). Use cases:
inverse opacity problems (fit group kappas to an observed flux/spectrum),
boundary-source estimation, and sensitivity analysis.

Differentiable parameters — the kappa/rho-dependent half of the
reference's T-frozen table chain (src/correction.cpp) re-traced in jnp
so gradients flow through every derived table:

* ``kappa`` (G,) — group opacities. Reaches the solve through rhokap,
  the group-edge interpolation (src/correction.cpp:125-159), dsigEdE /
  dkapEB (:206-211, :241-249 — including the G == 1 last-group
  overwrite quirk, see docs/QUIRKS.md #7) and cor1/2/3 (:328-340).
* ``rho`` (G,) — material density (rhokap and cor2).
* ``psi_source`` (M, G) — boundary source intensities.
* the initial ``State`` — trivially, as the function input.

* ``T`` (scalar) — material temperature, to FIRST ORDER around the
  deck value: T reaches the solve only through the Planckian tables
  (B_g, dEB_g, the edge Planck function), and the reference's own
  analytic temperature derivatives (dB_g/dT from the 3-regime
  integrator, src/Planck.cpp; d pf/dT in closed form) make the traced
  tables exactly linear in (T - T0). Gradients AT the deck temperature
  are therefore exact; the forward value away from T0 is the
  tangent-linear model (re-center by rebuilding tables to iterate on
  T — see ``fit_params``'s docstring).

Memory: reverse-mode through ``num_steps`` steps stores one State per
step; each step body is rematerialised (`jax.checkpoint`) so the 4-8
sweeps inside a CN/BDF2 step are recomputed in the backward pass rather
than stored. Run in float64 (the package default) — adjoint sweeps
compose the same contractive affine maps as the primal, so they are
well-conditioned, but FD validation needs the headroom.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .config.config import Config
from .models import transport
from .models.transport import State, Tables
from .ops import correction as corr_mod

_PARAM_KEYS = ("kappa", "rho", "psi_source", "T")


def _edge_planck(cfg: Config, e_edge: np.ndarray) -> np.ndarray:
    """pf(e_edge, T) with the unused E=0 edge zeroed (the reference only
    ever evaluates pf at edges 1..G, src/correction.cpp:162-249)."""
    pfe = np.zeros(e_edge.shape[0], dtype=np.float64)
    pfe[1:] = corr_mod.pf(e_edge[1:], cfg.T)
    return pfe


def _edge_planck_dT(cfg: Config, e_edge: np.ndarray) -> np.ndarray:
    """d pf(e_edge, T)/dT in closed form:
    pf = k E^3 / (h^3 c^2 (e^{E/T} - 1))  =>
    dpf/dT = pf * (E/T^2) * e^{E/T} / (e^{E/T} - 1)."""
    d = np.zeros(e_edge.shape[0], dtype=np.float64)
    E = np.asarray(e_edge[1:], np.float64)
    T = cfg.T
    x = np.exp(E / T)
    d[1:] = corr_mod.pf(E, T) * (E / T**2) * x / (x - 1.0)
    return d


def _planck_dT_tables(cfg: Config):
    """Host analytic T-derivatives of every T-dependent table at the deck
    temperature: (dBdT, d(dEB)/dT, d pfe/dT), all in jk units.

    dBdT comes from the reference's own 3-regime integrator
    (src/Planck.cpp — the code computes it alongside B_g and validates
    sum dB_g/dT = 4 a c T^3); d(dEB)/dT and d pfe/dT follow from the
    closed-form pf derivative with the same edge-difference structure
    as dEB/dkapEB (src/correction.cpp:162-174, 241-249)."""
    from .ops import planck as planck_mod
    from .ops.groups import build_group_grid

    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast,
                            cfg.group_bounds_array())
    _, dBdT_keV = planck_mod.planck_group_integrals(cfg.T, grid.edisc)
    dBdT = corr_mod._KCON * dBdT_keV

    e_edge = grid.e_edge
    G = cfg.G
    dpfe = _edge_planck_dT(cfg, e_edge)
    ddEB = np.zeros(G, dtype=np.float64)
    ddEB[0] = e_edge[1] * dpfe[1]
    if G > 1:
        for g in range(1, G - 1):
            ddEB[g] = e_edge[g + 1] * dpfe[g + 1] - e_edge[g] * dpfe[g]
        ddEB[G - 1] = -e_edge[G - 1] * dpfe[G - 1]
    return dBdT, ddEB, dpfe


def traced_tables(
    cfg: Config,
    base: Tables,
    kappa: Optional[jnp.ndarray] = None,
    rho: Optional[jnp.ndarray] = None,
    psi_source: Optional[jnp.ndarray] = None,
    T: Optional[jnp.ndarray] = None,
) -> Tables:
    """Rebuild the kappa/rho-dependent Tables leaves as traced jnp values.

    Exactly mirrors the host-side build (ops/correction.py
    build_correction_tables <- src/correction.cpp:125-340), including the
    unguarded G == 1 dsigEdE last-group overwrite: the reference writes
    entry 0 with the first-group form and then overwrites it with the
    last-group form, which the ``.at[0]`` -> ``.at[G-1]`` set order
    replicates. T-only leaves (B, dEB, quadrature, grid) pass through
    from ``base`` untouched.

    Intended for use INSIDE a traced function (make_diff_solve): the
    returned Tables carries tracers, deliberately violating the
    host-numpy rule of models/transport.Tables — which only governs
    leaves captured by jit closures, not jit arguments.
    """
    dtype = np.asarray(base.B).dtype
    G = cfg.G

    # Constants w.r.t. the differentiable parameters (host f64).
    e_edge = np.asarray(base.e_edge, np.float64)
    e_ave = np.asarray(base.e_ave, np.float64)
    de_ave = np.asarray(base.de_ave, np.float64)
    B = np.asarray(base.B, np.float64)
    dEB = np.asarray(base.dEB, np.float64)
    pfe = _edge_planck(cfg, e_edge)

    if T is not None:
        # Exact linearisation around the deck temperature: every
        # T-dependence of the solve goes through (B, dEB, pfe), and
        # their analytic derivatives are available, so the traced
        # tables are linear in (T - T0) with the true slope.
        dBdT, ddEB, dpfe = _planck_dT_tables(cfg)
        dT = jnp.asarray(T, jnp.float64) - cfg.T
        B = B + dBdT * dT
        dEB = dEB + ddEB * dT
        pfe = pfe + dpfe * dT

    kappa = jnp.asarray(base.kappa if kappa is None else kappa, dtype)
    rho = jnp.asarray(base.rho if rho is None else rho, dtype)
    if psi_source is None:
        if T is not None and cfg.use_mg_equilib:
            # The equilibrium boundary source is itself Planckian
            # (solver.cpp:287-315) — rebuild it from the traced B/dEB.
            mu = np.asarray(base.mu, np.float64)
            psi_source = corr_mod.equilibrium_psi_source(B, dEB, mu, cfg.V)
            psi_source = jnp.asarray(psi_source, dtype)
        else:
            psi_source = jnp.asarray(base.psi_source, dtype)
    else:
        psi_source = jnp.asarray(psi_source, dtype)

    kappa64 = kappa.astype(jnp.float64)
    rho64 = rho.astype(jnp.float64)

    # Group-edge opacities (src/correction.cpp:125-159): linear-in-e_ave
    # interpolation; both outer edges clamp to the adjacent group value.
    if G > 1:
        wgt_l = (e_ave[1:] - e_edge[1:G]) / (e_ave[1:] - e_ave[:-1])
        wgt_r = (e_edge[1:G] - e_ave[:-1]) / (e_ave[1:] - e_ave[:-1])
        interior = kappa64[:-1] * wgt_l + kappa64[1:] * wgt_r
        kappa_edge = jnp.concatenate([kappa64[:1], interior, kappa64[-1:]])
    else:
        kappa_edge = jnp.concatenate([kappa64[:1], kappa64[:1]])

    ke_e = kappa_edge * e_edge                      # (G+1,) kappa*E at edges

    # dsigEdE (src/correction.cpp:206-211). General central difference,
    # then the one-sided ends — LAST write wins, replicating the G == 1
    # overwrite of entry 0 by the last-group form.
    dsig = jnp.diff(ke_e) / de_ave
    dsig = dsig.at[0].set(ke_e[1] / de_ave[0])
    dsig = dsig.at[G - 1].set(-ke_e[G] / de_ave[G - 1])

    # dkapEB (src/correction.cpp:241-249); the last-group form uses edge
    # index G-1 (as written in the reference), and for G == 1 only the
    # first-group form applies (the rest is guarded by num_groups > 1).
    kep = ke_e * pfe                                # (G+1,) kappa*E*B at edges
    if G > 1:
        dkap = jnp.diff(kep)
        dkap = dkap.at[0].set(kep[1])
        dkap = dkap.at[G - 1].set(-ke_e[G - 1] * pfe[G - 1])
    else:
        dkap = kep[1:2]

    cor1 = dsig
    cor2 = 3.0 * rho64 * kappa64 * B - dkap
    cor3 = cor1 * (4.0 * B - dEB)

    as_dt = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return base._replace(
        kappa=as_dt(kappa),
        rho=as_dt(rho),
        rhokap=as_dt(rho64 * kappa64),
        B=as_dt(B),
        dEB=as_dt(dEB),
        cor1=as_dt(cor1),
        cor2=as_dt(cor2),
        cor3=as_dt(cor3),
        psi_source=psi_source,
    )


def traced_initial_state(cfg: Config, tables: Tables) -> State:
    """The reference initial condition psi = ends = B_g
    (src/solver.cpp:165-181) built from possibly-traced tables, so a
    temperature gradient includes the initial condition's T-dependence."""
    ends = jnp.broadcast_to(
        jnp.asarray(tables.B)[None, :, None, None],
        (cfg.M, cfg.G, cfg.N, 2),
    )
    return State(ends=ends, prev_ends=ends, half_ends=ends)


def make_diff_solve(
    cfg: Config,
    tables: Tables,
    num_steps: Optional[int] = None,
    remat: bool = True,
):
    """Build ``solve_fn(params, state) -> State``, differentiable in both
    arguments.

    ``params`` is a dict with any subset of {'kappa', 'rho',
    'psi_source', 'T'}; omitted parameters stay frozen at their
    ``tables`` values (for 'T', gradients are exact at the deck
    temperature — see the module docstring). Pass ``state=None`` to
    build the reference initial condition psi = B_g from the traced
    tables, so dT gradients include the initial condition.
    The returned function runs ``num_steps`` full timesteps
    (default cfg.max_timesteps) of cfg.ts_method, exactly the program of
    models/transport.solve, as a `lax.scan` so reverse-mode stores one
    State per step; with ``remat`` each step recomputes its sweeps in
    the backward pass.

    Compose with the standard diagnostics for observables::

        solve_fn = make_diff_solve(cfg, tables)

        def loss(params):
            final = solve_fn(params, state0)
            phi = transport.compute_phi(
                transport.psi_from_ends(final.ends), tables.wt)
            return jnp.mean((phi - phi_target) ** 2)

        g = jax.grad(loss)({'kappa': kappa0})   # d loss / d kappa, (G,)

    Wrap the caller in `jax.jit` for repeated evaluation (the params
    dict is a pytree argument, so no retrace per value).
    """
    n = cfg.max_timesteps if num_steps is None else num_steps

    def solve_fn(params: dict, state: Optional[State]) -> State:
        unknown = set(params) - set(_PARAM_KEYS)
        if unknown:
            raise ValueError(
                f"unknown differentiable parameters {sorted(unknown)}; "
                f"supported: {_PARAM_KEYS}"
            )
        t = traced_tables(cfg, tables, **params)
        if state is None:
            state = traced_initial_state(cfg, t)
        step = transport.make_step_fn(cfg, t)

        def body(s, _):
            return step(s), None

        if remat:
            body = jax.checkpoint(body)
        out, _ = lax.scan(body, state, None, length=n)
        return out

    return solve_fn


def make_diff_solve_fast(
    cfg: Config,
    tables: Tables,
    num_steps: Optional[int] = None,
    remat: bool = True,
    chunk: int = 256,
    unroll: int = 4,
):
    """Differentiable solve at the tiled fast-engine rate.

    Same contract as :func:`make_diff_solve` (``solve_fn(params, state)
    -> State`` in global (M, G, N, 2) layout, exact discrete adjoint via
    ``jax.grad``), but the forward program is
    ops/fast_sweep.FastEngine's fused constant-coefficient scan instead
    of the readable general path: the per-group parameter dependence is
    carried into the engine's coefficient planes by
    build_kind_coeffs_traced and into the boundary planes by the traced
    psi_source, so gradients flow through the SAME algebra the
    production engine runs. float64 throughout (gradient fidelity);
    forward and gradient values match make_diff_solve to roundoff
    (tests/test_adjoint.py::test_fast_diff_solve_*)."""
    from .ops import fast_sweep as fs

    n = cfg.max_timesteps if num_steps is None else num_steps
    eng = fs.FastEngine(cfg, tables, dtype=jnp.float64, chunk=chunk,
                        unroll=unroll)
    Mh, G = cfg.M // 2, cfg.G
    if cfg.ts_method == 1:
        kinds = {fs.BE: cfg.dt}
    elif cfg.ts_method == 2:
        kinds = {fs.CN: cfg.dt}
    else:
        half = cfg.dt / 2.0
        kinds = {fs.BE: half, fs.CN: half, fs.BDF: half}

    def solve_fn(params: dict, state: Optional[State]) -> State:
        unknown = set(params) - set(_PARAM_KEYS)
        if unknown:
            raise ValueError(
                f"unknown differentiable parameters {sorted(unknown)}; "
                f"supported: {_PARAM_KEYS}"
            )
        t = traced_tables(cfg, tables, **params)
        kcs = {k: fs.build_kind_coeffs_traced(cfg, t, k, ts)
               for k, ts in kinds.items()}
        # Traced boundary value planes, mirroring FastEngine.__init__
        # (incl. the left-vacuum fallthrough-to-source quirk,
        # solver.cpp:667-671); the reflective/fixed STRUCTURE is static.
        psi_plane = fs._to_plane(
            jnp.asarray(t.psi_source, jnp.float64), Mh, G)
        bc_neg = (psi_plane[0] if cfg.bc_right_indicator == 1
                  else jnp.zeros(Mh * G))
        bc_pos = None if cfg.bc_left_indicator == 2 else psi_plane[1]

        if state is None:
            # psi = ends = B_g (solver.cpp:165-181) from the traced B, so
            # dT gradients include the initial condition.
            Bg = jnp.broadcast_to(
                jnp.asarray(t.B, jnp.float64)[None, :], (Mh, G)
            ).reshape(Mh * G)
            plane = jnp.broadcast_to(
                Bg[None, None, :, None], (eng.chunk, 2, Mh * G, eng.nc))
            st = fs.FlatState(plane, plane, plane, plane, plane, plane)
        else:
            st = eng.from_ends(state.ends, state.prev_ends,
                               state.half_ends)

        def body(s, _):
            return eng.step(s, kcs=kcs, bc=(bc_neg, bc_pos)), None

        if remat:
            body = jax.checkpoint(body)
        st, _ = lax.scan(body, st, None, length=n)
        return State(
            ends=eng.ends(st),
            prev_ends=eng.ends_pair(st.p0, st.p1),
            half_ends=eng.ends_pair(st.h0, st.h1),
        )

    return solve_fn


def fit_params(
    cfg: Config,
    tables: Tables,
    state0: State,
    loss_of_state,
    params0: dict,
    num_steps: Optional[int] = None,
    learning_rate: float = 1e-2,
    iterations: int = 100,
    optimizer=None,
    solver: str = "general",
):
    """Gradient-descent parameter estimation (the inverse-problem driver).

    Minimises ``loss_of_state(final_state, params)`` over ``params0``'s
    leaves with optax (Adam by default). Returns (params, loss_history).
    The whole update step — forward solve, adjoint, optimizer — is one
    jitted program; iterations stream on-device.
    ``solver='fast'`` differentiates through the tiled fast engine
    (make_diff_solve_fast) — same gradients to roundoff, much faster
    forward/backward at production sizes.

    To iterate on 'T' (whose trace is linearised at the deck value),
    re-center between calls: run a few iterations, rebuild tables at
    the updated temperature (build_tables(cfg.replace(T=...))), repeat —
    each call then performs a Gauss–Newton-like step with the exact
    local derivative.
    """
    import optax

    opt = optax.adam(learning_rate) if optimizer is None else optimizer
    make = {"general": make_diff_solve, "fast": make_diff_solve_fast}
    if solver not in make:
        raise ValueError(f"unknown solver {solver!r} (general/fast)")
    solve_fn = make[solver](cfg, tables, num_steps=num_steps)

    def loss_fn(params):
        return loss_of_state(solve_fn(params, state0), params)

    @jax.jit
    def update(params, opt_state):
        val, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, val

    params = jax.tree_util.tree_map(jnp.asarray, params0)
    opt_state = opt.init(params)
    history = []
    for _ in range(iterations):
        params, opt_state, val = update(params, opt_state)
        history.append(float(val))
    return params, history
