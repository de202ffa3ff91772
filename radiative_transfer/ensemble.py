"""Ensemble solves: batched parameter sweeps in one compiled program.

Another capability with no analogue in the serial C++ reference (which
runs one deck per process): because the solve is a pure function of its
parameters, `jax.vmap` turns it into a batched solve over an ensemble
of parameter sets — opacity samples, source candidates, temperature
perturbations — in ONE XLA program whose batch axis fuses into the
existing (M, G) batch (the device sees a bigger batch, not a Python
loop). Use cases: uncertainty propagation, design
sweeps, and batched inverse problems (compose with adjoint.py:
``jax.vmap(jax.grad(...))`` gives per-member gradients).

Multi-chip: an ensemble is embarrassingly parallel, so the batch axis
shards perfectly over a `jax.sharding.Mesh` — `solve_ensemble(...,
mesh=...)` places each member's whole solve on one device with zero
collectives (the sharding propagates through the vmapped program).
This composes with, rather than replaces, the spatial/group
decompositions of parallel/ — shard the ensemble axis when you have
many small problems, shard space/groups when you have one big one.

Parameters follow adjoint.traced_tables: any subset of {'kappa',
'rho', 'psi_source', 'T'}, each stacked along a leading ensemble axis.

Two execution paths:

* :func:`solve_ensemble` — `jax.vmap` over the f64 general solver;
  differentiable (composes with jax.grad), exact, mesh-shardable.
* :func:`solve_ensemble_stacked` — folds the ensemble into the fused
  perf engines' lane batch as a G' = K*G stacked problem
  (:func:`stack_ensemble`); runs at the compiled Pallas-kernel rate
  and turns lane-starved small decks into full-utilisation ones.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config.config import Config
from .models import transport
from .models.transport import State, Tables
from .ops import correction as corr_mod
from .ops.groups import build_group_grid
from . import adjoint


def _batch_size(params: dict) -> int:
    sizes = {int(np.shape(v)[0]) for v in params.values()}
    if len(sizes) != 1:
        raise ValueError(
            f"ensemble leaves disagree on the leading axis: {sorted(sizes)}"
        )
    return sizes.pop()


def make_ensemble_solve(
    cfg: Config,
    tables: Tables,
    num_steps: Optional[int] = None,
    remat: bool = True,
    shared_state: bool = True,
    solver: str = "general",
):
    """Build ``ens_fn(params, state) -> State`` where every leaf of
    ``params`` carries a leading ensemble axis and the returned State's
    leaves carry it too.

    ``shared_state``: True (default) broadcasts one initial State to
    every member (pass None to rebuild psi = B_g per member from the
    traced tables — required for 'T' ensembles, whose initial
    condition varies); False expects the State leaves themselves
    stacked along the ensemble axis. ``solver='fast'`` vmaps the
    differentiable fast engine (adjoint.make_diff_solve_fast) instead
    of the general solver — same members to roundoff, engine-rate
    forward/backward (batched gradients via ``jax.vmap(jax.grad(...))``
    then also run the production algebra).
    """
    make = {"general": adjoint.make_diff_solve,
            "fast": adjoint.make_diff_solve_fast}
    if solver not in make:
        raise ValueError(f"unknown solver {solver!r} (general/fast)")
    solve_fn = make[solver](cfg, tables, num_steps, remat=remat)
    state_axis = None if shared_state else 0

    def ens_fn(params: dict, state: Optional[State] = None) -> State:
        axes = ({k: 0 for k in params}, state_axis)
        return jax.vmap(solve_fn, in_axes=axes)(params, state)

    return ens_fn


def solve_ensemble(
    cfg: Config,
    tables: Tables,
    params: dict,
    num_steps: Optional[int] = None,
    state: Optional[State] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
    remat: bool = True,
    solver: str = "general",
) -> State:
    """Run an ensemble of solves; one compiled program, optionally
    sharded over a device mesh along the ensemble axis.

    ``params``: dict of stacked parameter leaves, e.g.
    ``{'kappa': (K, G) array}`` for K opacity samples. ``mesh``: a
    1-axis Mesh; the batch axis is sharded over it (K must divide the
    device count evenly or vice versa), each member solving wholly on
    one device with zero collectives. Returns the final State with a
    leading ensemble axis on every leaf.
    """
    if not params:
        raise ValueError("empty params: nothing to batch over")
    k = _batch_size(params)
    ens_fn = make_ensemble_solve(
        cfg, tables, num_steps, remat=remat, shared_state=True,
        solver=solver)
    params = {key: jnp.asarray(v) for key, v in params.items()}

    if mesh is None:
        return jax.jit(ens_fn)(params, state)

    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"ensemble sharding wants a 1-axis mesh, got {mesh.axis_names}")
    axis = mesh.axis_names[0]
    nd = mesh.devices.size
    if k % nd != 0:
        raise ValueError(
            f"ensemble size {k} must divide evenly over {nd} devices")
    pspec = jax.sharding.PartitionSpec(axis)
    sharding = jax.sharding.NamedSharding(mesh, pspec)
    params = {key: jax.device_put(v, sharding) for key, v in params.items()}
    out_spec = jax.sharding.NamedSharding(mesh, pspec)
    fn = jax.jit(
        ens_fn,
        out_shardings=jax.tree_util.tree_map(lambda _: out_spec,
                                             jax.eval_shape(ens_fn, params, state)),
    )
    return fn(params, state)


def observe_phi(cfg: Config, tables: Tables, final: State) -> jnp.ndarray:
    """Scalar-flux observable for a stacked ensemble State: (K, G, N)."""
    wt = np.asarray(tables.wt)
    return jax.vmap(
        lambda e: transport.compute_phi(transport.psi_from_ends(e), wt)
    )(final.ends)


# ---------------------------------------------------------------------------
# Stacked ensembles: K members through the fused perf engines
# ---------------------------------------------------------------------------

_STACK_KEYS = frozenset({"kappa", "rho", "psi_source", "T"})


def _host_member_tables(cfg: Config, base: Tables, member: dict) -> Tables:
    """One member's Tables via the HOST numpy chain.

    Reuses ops/correction.build_correction_tables — the exact builder
    transport.build_tables runs — in pure numpy, so engine setup never
    touches the accelerator (models/transport.Tables host-numpy rule).
    Unlike adjoint.traced_tables, which linearises the
    T-dependence around the deck temperature to stay differentiable, a
    'T' member here gets the full nonlinear Planck-table rebuild —
    exact at every member temperature."""
    unknown = set(member) - _STACK_KEYS
    if unknown:
        raise ValueError(
            f"unknown ensemble parameter(s) {sorted(unknown)}; "
            f"supported: {sorted(_STACK_KEYS)}")
    G = cfg.G

    def arr(x, shape):
        return np.ascontiguousarray(
            np.broadcast_to(np.asarray(x, np.float64), shape))

    kappa = arr(member.get("kappa", base.kappa), (G,))
    rho = arr(member.get("rho", base.rho), (G,))
    T = float(member["T"]) if "T" in member else cfg.T
    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast,
                            cfg.group_bounds_array())
    ct = corr_mod.build_correction_tables(
        T, rho, kappa, grid.e_edge, grid.e_ave, grid.de_ave, grid.edisc)
    if "psi_source" in member:
        psi_source = arr(member["psi_source"], (cfg.M, G))
    elif cfg.use_mg_equilib and "T" in member:
        # The equilibrium boundary source is itself Planckian
        # (solver.cpp:287-315) — rebuild from the member's B/dEB.
        psi_source = corr_mod.equilibrium_psi_source(
            ct.B, ct.dEB, np.asarray(base.mu, np.float64), cfg.V)
    else:
        psi_source = np.asarray(base.psi_source, np.float64)
    return base._replace(
        kappa=kappa, rho=rho, rhokap=rho * kappa, B=ct.B, dEB=ct.dEB,
        cor1=ct.cor1, cor2=ct.cor2, cor3=ct.cor3, psi_source=psi_source)


def stack_ensemble(cfg: Config, tables: Tables, params: dict):
    """K parameter members -> ONE problem with G' = K*G groups.

    Valid because the compiled engines have no runtime cross-group
    coupling: every group interaction (Planck emission, the v/c
    correction's frequency-derivative stencil over group edges) is
    folded into per-(m, g) coefficient planes at setup
    (ops/fast_sweep.build_kind_coeffs), so K independent members stacked
    along the group axis solve EXACTLY their K separate problems — on
    the fused Pallas kernels, at full lane utilisation. The per-member
    correction chain is built at each member's own G before stacking,
    so no cross-member stencil leakage is possible by construction.

    Returns ``(cfg_s, tables_s, K)``; stacked group index g' = k*G + g.
    """
    if not params:
        raise ValueError("empty params: nothing to batch over")
    K = _batch_size(params)
    G, M = cfg.G, cfg.M
    members = [
        _host_member_tables(
            cfg, tables, {k: np.asarray(v)[i] for k, v in params.items()})
        for i in range(K)
    ]

    def cat(name, shape, axis):
        parts = [
            np.broadcast_to(np.asarray(getattr(m, name), np.float64), shape)
            for m in members
        ]
        return np.ascontiguousarray(np.concatenate(parts, axis=axis))

    e_edge = np.asarray(tables.e_edge, np.float64)
    tables_s = tables._replace(
        rhokap=cat("rhokap", (G,), 0), rho=cat("rho", (G,), 0),
        kappa=cat("kappa", (G,), 0), B=cat("B", (G,), 0),
        dEB=cat("dEB", (G,), 0),
        cor1=cat("cor1", (G,), 0), cor2=cat("cor2", (G,), 0),
        cor3=cat("cor3", (G,), 0),
        psi_source=cat("psi_source", (M, G), 1),
        # Shape-consistent placeholders: the engines never read the
        # energy grid (its effect is baked into the leaves above).
        e_edge=np.concatenate([np.tile(e_edge[:-1], K), e_edge[-1:]]),
        e_ave=np.tile(np.asarray(tables.e_ave, np.float64), K),
        de_ave=np.tile(np.asarray(tables.de_ave, np.float64), K),
    )
    cfg_s = cfg.replace(
        G=K * G, have_group_bounds=False, group_bounds=(),
        have_group_absorption_opacities=False, group_kappa=(),
        psi_source=(),
    )
    return cfg_s, tables_s, K


def _unstack(arr, K: int, cfg: Config) -> jnp.ndarray:
    """(M, K*G, N, 2) stacked ends -> (K, M, G, N, 2) member-major."""
    a = jnp.asarray(arr).reshape(cfg.M, K, cfg.G, cfg.N, 2)
    return jnp.moveaxis(a, 1, 0)


def solve_ensemble_stacked(
    cfg: Config,
    tables: Tables,
    params: dict,
    num_steps: Optional[int] = None,
    state: Optional[State] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
    engine: str = "auto",
    **engine_kw,
) -> State:
    """Run the ensemble as ONE stacked problem on the compiled perf
    engines — the high-throughput sibling of :func:`solve_ensemble`.

    Where solve_ensemble vmaps the f64 general solver (differentiable,
    exact), this folds the ensemble into the engines' lane batch
    (Bh' = K * M/2 * G) via :func:`stack_ensemble`: small decks whose
    few rows cannot fill the device get a wider batch once K members
    stack, and engine/mesh semantics are exactly
    parallel.make_multichip_engine's (a mesh 'g' axis shards members
    across chips with zero cross-member communication).

    ``state``: one shared initial State broadcast to every member
    (None -> each member's own equilibrium IC psi = B_k, which is the
    correct per-member condition for 'T' ensembles). 'T' members get
    the full nonlinear per-member table rebuild — exact at every
    temperature, where the vmap path's traced tables are linearised
    around the deck T (exact there only). Returns a State
    whose leaves carry a leading (K,) member axis, at engine precision
    (``dtype=`` in ``engine_kw``: float32 by default, float64 runs the
    f64 XLA engine).
    """
    cfg_s, tables_s, K = stack_ensemble(cfg, tables, params)
    if mesh is None and engine == "fast":
        # make_multichip_engine's 'fast' is the sharded wrapper and
        # needs a real mesh; mesh-less runs want the plain engine.
        from .ops.fast_sweep import FastEngine

        eng = FastEngine(cfg_s, tables_s, **engine_kw)
    else:
        from .parallel import make_multichip_engine

        eng = make_multichip_engine(cfg_s, tables_s, mesh, engine=engine,
                                    **engine_kw)
    if state is None:
        st = eng.init_state()
    else:
        def tile(a):
            return jnp.tile(jnp.asarray(a), (1, K, 1, 1))

        st = eng.from_ends(tile(state.ends), tile(state.prev_ends),
                           tile(state.half_ends))
    st = eng.solve(st, num_steps=num_steps)
    ends = eng.ends_pair(st.e0, st.e1)
    prev = eng.ends_pair(st.p0, st.p1)
    half = eng.ends_pair(st.h0, st.h1)
    return State(
        ends=_unstack(ends, K, cfg),
        prev_ends=_unstack(prev, K, cfg),
        half_ends=_unstack(half, K, cfg),
    )
