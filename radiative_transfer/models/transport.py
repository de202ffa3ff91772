"""The thermal radiative-transfer model: state, stepping, solve, diagnostics.

Re-design of the reference Solver (reference: src/solver.cpp,
include/solver.h). Where the reference shares mutable Eigen arrays between
Solver and Correction by reference and sweeps cell-by-cell, this model is
a pure-functional pytree pipeline:

    Config (static)  ->  Tables (frozen device constants)
    State {ends, prev_ends, half_ends}  ->  step  ->  State'

with every sub-step a batched scan-parallel sweep (ops/sweep.py) and the
whole time loop a single compiled `lax.fori_loop`.

Time stepping (reference solve(): src/solver.cpp:590-823):
  * ts_method=1: one Backward-Euler sub-step of dt per step;
  * ts_method=2: prev_ends <- ends, then one Crank-Nicolson dt sub-step;
  * ts_method=3 (BDF2): a 4-phase cycle per full step — commit prev_ends,
    BE(dt/2) predictor, CN(dt/2) corrector (snapshot half_ends), second
    BE(dt/2) predictor, BDF2(dt/2) corrector (solver.cpp:594-598,620-625,
    700-811). The reference counts each phase as one "timestep"; here one
    full step runs all 4 phases, and max_timesteps counts full steps.

Boundary conditions (solver.cpp:639-692):
  * mu<0 (right boundary): 0 vacuum -> 0; 2 reflective -> 0 (reference
    leaves it unimplemented); 1 source -> psi_source.
  * mu>0 (left boundary): 0 vacuum falls through to the source value in
    the reference (missing break, solver.cpp:667-671) — replicated, which
    is benign because psi_source defaults to zeros; 1 source ->
    psi_source; 2 reflective -> the just-updated incoming edge of the
    mirrored negative direction, ends(m_neg, g, 0, 0) with
    m_neg = M/2-1-(i-M/2). Negative directions therefore sweep first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..config.config import Config
from ..ops import correction as corr_mod
from ..ops import sweep as sweep_mod
from ..ops.groups import GroupGrid, build_group_grid
from ..ops.quadrature import gauss_legendre

_C = constants.SPEED_OF_LIGHT


class Tables(NamedTuple):
    """Frozen per-problem constants.

    HOST-side numpy arrays by design: every leaf is tiny ((M,) / (G,)
    shaped), consumed inside jitted step functions where it embeds as an
    HLO literal. Keeping them on the host means setup never copies
    between host and device: converting a device array back with
    np.asarray (or letting jit lower a captured device array, which
    fetches it) is a device->host read. Rule: setup computes on the
    host, only sweep-state planes live on the device."""

    mu: jnp.ndarray           # (M,) ascending, negative first
    wt: jnp.ndarray           # (M,) sum = 4*pi
    rhokap: jnp.ndarray       # (G,) rho * kappa
    rho: jnp.ndarray          # (G,)
    kappa: jnp.ndarray        # (G,)
    B: jnp.ndarray            # (G,) Planck integrals (jk/cm^2-sh)
    dEB: jnp.ndarray          # (G,)
    cor1: jnp.ndarray         # (G,)
    cor2: jnp.ndarray         # (G,)
    cor3: jnp.ndarray         # (G,)
    psi_source: jnp.ndarray   # (M, G)
    e_edge: jnp.ndarray       # (G+1,)
    e_ave: jnp.ndarray        # (G,)
    de_ave: jnp.ndarray       # (G,)


class State(NamedTuple):
    """Sweep state. psi is derived: psi = 0.5*(ends[...,0]+ends[...,1])."""

    ends: jnp.ndarray       # (M, G, N, 2)
    prev_ends: jnp.ndarray  # (M, G, N, 2) level-n edges (BDF2 history)
    half_ends: jnp.ndarray  # (M, G, N, 2) level-(n+1/2) edges


def psi_from_ends(ends: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (ends[..., 0] + ends[..., 1])


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

def build_tables(cfg: Config, dtype=jnp.float64) -> Tuple[Tables, GroupGrid, corr_mod.CorrectionTables]:
    """Host-side precomputation of every T-frozen quantity."""
    mu, wt = gauss_legendre(cfg.M, constants.FOUR_PI)
    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast, cfg.group_bounds_array())

    kappa = cfg.group_kappa_array()
    if kappa is None:
        kappa = np.full(cfg.G, cfg.kappa_grey, dtype=np.float64)
    rho = np.full(cfg.G, cfg.rho, dtype=np.float64)

    ct = corr_mod.build_correction_tables(
        cfg.T, rho, kappa, grid.e_edge, grid.e_ave, grid.de_ave, grid.edisc
    )

    if cfg.use_mg_equilib:
        # Equilibrium (comoving Planckian + O(beta) Doppler) boundary
        # sources override the deck's psi_source (solver.cpp:600-604).
        psi_source = corr_mod.equilibrium_psi_source(ct.B, ct.dEB, mu, cfg.V)
    else:
        psi_source = cfg.psi_source_array()

    as_dt = lambda x: np.asarray(x, dtype=np.dtype(dtype))  # noqa: E731
    tables = Tables(
        mu=as_dt(mu),
        wt=as_dt(wt),
        rhokap=as_dt(rho * kappa),
        rho=as_dt(rho),
        kappa=as_dt(kappa),
        B=as_dt(ct.B),
        dEB=as_dt(ct.dEB),
        cor1=as_dt(ct.cor1),
        cor2=as_dt(ct.cor2),
        cor3=as_dt(ct.cor3),
        psi_source=as_dt(psi_source),
        e_edge=as_dt(grid.e_edge),
        e_ave=as_dt(grid.e_ave),
        de_ave=as_dt(grid.de_ave),
    )
    return tables, grid, ct


def initial_state(cfg: Config, tables: Tables, dtype=jnp.float64) -> State:
    """psi = ends = B_g everywhere (reference: src/solver.cpp:165-181).
    prev/half start equal to ends (first committed before first read)."""
    ends = jnp.broadcast_to(
        tables.B.astype(dtype)[None, :, None, None], (cfg.M, cfg.G, cfg.N, 2)
    )
    ends = jnp.asarray(ends, dtype=dtype)
    return State(ends=ends, prev_ends=ends, half_ends=ends)


def validate_tables(cfg: Config, tables_host: corr_mod.CorrectionTables) -> bool:
    """Per-step validation of the reference (solver.cpp:609-612) — here the
    tables are step-invariant so one setup-time check is equivalent."""
    kappa = cfg.group_kappa_array()
    if kappa is None:
        kappa = np.full(cfg.G, cfg.kappa_grey)
    ok_p = corr_mod.validate_planck_integrals(tables_host.B, tables_host.dBdT, cfg.T)
    ok_e = corr_mod.validate_emission(kappa, tables_host.B, cfg.T, cfg.kappa_grey)
    return ok_p and ok_e


# ---------------------------------------------------------------------------
# Sub-steps
# ---------------------------------------------------------------------------

def _source_term(
    cfg: Config, tables: Tables, ends: jnp.ndarray, ts, dtype
) -> jnp.ndarray:
    """S = 0.5*c*ts*dx*rho*kappa*B_g (+ 0.5*c*ts*dx*total_correction), the
    common Planckian + correction RHS block of every integrator
    (e.g. solver.cpp:337-341)."""
    M, G, N = ends.shape[0], ends.shape[1], ends.shape[2]
    base = 0.5 * _C * ts * cfg.dx * tables.rhokap * tables.B  # (G,)
    S = jnp.broadcast_to(base[None, :, None], (M, G, N))
    if cfg.use_correction:
        psi = psi_from_ends(ends)
        tc = corr_mod.total_correction(
            psi, tables.mu, tables.cor1, tables.cor2, tables.cor3,
            jnp.asarray(cfg.beta, dtype=dtype),
        )
        S = S + 0.5 * _C * ts * cfg.dx * tc
    return S


def _boundary_neg(cfg: Config, tables: Tables, Mh: int) -> jnp.ndarray:
    """Right-boundary intensities for the mu<0 half (solver.cpp:641-664)."""
    if cfg.bc_right_indicator == 1:
        return tables.psi_source[:Mh]
    # vacuum (0) and "reflective" (2, unimplemented in the reference) -> 0
    return jnp.zeros_like(tables.psi_source[:Mh])


def _boundary_pos(
    cfg: Config, tables: Tables, Mh: int, new_neg_ends: jnp.ndarray
) -> jnp.ndarray:
    """Left-boundary intensities for the mu>0 half (solver.cpp:667-691)."""
    if cfg.bc_left_indicator == 2:
        # reflective: ends(m_neg, g, 0, 0) of the just-swept negative half,
        # with m_neg = M/2-1-(i-M/2) — i.e. the direction order reversed.
        left_in = new_neg_ends[:, :, 0, 0]          # (Mh, G)
        return jnp.flip(left_in, axis=0)
    # vacuum (0) FALLS THROUGH to source in the reference (missing break,
    # solver.cpp:667-671); source (1) reads psi_source. Both replicated.
    return tables.psi_source[Mh:]


def substep(
    kind: int,
    cfg: Config,
    tables: Tables,
    ends: jnp.ndarray,
    prev_ends: jnp.ndarray,
    half_ends: jnp.ndarray,
    ts: float,
) -> jnp.ndarray:
    """One sub-step over ALL directions; returns new ends (M, G, N, 2).

    Negative directions sweep first so a reflective left boundary sees
    their freshly updated incoming edges, matching the reference's
    direction-ordered loop (solver.cpp:628, 679-683).
    """
    dtype = ends.dtype
    Mh = cfg.M // 2
    absmu = jnp.abs(tables.mu)
    S = _source_term(cfg, tables, ends, ts, dtype)

    o_ends, o_cells = sweep_mod.orient_ends, sweep_mod.orient_cells

    def run_half(sl, oriented: bool, bc):
        e, p, h, s = ends[sl], prev_ends[sl], half_ends[sl], S[sl]
        if oriented:
            e, p, h, s = o_ends(e), o_ends(p), o_ends(h), o_cells(s)
        new = sweep_mod.sweep_oriented(
            kind, e, p, h, s, absmu[sl], tables.rhokap, bc,
            cfg.dx, ts, cfg.dt,
        )
        return o_ends(new) if oriented else new

    neg = slice(0, Mh)
    pos = slice(Mh, cfg.M)
    new_neg = run_half(neg, True, _boundary_neg(cfg, tables, Mh))
    new_pos = run_half(pos, False, _boundary_pos(cfg, tables, Mh, new_neg))
    return jnp.concatenate([new_neg, new_pos], axis=0)


# ---------------------------------------------------------------------------
# Full steps and solve
# ---------------------------------------------------------------------------

def make_step_fn(cfg: Config, tables: Tables):
    """Build the per-full-timestep transition function State -> State."""
    sub = functools.partial(substep, cfg=cfg, tables=tables)

    if cfg.ts_method == 1:

        def step(state: State) -> State:
            prev = state.ends
            ends = sub(sweep_mod.BE, ends=state.ends, prev_ends=prev,
                       half_ends=state.half_ends, ts=cfg.dt)
            return State(ends=ends, prev_ends=prev, half_ends=state.half_ends)

    elif cfg.ts_method == 2:

        def step(state: State) -> State:
            prev = state.ends  # committed every step (solver.cpp:620-625)
            ends = sub(sweep_mod.CN, ends=state.ends, prev_ends=prev,
                       half_ends=state.half_ends, ts=cfg.dt)
            return State(ends=ends, prev_ends=prev, half_ends=state.half_ends)

    elif cfg.ts_method == 3:
        half_dt = cfg.dt / 2.0

        Mh = cfg.M // 2

        def step(state: State) -> State:
            # Phase 0: commit prev, BE(dt/2) predictor.
            prev = state.ends
            e1 = sub(sweep_mod.BE, ends=state.ends, prev_ends=prev,
                     half_ends=state.half_ends, ts=half_dt)
            # Phase 1: CN(dt/2) corrector; snapshot half_ends. The
            # reference's snapshot copy executes only in the mu<0 branch
            # of the cell loop (solver.cpp:733; absent at 784-787), so
            # the mu>0 half of the snapshot holds the phase-0 BE output —
            # replicated (verified against the reference binary).
            e2 = sub(sweep_mod.CN, ends=e1, prev_ends=prev,
                     half_ends=state.half_ends, ts=half_dt)
            if cfg.bdf2_symmetric_half:
                half = e2  # corrected symmetric snapshot (opt-in)
            else:
                half = jnp.concatenate([e2[:Mh], e1[Mh:]], axis=0)
            # Phase 2: second BE(dt/2) predictor.
            e3 = sub(sweep_mod.BE, ends=e2, prev_ends=prev,
                     half_ends=half, ts=half_dt)
            # Phase 3: BDF2 corrector (dt/2 relaxation, full-dt transport).
            e4 = sub(sweep_mod.BDF, ends=e3, prev_ends=prev,
                     half_ends=half, ts=half_dt)
            return State(ends=e4, prev_ends=prev, half_ends=half)

    else:
        raise ValueError(f"unknown ts_method {cfg.ts_method}")

    return step


def solve(
    cfg: Config,
    tables: Tables,
    state: State,
    num_steps: Optional[int] = None,
) -> State:
    """Run `num_steps` full timesteps (default cfg.max_timesteps), jitted.

    The jitted runner is cached per (cfg, tables-id, n): callers looping
    over solves (chunked/checkpointed drivers) must not re-trace the
    identical program every call. The cache is a small FIFO (so a
    parameter sweep building fresh tables per solve does not pin every
    Tables pytree + executable forever) and each entry holds a strong
    reference to its tables object (so the id key can never be reused
    by a different live object).
    """
    n = cfg.max_timesteps if num_steps is None else num_steps
    key = (cfg, id(tables), n)
    hit = _SOLVE_CACHE.get(key)
    if hit is None:
        step = make_step_fn(cfg, tables)

        @jax.jit
        def run(state: State) -> State:
            return jax.lax.fori_loop(0, n, lambda _, s: step(s), state)

        _SOLVE_CACHE[key] = (run, tables)
        while len(_SOLVE_CACHE) > _SOLVE_CACHE_MAX:
            _SOLVE_CACHE.pop(next(iter(_SOLVE_CACHE)))
    else:
        run = hit[0]
        _SOLVE_CACHE[key] = _SOLVE_CACHE.pop(key)  # LRU refresh
    return run(state)


_SOLVE_CACHE: dict = {}
_SOLVE_CACHE_MAX = 16


# ---------------------------------------------------------------------------
# Diagnostics (reference: src/solver.cpp:191-284, 826-850)
# ---------------------------------------------------------------------------

def _einsum(spec, *operands):
    """Angle sums at full precision: on a GPU an f32 contraction may
    otherwise run in TF32 (about three decimal digits)."""
    return jnp.einsum(spec, *operands, precision=jax.lax.Precision.HIGHEST)


def compute_phi(psi: jnp.ndarray, wt: jnp.ndarray) -> jnp.ndarray:
    """phi(g, n) = sum_m w_m psi(m, g, n) (solver.cpp:191-204)."""
    return _einsum("m,mgn->gn", wt, psi)


def compute_phi_plus(psi: jnp.ndarray, wt: jnp.ndarray) -> jnp.ndarray:
    """Positive-direction partial integral (solver.cpp:207-221)."""
    Mh = psi.shape[0] // 2
    return _einsum("m,mgn->gn", wt[Mh:], psi[Mh:])


def compute_F(psi: jnp.ndarray, mu: jnp.ndarray, wt: jnp.ndarray) -> jnp.ndarray:
    """F(g, n) = sum_m mu_m w_m psi(m, g, n) (solver.cpp:224-237)."""
    return _einsum("m,mgn->gn", mu * wt, psi)


def compute_balance_parts(
    cfg: Config, tables: Tables, ends: jnp.ndarray, phi: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-group (sources, sinks, balance) using edge currents, absorption
    and emission (solver.cpp:240-284). Mirrors the reference edge choice:
    the mu<0 current at the right boundary uses the LEFT edge of cell N-1.
    sources/sinks are returned so drivers can echo the reference's
    console lines (solver.cpp:277-282)."""
    Mh = cfg.M // 2
    mu, wt = tables.mu, tables.wt
    muw_neg, muw_pos = (mu * wt)[:Mh], (mu * wt)[Mh:]

    j_half_minus = -_einsum("m,mg->g", muw_neg, ends[:Mh, :, 0, 0])
    jN_half_minus = -_einsum("m,mg->g", muw_neg, ends[:Mh, :, -1, 0])
    j_half_plus = _einsum("m,mg->g", muw_pos, ends[Mh:, :, 0, 1])
    jN_half_plus = _einsum("m,mg->g", muw_pos, ends[Mh:, :, -1, 1])

    acT4 = constants.AC * cfg.T**4
    absorption = tables.rhokap * jnp.sum(phi, axis=1) * cfg.dx
    emission = tables.rhokap * acT4 * cfg.N * cfg.dx

    sources = j_half_plus + jN_half_minus + emission
    sinks = jN_half_plus + j_half_minus + absorption
    return sources, sinks, jnp.abs(sinks - sources) / sources


def compute_balance(
    cfg: Config, tables: Tables, ends: jnp.ndarray, phi: jnp.ndarray
) -> jnp.ndarray:
    """Per-group |sinks - sources| / sources (solver.cpp:240-284)."""
    return compute_balance_parts(cfg, tables, ends, phi)[2]


def compute_group_ends(
    cfg: Config, tables: Tables, ends: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Boundary spectra: summed incoming-edge intensities normalised by
    (group width * c) (solver.cpp:826-850)."""
    Mh = cfg.M // 2
    left = jnp.sum(ends[:Mh, :, 0, 0], axis=0) / (tables.de_ave * _C)
    right = jnp.sum(ends[Mh:, :, -1, 1], axis=0) / (tables.de_ave * _C)
    return left, right


class SolveResult(NamedTuple):
    psi: jnp.ndarray        # (M, G, N)
    phi: jnp.ndarray        # (G, N)
    phi_plus: jnp.ndarray   # (G, N)
    F: jnp.ndarray          # (G, N)
    balance: jnp.ndarray    # (G,)
    left_ends: jnp.ndarray  # (G,)
    right_ends: jnp.ndarray # (G,)
    state: State
    # Balance components, kept for the reference's per-group console
    # echo (solver.cpp:277-282); None on legacy constructions.
    sources: Optional[jnp.ndarray] = None  # (G,)
    sinks: Optional[jnp.ndarray] = None    # (G,)


def result_from_ends(cfg: Config, tables: Tables, ends: jnp.ndarray,
                     state: Optional[State] = None) -> SolveResult:
    """Post-processing diagnostics from a final `ends` array — the
    main.cc:105-133 output set, shared by every engine path (the fast /
    triton / multi-device engines produce ends in their own layouts and
    convert; diagnostics run in f64)."""
    ends = jnp.asarray(ends, jnp.float64)
    wt = jnp.asarray(tables.wt, jnp.float64)
    mu = jnp.asarray(tables.mu, jnp.float64)
    psi = psi_from_ends(ends)
    phi = compute_phi(psi, wt)
    left_ends, right_ends = compute_group_ends(cfg, tables, ends)
    sources, sinks, balance = compute_balance_parts(cfg, tables, ends, phi)
    return SolveResult(
        psi=psi, phi=phi,
        phi_plus=compute_phi_plus(psi, wt),
        F=compute_F(psi, mu, wt),
        balance=balance,
        left_ends=left_ends, right_ends=right_ends, state=state,
        sources=sources, sinks=sinks,
    )


def run_problem(cfg: Config, dtype=jnp.float64,
                num_steps: Optional[int] = None,
                engine: str = "general") -> SolveResult:
    """End-to-end: setup -> solve -> diagnostics (the main() flow,
    reference: src/main.cc:60-136).

    engine='general' (default) runs this module's readable f64-capable
    path; engine='auto' routes through the shared engine selection
    (parallel.make_multichip_engine at `dtype`; diagnostics in f64);
    engine='fast' pins the tiled XLA engine at `dtype`."""
    tables, _, ct = build_tables(cfg, dtype=dtype)
    if cfg.include_validation:
        assert validate_tables(cfg, ct), "Invalid Correction Terms"
    if engine != "general":
        if engine == "fast":
            from ..ops.fast_sweep import FastEngine

            eng = FastEngine(cfg, tables, dtype=dtype)
        elif engine == "auto":
            from ..parallel import make_multichip_engine

            eng = make_multichip_engine(cfg, tables, None, dtype=dtype)
        else:
            raise ValueError(f"unknown engine {engine!r} "
                             "(general/fast/auto)")
        ends = jnp.asarray(eng.ends(eng.solve(num_steps=num_steps)),
                           jnp.float64)
        return result_from_ends(cfg, tables, ends)
    state = initial_state(cfg, tables, dtype=dtype)
    state = solve(cfg, tables, state, num_steps)

    psi = psi_from_ends(state.ends)
    phi = compute_phi(psi, tables.wt)
    phi_plus = compute_phi_plus(psi, tables.wt)
    F = compute_F(psi, tables.mu, tables.wt)
    sources, sinks, balance = compute_balance_parts(
        cfg, tables, state.ends, phi)
    left_ends, right_ends = compute_group_ends(cfg, tables, state.ends)
    return SolveResult(
        psi=psi, phi=phi, phi_plus=phi_plus, F=F, balance=balance,
        left_ends=left_ends, right_ends=right_ends, state=state,
        sources=sources, sinks=sinks,
    )
