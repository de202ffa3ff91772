"""Multi-chip spatial decomposition of the transport solve.

The reference is a single-threaded loop nest with no distribution anywhere
(reference: src/solver.cpp:606-820; the only parallel artifact is an unused
MPICXX hook, CMakeLists.txt:37-43). This module is therefore designed from
the problem structure rather than translated: a 1-D (or 2-D) device mesh

    mesh axes:  'x' — spatial cells N (the scan axis, carries coupling)
                'g' — energy groups G (embarrassingly parallel)

with the whole time loop running inside ONE `shard_map` region so that no
per-step dispatch or resharding occurs.

Cross-shard sweep algorithm (scan-of-scans, no wavefront serialisation):

  1. Each shard runs the local inclusive affine scan over its N/K cells
     (ops/scan.py), giving per-cell prefix maps and the shard's total
     composite map (an (Mh, G)-batched scalar affine pair).
  2. Halo exchange: the upwind shard's last-cell `prev_ends`/`half_ends`
     edge values are `lax.ppermute`d downstream (they appear in the CN and
     BDF2 right-hand sides; the globally-first shard uses the boundary
     value, matching the carry initialisation at solver.cpp:695-697).
  3. Shards `all_gather` the K composite pairs — K·(Mh·G)·2 numbers, tiny —
     and each computes its own incoming carry by composing the maps of the
     shards upstream of it in sweep order (exclusive prefix, O(K) fused
     elementwise ops). mu<0 sweeps compose right-to-left, mu>0 left-to-right.
  4. Every cell's edge pair is reconstructed locally from its incoming
     carry. Result is bitwise-identical (to associativity reordering) to
     the single-device scan.

Cost per sub-step and direction half: one ppermute of 2·(Mh·G) values + one
all_gather of 2·K·(Mh·G) values, both over the device interconnect,
fully overlappable with the local scans of the other half. This is the ≥80% weak-scaling route of
BASELINE.md: communication volume is independent of the local cell count.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import constants
from ..config.config import Config
from ..models import transport
from ..ops import sweep as sweep_mod
from ..ops.scan import affine_scan, apply_prefix
from ..ops.sweep import _shift_in  # shared upwind-shift helper

_C = constants.SPEED_OF_LIGHT


def _compose_affine(x, y):
    """Associative composition of batched affine maps (A, B): apply the
    LEFT (upstream-in-sweep-order) map first, then the right —
    z -> yA*(xA*z + xB) + yB. The binary op of the log-depth composite
    scans here and in sharded_fast.ShardedFastEngine._substep."""
    xA, xB = x
    yA, yB = y
    return yA * xA, yA * xB + yB


def make_mesh(
    n_spatial: int, n_group: int = 1, devices=None
) -> Mesh:
    """A (x=n_spatial, g=n_group) device mesh ('x' innermost: the
    carry-coupled spatial halo passes between neighbouring devices)."""
    if devices is None:
        devices = jax.devices()
    n = n_spatial * n_group
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    arr = np.asarray(devices[:n]).reshape(n_group, n_spatial)
    return Mesh(arr, axis_names=("g", "x"))


def state_shardings(mesh: Mesh) -> transport.State:
    """NamedShardings for a State pytree on `mesh` (N on 'x', G on 'g')."""
    spec = P(None, "g", "x", None)
    s = NamedSharding(mesh, spec)
    return transport.State(ends=s, prev_ends=s, half_ends=s)


# ---------------------------------------------------------------------------
# In-shard sweep with cross-shard carry composition
# ---------------------------------------------------------------------------

def _sweep_half_sharded(
    kind: int,
    e: jnp.ndarray,        # (Mh, Gl, Nl, 2) local block, GLOBAL orientation
    p: jnp.ndarray,
    h: jnp.ndarray,
    S: jnp.ndarray,        # (Mh, Gl, Nl)
    absmu: jnp.ndarray,    # (Mh,)
    rhokap: jnp.ndarray,   # (Gl,)
    bc: jnp.ndarray,       # (Mh, Gl) global boundary intensity (replicated)
    dx,
    ts,
    dt_full,
    *,
    axis: str,
    K: int,                # static size of the spatial mesh axis
    reverse: bool,         # True for the mu<0 half (right-to-left sweep)
) -> jnp.ndarray:
    o_ends, o_cells = sweep_mod.orient_ends, sweep_mod.orient_cells
    if reverse:
        e, p, h, S = o_ends(e), o_ends(p), o_ends(h), o_cells(S)

    k = lax.axis_index(axis)
    # Position of this shard in sweep order (0 = owns the inflow boundary).
    pos = (K - 1 - k) if reverse else k

    # Upwind halo: in sweep order, shard pos receives the last oriented
    # prev/half edge of shard pos-1. In shard-index space data flows
    # k -> k+1 for forward sweeps and k -> k-1 for reverse ones.
    if K > 1:
        if reverse:
            perm = [(i, i - 1) for i in range(1, K)]
        else:
            perm = [(i, i + 1) for i in range(K - 1)]
        prev_halo = lax.ppermute(p[..., -1, 1], axis, perm)
        half_halo = lax.ppermute(h[..., -1, 1], axis, perm)
        is_first = (pos == 0)
        prev_fill = jnp.where(is_first, bc, prev_halo)
        half_fill = jnp.where(is_first, bc, half_halo)
    else:
        prev_fill = bc
        half_fill = bc

    coeffs = sweep_mod.build_coeffs(
        kind, e, p, h, S, absmu, rhokap, bc, dx, ts, dt_full,
        prev_fill=prev_fill, half_fill=half_fill,
    )
    a, b = sweep_mod.carry_terms(coeffs)
    pref_a, pref_b = affine_scan(a, b, axis=-1)

    if K > 1:
        # Exclusive composition of the per-shard total maps in sweep
        # order: one tiny all_gather, then a LOG-DEPTH local
        # associative scan of the affine pairs (compose downstream
        # after upstream). An earlier K-unrolled fold built an O(K)
        # graph with an O(K) serial dependency chain — fine at K=8,
        # hostile to compile time and step latency at pod scale.
        gA = lax.all_gather(pref_a[..., -1], axis)   # (K, Mh, Gl) shard order
        gB = lax.all_gather(pref_b[..., -1], axis)
        if reverse:
            gA, gB = jnp.flip(gA, 0), jnp.flip(gB, 0)   # to sweep order
        inclA, inclB = lax.associative_scan(_compose_affine, (gA, gB),
                                            axis=0)
        exclA = jnp.concatenate([jnp.ones_like(gA[:1]), inclA[:-1]], 0)
        exclB = jnp.concatenate([jnp.zeros_like(gB[:1]), inclB[:-1]], 0)
        eA = lax.dynamic_index_in_dim(exclA, pos, 0, keepdims=False)
        eB = lax.dynamic_index_in_dim(exclB, pos, 0, keepdims=False)
        incoming = eA * bc + eB
    else:
        incoming = bc

    carry = apply_prefix(pref_a, pref_b, incoming)
    carry_in = _shift_in(carry, incoming)
    new = sweep_mod.reconstruct_ends(coeffs, carry_in)
    return o_ends(new) if reverse else new


def _substep_sharded(
    kind: int,
    ends: jnp.ndarray,
    prev_ends: jnp.ndarray,
    half_ends: jnp.ndarray,
    *,
    cfg: Config,
    mu, rhokap, cor1, cor2, cor3, B, psi_source,   # local table leaves
    ts,
    axis: str,
    K: int,
) -> jnp.ndarray:
    """Sharded analogue of transport.substep on local (M, Gl, Nl, 2) blocks."""
    dtype = ends.dtype
    Mh = cfg.M // 2
    absmu = jnp.abs(mu)
    M, Gl, Nl = ends.shape[0], ends.shape[1], ends.shape[2]

    # Source term (local elementwise; matches transport._source_term).
    base = 0.5 * _C * ts * cfg.dx * rhokap * B
    S = jnp.broadcast_to(base[None, :, None], (M, Gl, Nl))
    if cfg.use_correction:
        from ..ops import correction as corr_mod

        psi = transport.psi_from_ends(ends)
        tc = corr_mod.total_correction(
            psi, mu, cor1, cor2, cor3, jnp.asarray(cfg.beta, dtype=dtype)
        )
        S = S + 0.5 * _C * ts * cfg.dx * tc

    neg = slice(0, Mh)
    pos = slice(Mh, cfg.M)

    # Right boundary for the mu<0 half (solver.cpp:641-664).
    if cfg.bc_right_indicator == 1:
        bc_neg = psi_source[neg]
    else:
        bc_neg = jnp.zeros_like(psi_source[neg])

    new_neg = _sweep_half_sharded(
        kind, ends[neg], prev_ends[neg], half_ends[neg], S[neg],
        absmu[neg], rhokap, bc_neg, cfg.dx, ts, cfg.dt,
        axis=axis, K=K, reverse=True,
    )

    # Left boundary for the mu>0 half (solver.cpp:667-691).
    if cfg.bc_left_indicator == 2:
        # Reflective: global cell 0's freshly swept incoming edges — they
        # live on shard 0 of the spatial axis; broadcast via all_gather of
        # one (Mh, Gl) slice.
        left0 = new_neg[:, :, 0, 0]
        if K > 1:
            left0 = lax.all_gather(left0, axis)[0]
        bc_pos = jnp.flip(left0, axis=0)
    else:
        # vacuum(0) falls through to source in the reference (missing
        # break, solver.cpp:667-671) — replicated; source(1) reads it too.
        bc_pos = psi_source[pos]

    new_pos = _sweep_half_sharded(
        kind, ends[pos], prev_ends[pos], half_ends[pos], S[pos],
        absmu[pos], rhokap, bc_pos, cfg.dx, ts, cfg.dt,
        axis=axis, K=K, reverse=False,
    )
    return jnp.concatenate([new_neg, new_pos], axis=0)


# ---------------------------------------------------------------------------
# Sharded solve
# ---------------------------------------------------------------------------

def make_sharded_solve(
    cfg: Config,
    tables: transport.Tables,
    mesh: Mesh,
    num_steps: Optional[int] = None,
    spatial_axis: str = "x",
    group_axis: Optional[str] = "g",
):
    """Build a jitted State -> State running the full time loop on `mesh`.

    N shards over `spatial_axis`, G over `group_axis` (if present in the
    mesh and G is divisible). Everything — all sub-steps of every timestep —
    runs inside one shard_map region.
    """
    n = cfg.max_timesteps if num_steps is None else num_steps
    K = mesh.shape[spatial_axis]
    assert cfg.N % K == 0, f"N={cfg.N} not divisible by spatial shards {K}"

    g_axes: Tuple[str, ...] = ()
    if group_axis is not None and group_axis in mesh.shape:
        gsize = mesh.shape[group_axis]
        if gsize > 1:
            assert cfg.G % gsize == 0, (
                f"G={cfg.G} not divisible by group shards {gsize}"
            )
        g_axes = (group_axis,)

    g_spec = P(*g_axes) if g_axes else P()
    state_spec = transport.State(
        ends=P(None, *g_axes, spatial_axis, None),
        prev_ends=P(None, *g_axes, spatial_axis, None),
        half_ends=P(None, *g_axes, spatial_axis, None),
    )
    table_specs = dict(
        mu=P(), rhokap=g_spec, cor1=g_spec, cor2=g_spec, cor3=g_spec,
        B=g_spec, psi_source=P(None, *g_axes),
    )

    sub = functools.partial(
        _substep_sharded, cfg=cfg, axis=spatial_axis, K=K
    )

    def step_local(state, tb):
        """One full timestep on local blocks (mirrors make_step_fn)."""
        kw = dict(
            mu=tb["mu"], rhokap=tb["rhokap"], cor1=tb["cor1"],
            cor2=tb["cor2"], cor3=tb["cor3"], B=tb["B"],
            psi_source=tb["psi_source"],
        )
        if cfg.ts_method == 1:
            prev = state.ends
            ends = sub(sweep_mod.BE, state.ends, prev, state.half_ends,
                       ts=cfg.dt, **kw)
            return transport.State(ends, prev, state.half_ends)
        if cfg.ts_method == 2:
            prev = state.ends
            ends = sub(sweep_mod.CN, state.ends, prev, state.half_ends,
                       ts=cfg.dt, **kw)
            return transport.State(ends, prev, state.half_ends)
        if cfg.ts_method == 3:
            half_dt = cfg.dt / 2.0
            Mh = cfg.M // 2
            prev = state.ends
            e1 = sub(sweep_mod.BE, state.ends, prev, state.half_ends,
                     ts=half_dt, **kw)
            e2 = sub(sweep_mod.CN, e1, prev, state.half_ends,
                     ts=half_dt, **kw)
            # mu>0 half snapshot = phase-0 BE output (reference quirk,
            # solver.cpp:733 vs 784-787; see models/transport.py).
            if cfg.bdf2_symmetric_half:
                half = e2
            else:
                half = jnp.concatenate([e2[:Mh], e1[Mh:]], axis=0)
            e3 = sub(sweep_mod.BE, e2, prev, half, ts=half_dt, **kw)
            e4 = sub(sweep_mod.BDF, e3, prev, half, ts=half_dt, **kw)
            return transport.State(e4, prev, half)
        raise ValueError(f"unknown ts_method {cfg.ts_method}")

    def run_local(state, tb):
        return lax.fori_loop(0, n, lambda _, s: step_local(s, tb), state)

    tb_in = {k: getattr(tables, k) for k in table_specs}

    run = shard_map(
        run_local,
        mesh=mesh,
        in_specs=(state_spec, {k: table_specs[k] for k in tb_in}),
        out_specs=state_spec,
    )

    @jax.jit
    def solve(state: transport.State) -> transport.State:
        return run(state, tb_in)

    return solve


def solve_sharded(
    cfg: Config,
    tables: transport.Tables,
    state: transport.State,
    mesh: Mesh,
    num_steps: Optional[int] = None,
) -> transport.State:
    """Place `state` on the mesh and run the sharded solve.

    The jitted program is cached per (cfg, tables-id, mesh, n) like
    transport.solve's cache: chunked callers (the checkpoint layer calls
    this once per chunk with identical arguments) must not re-trace the
    shard_map program every chunk. Bounded LRU; entries hold a strong
    reference to their tables so the id key cannot be reused by a
    different live object.
    """
    sh = state_shardings(mesh)
    state = jax.tree_util.tree_map(jax.device_put, state, sh)
    key = (cfg, id(tables), mesh, num_steps)
    hit = _SOLVE_CACHE.get(key)
    if hit is None:
        solve = make_sharded_solve(cfg, tables, mesh, num_steps)
        _SOLVE_CACHE[key] = (solve, tables)
        while len(_SOLVE_CACHE) > _SOLVE_CACHE_MAX:
            _SOLVE_CACHE.pop(next(iter(_SOLVE_CACHE)))
    else:
        solve = hit[0]
        _SOLVE_CACHE[key] = _SOLVE_CACHE.pop(key)  # LRU refresh
    return solve(state)


_SOLVE_CACHE: dict = {}
_SOLVE_CACHE_MAX = 16
