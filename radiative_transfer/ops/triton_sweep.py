"""Fused single-card sweep kernel for the GPU (Pallas, Triton route).

One launch per sub-step reads each state plane once and writes the two
new edge planes once. :class:`FastEngine` does the same sub-step as an
RHS pass, a ``lax.scan`` over in-chunk positions (a loop of small
launches on the GPU), an associative scan over chunk totals and a finish
pass, so its planes make several trips through device memory.

Layout and work split. The kernel reads FastEngine's tiled planes
(chunk, R, nc) with R = 2*Bh rows, flattened to 1-D. One lane is one
(row, chunk column) pair; a block is an (RT, CT) tile of lanes with
consecutive columns, so every load of one in-chunk position t is
contiguous across the block. Each lane walks its chunk's cells in a loop
and keeps the upwind carry (and the one-cell shifted history planes) in
registers. Blocks run in any order on any SM: nothing passes between
them.

Independent blocks. The carry map carry_{j+1} = a*carry_j + b_j has a
constant multiplier a per row (fast_sweep module doc), so upstream
influence decays as a^dist. Two regimes:

* ``lookback`` (truncatable): a lane first re-runs the recurrence over
  the H = 2^npass cells upstream of its chunk, from zero carry (or from
  the true inflow when the look-back reaches cell 0), then sweeps its
  own chunk. npass is the smallest k with a^(2^k)/(1-a) < scan_tol, the
  same contract as the engines' scan_tol everywhere. A reflective
  left boundary needs the mu<0 outflow before the mu>0 half can start,
  so that case takes two launches (mu<0 rows, then mu>0 rows).
* ``two-pass`` (scan_tol=0, or H longer than a chunk): pass 1 writes
  each lane's zero-inflow chunk total; XLA composes the (R, nc) totals
  with a log-depth associative scan; pass 2 sweeps each chunk from its
  exact incoming carry.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import backend
from .fast_sweep import BDF, BE, CN, FastEngine, FlatState
from .scan import _combine

# Coefficient rows packed into one (len, R) operand, in this order.
_COEF = ("Sbase", "c1", "c0", "k_ee", "k_p", "q", "w", "T0", "inv_det", "a")
# State planes each kind reads: (name, whether the shifted copy is used).
_INPUTS = {
    BE: ("e0", "e1"),
    CN: ("e0", "e1", "p0", "p1"),
    BDF: ("e0", "e1", "h0", "h1", "p0", "p1"),
}
_SHIFTED = {BE: (), CN: ("p1",), BDF: ("h1", "p1")}
# A block is an (RT, CT) tile of lanes: at most _BLOCK_COLS consecutive
# chunk columns, _BLOCK_LANES lanes in all, run by _NUM_WARPS warps.
_BLOCK_COLS, _BLOCK_LANES, _NUM_WARPS = 128, 512, 4


def lookback_cells(a_max: float, tol: float) -> int:
    """H = 2^k upstream cells, k the smallest with a^(2^k)/(1-a) < tol
    (the neglected tail's relative weight); 0 means no truncation is
    possible (tol <= 0, or a too close to 1 for any k < 31)."""
    if tol <= 0.0 or not np.isfinite(a_max):
        return 0
    a = min(max(float(a_max), 0.0), 1.0 - 1e-12)
    for k in range(31):
        if a ** (1 << k) / (1.0 - a) < tol:
            return 1 << k
    return 0


def _pow2_at_most(n: int) -> int:
    return 1 << max(0, int(n).bit_length() - 1)


def _sweep_kernel(coef_ref, inflow_ref, inc_ref, *refs, kind, mode, R, nc,
                  chunk, H, t_last, row0, nrows, RT, CT, n_alias):
    """One (RT, CT) tile of lanes; see module doc. ``mode``: 'lookback'
    and 'finish' write (ne0, ne1, mid); 'totals' writes (tot, mid).
    mid is the carry after in-chunk position t_last (the last real cell
    in the last column), tot the carry after the whole chunk. The
    ``n_alias`` refs after the planes only carry an earlier launch's
    output into this launch's outputs and are not read."""
    names = _INPUTS[kind]
    shifted = _SHIFTED[kind]
    n_in = len(names)
    in_refs = dict(zip(names, refs[:n_in]))
    out_refs = refs[n_in + n_alias:]

    r = row0 + pl.program_id(0) * RT + jnp.arange(RT, dtype=jnp.int32)
    i = pl.program_id(1) * CT + jnp.arange(CT, dtype=jnp.int32)
    rmask = r < row0 + nrows
    mask = rmask[:, None] & (i < nc)[None, :]
    page = R * nc
    lane = r[:, None] * nc + i[None, :]

    co = {n: plgpu.load(coef_ref.at[k * R + r], mask=rmask, other=0.0)[:, None]
          for k, n in enumerate(_COEF)}
    zero = jnp.zeros((RT, CT), jnp.float32)

    def load_at(name, t, cshift):
        """Plane ``name`` at in-chunk position t, column i + cshift."""
        m = mask & (i + cshift >= 0)[None, :]
        return plgpu.load(in_refs[name].at[t * page + lane + cshift],
                          mask=m, other=0.0)

    def cell(vals, prev):
        """(r0, r1, b) of one cell from its loaded planes and the
        upwind neighbour's shifted planes."""
        e0, e1 = vals["e0"], vals["e1"]
        S = co["Sbase"] + co["c1"] * (0.5 * (e0 + e1)) + co["c0"]
        k_ee, q, w = co["k_ee"], co["q"], co["w"]
        if kind == BE:
            r0 = S + k_ee * e0
            r1 = S + k_ee * e1
        elif kind == CN:
            r0 = S + k_ee * e0 - q * e1 + w * prev["p1"]
            r1 = S + q * e0 + k_ee * e1
        else:
            h0, h1, p0, p1 = vals["h0"], vals["h1"], vals["p0"], vals["p1"]
            k_p = co["k_p"]
            r0 = (S + k_ee * h0 - 2.0 * w * h1 - k_p * p0 - q * p1
                  + w * (4.0 * prev["h1"] + prev["p1"]))
            r1 = S + 2.0 * w * h0 + k_ee * h1 + q * p0 - k_p * p1
        b = (q * r0 + co["T0"] * r1) * co["inv_det"]
        return r0, r1, b

    def pos(d):
        """(t, column shift) of the cell d positions from the chunk start
        (d may be negative; chunk*ceil(H/chunk + 1) keeps it >= 0)."""
        off = chunk * (H // chunk + 2)
        dd = jnp.asarray(d + off, jnp.int32)
        c = jnp.int32(chunk)
        return lax.rem(dd, c), lax.div(dd, c) - jnp.int32(off // chunk)

    def step_lookback(k, carry):
        c, prev = carry
        t, cs = pos(k - H)
        vals = {n: load_at(n, t, cs) for n in names}
        _, _, b = cell(vals, prev)
        live = (i + cs >= 0)[None, :]
        c = jnp.where(live, co["a"] * c + b, c)
        return c, {n: vals[n] for n in shifted}

    def step_out(t, carry):
        c, prev, mid = carry
        vals = {n: load_at(n, t, 0) for n in names}
        r0, r1, b = cell(vals, prev)
        if mode == "totals":
            c = co["a"] * c + b
        else:
            u = r0 + co["w"] * c
            ne0 = (co["T0"] * u - co["q"] * r1) * co["inv_det"]
            c = (co["q"] * u + co["T0"] * r1) * co["inv_det"]
            plgpu.store(out_refs[0].at[t * page + lane], ne0, mask=mask)
            plgpu.store(out_refs[1].at[t * page + lane], c, mask=mask)
        mid = jnp.where(t == t_last, c, mid)
        return c, {n: vals[n] for n in shifted}, mid

    inflow = plgpu.load(inflow_ref.at[r], mask=rmask, other=0.0)[:, None]
    if mode == "lookback":
        t0, cs0 = pos(-H - 1)
        prev = {n: load_at(n, t0, cs0) for n in shifted}
        # Lanes whose look-back reaches cell 0 start from the true inflow.
        c = jnp.where((i * chunk <= H)[None, :], inflow + zero, zero)
        c, prev = lax.fori_loop(jnp.int32(0), jnp.int32(H), step_lookback,
                                 (c, prev))
    else:
        prev = {n: load_at(n, chunk - 1, -1) for n in shifted}
        if mode == "finish":
            c = plgpu.load(inc_ref.at[lane], mask=mask, other=0.0)
        else:
            c = zero
    c, _, mid = lax.fori_loop(jnp.int32(0), jnp.int32(chunk), step_out,
                               (c, prev, zero))
    if mode == "totals":
        plgpu.store(out_refs[0].at[lane], c, mask=mask)
    plgpu.store(out_refs[-1].at[lane], mid, mask=mask)


class TritonEngine(FastEngine):
    """FastEngine's layout, coefficients and step cycle, with each
    sub-step one fused Pallas-Triton launch (two where the module doc
    says so). float32 only. Builds for the GPU; ``interpret=True`` runs
    the same kernel in the Pallas interpreter (tests)."""

    def __init__(self, cfg, tables, scan_tol: float = 1e-10,
                 chunk: int = 32, interpret: bool = False):
        if not interpret:
            backend.require_gpu("TritonEngine")
        super().__init__(cfg, tables, dtype=jnp.float32, chunk=chunk)
        self.interpret = interpret
        self.R = 2 * self.Bh
        self.CT = min(_BLOCK_COLS, _pow2_at_most(self.nc))
        self.coef = {}
        self.H = {}
        for kind, kc in self.kcs.items():
            self.coef[kind] = np.stack(
                [np.asarray(getattr(kc, n), np.float32).reshape(self.R)
                 for n in _COEF]).reshape(-1)
            H = lookback_cells(float(np.max(kc.a)), scan_tol)
            # A look-back longer than the chunk reads more than the
            # second pass would: compose chunk totals instead.
            self.H[kind] = H if 0 < H <= self.chunk else 0

    def _rows_tile(self, nrows: int) -> int:
        return max(1, min(_pow2_at_most(_BLOCK_LANES // self.CT),
                          1 << max(0, (nrows - 1).bit_length())))

    def _call(self, kind, mode, planes, inflow, inc=None, row0=0,
              nrows=None, alias=None):
        R, nc, chunk = self.R, self.nc, self.chunk
        nrows = R if nrows is None else nrows
        RT = self._rows_tile(nrows)
        page = chunk * R * nc
        f32 = jnp.float32
        if mode == "totals":
            out_shape = [jax.ShapeDtypeStruct((R * nc,), f32)] * 2
        else:
            out_shape = [jax.ShapeDtypeStruct((page,), f32)] * 2 + [
                jax.ShapeDtypeStruct((R * nc,), f32)]
        args = [jnp.asarray(self.coef[kind]), inflow,
                jnp.zeros((1,), f32) if inc is None else inc.reshape(-1)]
        args += [p.reshape(-1) for p in planes]
        # Rows outside [row0, row0+nrows) keep the earlier launch's
        # output: pass it in and write into it.
        alias = () if alias is None else tuple(alias)
        aliases = {len(args) + k: k for k in range(len(alias))}
        args += alias
        kernel = functools.partial(
            _sweep_kernel, kind=kind, mode=mode, R=R, nc=nc, chunk=chunk,
            H=self.H[kind], t_last=self._t_last, row0=row0, nrows=nrows,
            RT=RT, CT=self.CT, n_alias=len(alias))
        outs = pl.pallas_call(
            kernel,
            out_shape=out_shape,
            grid=(pl.cdiv(nrows, RT), pl.cdiv(nc, self.CT)),
            input_output_aliases=aliases,
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
            interpret=self.interpret,
            name=f"rt_sweep_{mode}",
        )(*args)
        return outs

    def substep(self, kind, st: FlatState, kc=None, bc=None):
        if kc is not None or bc is not None:
            raise ValueError("TritonEngine runs the engine's own host "
                             "coefficients only (no traced kc/bc)")
        kcs = self.kcs[kind]
        planes = [getattr(st, n) for n in _INPUTS[kind]]
        shape = planes[0].shape
        s, Bh, nc = kcs.s, self.Bh, self.nc
        init_neg = jnp.asarray(s * self.bc_neg, jnp.float32)
        refl = self.bc_pos_fixed is None
        if self.H[kind]:
            if not refl:
                inflow = jnp.asarray(
                    np.concatenate([s * self.bc_neg, s * self.bc_pos_fixed]),
                    jnp.float32)
                ne0, ne1, _ = self._call(kind, "lookback", planes, inflow)
            else:
                inflow = jnp.concatenate([init_neg, jnp.zeros_like(init_neg)])
                ne0, ne1, mid = self._call(kind, "lookback", planes, inflow,
                                           row0=0, nrows=Bh)
                out_neg = mid.reshape(self.R, nc)[:Bh, self._i_last]
                inflow = jnp.concatenate([init_neg,
                                          s * out_neg[self.refl_flip]])
                ne0, ne1, _ = self._call(kind, "lookback", planes, inflow,
                                         row0=Bh, nrows=Bh,
                                         alias=(ne0, ne1))
            return ne0.reshape(shape), ne1.reshape(shape)

        # Two-pass: chunk totals, composed by XLA, then the finish pass.
        zeros = jnp.zeros((self.R,), jnp.float32)
        tot, mid = self._call(kind, "totals", planes, zeros)
        tot, mid = tot.reshape(self.R, nc), mid.reshape(self.R, nc)
        a = np.asarray(kcs.a, np.float64).reshape(self.R, 1)
        a_chunk = jnp.asarray(np.broadcast_to(a ** self.chunk, (self.R, nc)),
                              jnp.float32)
        inc_a, inc_b = lax.associative_scan(_combine, (a_chunk, tot), axis=-1)
        EXa = jnp.concatenate([jnp.ones_like(inc_a[:, :1]), inc_a[:, :-1]], -1)
        EXb = jnp.concatenate([jnp.zeros_like(inc_b[:, :1]), inc_b[:, :-1]],
                              -1)
        if refl:
            il = self._i_last
            a_t = jnp.asarray(a[:Bh, 0] ** (self._t_last + 1), jnp.float32)
            out_neg = (a_t * (EXa[:Bh, il] * init_neg + EXb[:Bh, il])
                       + mid[:Bh, il])
            bc_pos = s * out_neg[self.refl_flip]
        else:
            bc_pos = jnp.asarray(s * self.bc_pos_fixed, jnp.float32)
        inflow = jnp.concatenate([init_neg, bc_pos])
        inc = EXa * inflow[:, None] + EXb
        ne0, ne1, _ = self._call(kind, "finish", planes, zeros, inc=inc)
        return ne0.reshape(shape), ne1.reshape(shape)
