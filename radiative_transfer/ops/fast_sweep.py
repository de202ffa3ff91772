"""Fast fused sweep engine: tiled layout + constant-coefficient scan.

This is the performance path of the framework (the general path lives in
ops/sweep.py + models/transport.py and is kept as the readable reference
implementation; tests assert the two agree to roundoff).

Design decisions (why this differs from the reference's loop nest,
src/solver.cpp:628-811):

* **Tiled chunk-major layout.** All sweep state lives in planes of shape
  (chunk, 2, Bh, nc) — [in-chunk cell position, direction half, Mh*G
  flattened batch, chunk index], where N = nc*chunk and the mu<0 half is
  stored N-reversed/edge-swapped ("sweep order", so no jnp.flip runs in
  the time loop). Global cell j = i*chunk + t maps to [t, h, :, i]. The
  in-chunk scan over t slices contiguous (2, Bh, nc) pages with NO
  transpose — a scan over the naive (batch, N) layout costs two
  full-array transposes per sub-step — and the GPU kernel
  (ops/triton_sweep.py) reads one page position contiguously across
  chunk columns.
* **Constant-coefficient recurrence.** The per-cell affine carry map
  carry_j = a*carry_{j-1} + b_j has spatially CONSTANT a (the material is
  uniform per group in this problem class: kappa/rho are (G,) vectors,
  SURVEY §2; reference solver.cpp:132-134), so the scan carries only b
  and every prefix a-power is a closed-form cumulative product of tiny
  (chunk,)- or (nc,)-sized arrays.
* **Boundary-fill folding.** The first cell's upwind prev/half history
  fills (solver.cpp:695-697 initialises all three carries to the boundary
  value) enter the recurrence linearly, so they fold into an effective
  inflow multiplier s = 1 (BE), 2 (CN), 6 (BDF2 corrector) on the
  boundary intensity. Every b coefficient is then independent of the
  boundary value — which lets BOTH direction halves (including a
  reflective left boundary, whose inflow is the mu<0 half's outflow,
  solver.cpp:679-683) batch into ONE fused build+scan: the mu>0 inflow is
  recovered from the mu<0 half's total composite after the shared scan.
* **Two-level scan.** lax.scan over the in-chunk position t (sequential
  depth `chunk`, each step a full-width elementwise op over 2*Bh*nc
  elements; compile time O(1) in N); cross-chunk composition is a log-depth
  associative scan over the nc chunk totals.

Numerics: a ∈ (0, 1) strictly, so all powers decay; optically-thick
groups (LLNL deck, kappa up to 1e6) underflow a^t toward 0, which is the
physically correct exponential loss of upwind influence.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import constants
from ..config.config import Config
from .scan import _combine

_C = constants.SPEED_OF_LIGHT

BE, CN, BDF = 1, 2, 3


class FlatState(NamedTuple):
    """Tiled sweep state; each plane is (chunk, 2, Bh, nc). See module doc."""

    e0: jnp.ndarray  # oriented upwind edge
    e1: jnp.ndarray  # oriented downwind edge (the carried one)
    p0: jnp.ndarray
    p1: jnp.ndarray
    h0: jnp.ndarray
    h1: jnp.ndarray


class KindCoeffs(NamedTuple):
    """Per-substep-kind spatially-constant coefficients, (1, 2, Bh, 1)."""

    w: jnp.ndarray
    T0: jnp.ndarray
    q: jnp.ndarray
    inv_det: jnp.ndarray
    a: jnp.ndarray          # carry multiplier q*w/det
    s: float                # boundary-fill inflow multiplier
    Sbase: jnp.ndarray      # 0.5*c*ts*dx*rho*kappa*B
    c1: jnp.ndarray         # correction: S += c1*psi + c0 (pre-scaled)
    c0: jnp.ndarray
    k_ee: jnp.ndarray       # BE: 0.5*dx; CN: 0.5*(cC*dx-w); BDF: 0.5*(cC*dx-4w)
    k_p: jnp.ndarray        # BDF: 0.5*(w + cD*dx)
    ts: float


def _to_plane(x: np.ndarray, Mh: int, G: int) -> np.ndarray:
    """(M, G) -> (2, Mh*G): split direction halves, flatten (Mh, G)."""
    return x.reshape(2, Mh, G).reshape(2, Mh * G)


def _pick_chunk(N: int, chunk: int, pad: bool = True) -> Tuple[int, int]:
    """(chunk, N_pad): in-chunk length and padded cell count.

    Prefers an exact divisor of N near the requested size (no padding).
    When N has no usable power-of-two divisor (odd/prime N), PADS to the
    next chunk multiple instead of degrading: chunk=1 would collapse the
    two-level scan into a sequential lax.scan over all N cells (VERDICT
    r3 #7 — a silent ~100x cliff). Pad cells sit at the sweep-DOWNSTREAM
    end of each half, so no real cell's result can change (the sweep
    recurrence only flows downstream); the reflective outflow is read
    positionally at the last REAL cell (FastEngine.inflow).

    ``pad=False`` pins N_pad == N unconditionally (any-divisor fallback):
    the engines that reuse FastEngine purely for LAYOUT and coefficients
    (Pallas/df/halo/fused/sharded wrappers, which manage their own N
    decompositions and exchange planes of exactly N cells) must never
    see a padded width."""
    if N % chunk == 0 and N // chunk >= 2:
        return chunk, N
    c = 1
    while N % (c * 2) == 0 and c * 2 <= max(16, N // 4):
        c *= 2
    if not pad or c >= min(16, chunk):
        return c, N
    half_pow2 = 1 << max(0, (max(N // 4, 1)).bit_length() - 1)
    c = max(min(16, N), min(chunk, half_pow2))
    n_pad = -(-N // c) * c
    return c, n_pad


def _shift1_tiled(x: jnp.ndarray) -> jnp.ndarray:
    """Shift one cell downwind along N in tiled layout (zero boundary fill;
    the true boundary contribution is folded into the effective inflow).

    new[t, ..., i] = x[t-1, ..., i] for t>0; new[0, ..., i] = x[-1, ..., i-1].
    """
    row0 = jnp.concatenate(
        [jnp.zeros_like(x[:1, ..., :1]), x[-1:, ..., :-1]], axis=-1
    )
    return jnp.concatenate([row0, x[:-1]], axis=0)


def _kind_coeff_fields(cfg: Config, kind: int, ts: float, mu, rk,
                       B, cor1, cor2, cor3) -> dict:
    """The coefficient algebra shared by the host and traced builds
    (identical to ops/sweep.build_coeffs, i.e. reference
    solver.cpp:319-587). ``mu`` is always host numpy (the quadrature is
    never a differentiable parameter); ``rk``/``B``/``cor*`` may be jnp
    tracers — every op below broadcasts np with tracers transparently,
    and the np-only constructors (zeros_like/full_like) are applied only
    to the always-host ``w``."""
    G = cfg.G
    absmu = np.abs(mu)[:, None] * np.ones((1, G))         # (M, G)
    dx = cfg.dx

    if kind == BE:
        w = _C * ts * absmu
        T0 = 0.5 * ((1.0 + _C * ts * rk) * dx + w)
        k_ee = np.full_like(w, 0.5 * dx)
        k_p = np.zeros_like(w)
        s = 1.0
    elif kind == CN:
        tv = 0.5 * _C * ts * rk
        w = 0.5 * _C * ts * absmu
        T0 = 0.5 * ((1.0 + tv) * dx + w)
        k_ee = 0.5 * ((1.0 - tv) * dx - w)
        k_p = np.zeros_like(w)
        s = 2.0
    elif kind == BDF:
        tv = _C * rk * ts / 6.0
        w = _C * absmu * cfg.dt / 6.0   # FULL dt (solver.cpp:501)
        T0 = 0.5 * ((1.0 + tv) * dx + w)
        k_ee = 0.5 * ((1.0 - 4.0 * tv) * dx - 4.0 * w)
        k_p = 0.5 * (w + tv * dx)
        s = 6.0
    else:
        raise ValueError(f"unknown sub-step kind {kind}")

    q = 0.5 * w
    det = T0 * T0 + q * q
    a = q * w / det

    Sbase = 0.5 * _C * ts * dx * rk * B[None, :]          # (M, G)
    sc = 0.5 * _C * ts * dx
    if cfg.use_correction:
        mb = mu[:, None] * cfg.beta                        # (M, 1), signed
        c1 = sc * (cor1[None, :] * mb)
        c0 = sc * (cor2[None, :] * mb - cor3[None, :] * mb * mb)
    else:
        c1 = np.zeros((cfg.M, G))
        c0 = np.zeros((cfg.M, G))

    return dict(w=w, T0=T0, q=q, inv_det=1.0 / det, a=a, s=s,
                Sbase=Sbase, c1=c1, c0=c0, k_ee=k_ee, k_p=k_p)


def _fields_to_coeffs(fields: dict, ts: float, plane) -> KindCoeffs:
    return KindCoeffs(
        w=plane(fields["w"]), T0=plane(fields["T0"]), q=plane(fields["q"]),
        inv_det=plane(fields["inv_det"]), a=plane(fields["a"]),
        s=float(fields["s"]), Sbase=plane(fields["Sbase"]),
        c1=plane(fields["c1"]), c0=plane(fields["c0"]),
        k_ee=plane(fields["k_ee"]), k_p=plane(fields["k_p"]), ts=float(ts),
    )


def build_kind_coeffs(
    cfg: Config, tables, kind: int, ts: float, dtype
) -> KindCoeffs:
    """Host-side build of the constant coefficient planes for one sub-step
    kind."""
    Mh, G = cfg.M // 2, cfg.G
    mu = np.asarray(tables.mu, dtype=np.float64)          # (M,) ascending
    rhokap = np.asarray(tables.rhokap, dtype=np.float64)  # (G,)
    rk = rhokap[None, :] * np.ones((cfg.M, 1))            # (M, G)
    fields = _kind_coeff_fields(
        cfg, kind, ts, mu, rk,
        np.asarray(tables.B, dtype=np.float64),
        np.asarray(tables.cor1, dtype=np.float64),
        np.asarray(tables.cor2, dtype=np.float64),
        np.asarray(tables.cor3, dtype=np.float64),
    )

    def plane(x):
        # Host numpy, not device: these (1, 2, Bh, 1) constants are closed
        # over by jitted step functions — a captured device array would be
        # fetched (D2H) at lowering (see models/transport.Tables).
        return np.asarray(
            _to_plane(np.broadcast_to(np.asarray(x, np.float64),
                                      (cfg.M, G)), Mh, G)[None, :, :, None],
            dtype=np.dtype(dtype),
        )

    return _fields_to_coeffs(fields, ts, plane)


def build_kind_coeffs_traced(
    cfg: Config, tables, kind: int, ts: float, dtype=jnp.float64
) -> KindCoeffs:
    """Traced (differentiable) twin of build_kind_coeffs: same algebra
    (_kind_coeff_fields), but the per-group leaves of ``tables`` may be
    jnp tracers (adjoint.traced_tables output), so the returned planes
    carry the parameter dependence through the engine's step algebra.
    Only for use INSIDE a traced function (adjoint.make_diff_solve_fast)
    — the host-numpy closure rule of build_kind_coeffs does not apply to
    jit arguments."""
    Mh, G = cfg.M // 2, cfg.G
    mu = np.asarray(tables.mu, dtype=np.float64)
    rk = jnp.asarray(tables.rhokap, jnp.float64)[None, :] \
        * np.ones((cfg.M, 1))
    fields = _kind_coeff_fields(
        cfg, kind, ts, mu, rk,
        jnp.asarray(tables.B, jnp.float64),
        jnp.asarray(tables.cor1, jnp.float64),
        jnp.asarray(tables.cor2, jnp.float64),
        jnp.asarray(tables.cor3, jnp.float64),
    )

    def plane(x):
        x = jnp.broadcast_to(jnp.asarray(x, jnp.float64), (cfg.M, G))
        return jnp.asarray(_to_plane(x, Mh, G)[None, :, :, None], dtype)

    return _fields_to_coeffs(fields, ts, plane)


def _refl_flip_indices(Mh: int, G: int) -> np.ndarray:
    """Flat gather for the reflective left boundary: positive-half
    direction i takes the mu<0 outflow of direction Mh-1-i, same group
    (m_neg = M/2-1-(i-M/2), solver.cpp:679-683)."""
    idx = np.arange(Mh * G).reshape(Mh, G)
    return idx[::-1].reshape(-1)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class FastEngine:
    """Compiled-friendly fused solver for one (Config, Tables) problem.

    ``chunk`` is the in-chunk scan length, i.e. the number of sequential
    page steps per sub-step. On an H100, 64 beat 256 and 1024 at both
    benchmark shapes, f32 and f64 (PERF.md)."""

    def __init__(self, cfg: Config, tables, dtype=jnp.float32,
                 chunk: int = 64, unroll: int = 4, pad: bool = True):
        self.cfg = cfg
        self.tables = tables
        self.dtype = dtype
        self.chunk, self.N_pad = _pick_chunk(cfg.N, chunk, pad)
        self.nc = self.N_pad // self.chunk
        self.pad = self.N_pad - cfg.N
        # Tiled position of the last REAL cell (j = i*chunk + t): the
        # reflective outflow reads the scan prefix here, bypassing the
        # pad cells (inflow()).
        self._t_last = (cfg.N - 1) % self.chunk
        self._i_last = (cfg.N - 1) // self.chunk
        self.unroll = unroll
        Mh, G = cfg.M // 2, cfg.G
        self.Bh = Mh * G

        # Host numpy constants (embedded as HLO literals when jitted step
        # functions close over them) — see models/transport.Tables.
        psi_source = np.asarray(tables.psi_source, dtype=np.float64)
        self.bc_neg = np.asarray(
            _to_plane(psi_source, Mh, G)[0]
            if cfg.bc_right_indicator == 1
            else np.zeros(self.Bh),
            dtype=np.dtype(dtype),
        )
        if cfg.bc_left_indicator == 2:
            self.bc_pos_fixed = None
            self.refl_flip = _refl_flip_indices(Mh, G)
        else:
            # vacuum(0) falls through to source in the reference (missing
            # break, solver.cpp:667-671) — replicated; source(1) ditto.
            self.bc_pos_fixed = np.asarray(
                _to_plane(psi_source, Mh, G)[1], dtype=np.dtype(dtype)
            )
            self.refl_flip = None

        self.kcs = {}
        if cfg.ts_method == 1:
            self.kcs[BE] = build_kind_coeffs(cfg, tables, BE, cfg.dt, dtype)
        elif cfg.ts_method == 2:
            self.kcs[CN] = build_kind_coeffs(cfg, tables, CN, cfg.dt, dtype)
        elif cfg.ts_method == 3:
            half = cfg.dt / 2.0
            self.kcs[BE] = build_kind_coeffs(cfg, tables, BE, half, dtype)
            self.kcs[CN] = build_kind_coeffs(cfg, tables, CN, half, dtype)
            self.kcs[BDF] = build_kind_coeffs(cfg, tables, BDF, half, dtype)
        else:
            raise ValueError(f"unknown ts_method {cfg.ts_method}")

    # -- layout conversion ---------------------------------------------------

    def tile(self, flat: jnp.ndarray) -> jnp.ndarray:
        """(2, Bh, N or N_pad) sweep-order plane -> tiled
        (chunk, 2, Bh, nc). Length-N inputs are zero-padded at the
        sweep-downstream end (pad cells never influence real cells)."""
        if self.pad and flat.shape[-1] == self.cfg.N:
            flat = jnp.concatenate(
                [flat, jnp.zeros(flat.shape[:-1] + (self.pad,),
                                 flat.dtype)], axis=-1)
        x = flat.reshape(2, self.Bh, self.nc, self.chunk)
        return jnp.transpose(x, (3, 0, 1, 2))

    def untile(self, tiled: jnp.ndarray) -> jnp.ndarray:
        """tiled (chunk, 2, Bh, nc) -> (2, Bh, N_pad) sweep-order plane
        (== N when unpadded; ends_pair drops the pad cells)."""
        x = jnp.transpose(tiled, (1, 2, 3, 0))
        return x.reshape(2, self.Bh, self.N_pad)

    def from_ends(self, ends, prev, half) -> FlatState:
        """Global (M, G, N, 2) arrays -> tiled FlatState."""
        cfg = self.cfg
        Mh, G, N = cfg.M // 2, cfg.G, cfg.N

        def planes(x):
            x = jnp.asarray(x, dtype=self.dtype)
            neg = x[:Mh].reshape(Mh * G, N, 2)
            pos = x[Mh:].reshape(Mh * G, N, 2)
            n0 = jnp.flip(neg[..., 1], axis=-1)   # oriented: N-reversed,
            n1 = jnp.flip(neg[..., 0], axis=-1)   # edges swapped
            return (
                self.tile(jnp.stack([n0, pos[..., 0]], axis=0)),
                self.tile(jnp.stack([n1, pos[..., 1]], axis=0)),
            )

        e0, e1 = planes(ends)
        p0, p1 = planes(prev)
        h0, h1 = planes(half)
        return FlatState(e0, e1, p0, p1, h0, h1)

    def ends_pair(self, x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
        """Tiled edge planes -> global (M, G, N, 2). Pad cells (sweep-
        downstream: physically left of cell 0 for mu<0, right of N-1 for
        mu>0) are dropped."""
        cfg = self.cfg
        Mh, G, N = cfg.M // 2, cfg.G, cfg.N
        f0, f1 = self.untile(x0), self.untile(x1)
        neg0 = jnp.flip(f1[0], axis=-1)[..., self.pad:].reshape(Mh, G, N)
        neg1 = jnp.flip(f0[0], axis=-1)[..., self.pad:].reshape(Mh, G, N)
        pos0 = f0[1][..., :N].reshape(Mh, G, N)
        pos1 = f1[1][..., :N].reshape(Mh, G, N)
        neg = jnp.stack([neg0, neg1], axis=-1)
        pos = jnp.stack([pos0, pos1], axis=-1)
        return jnp.concatenate([neg, pos], axis=0)

    def ends(self, st: FlatState) -> jnp.ndarray:
        return self.ends_pair(st.e0, st.e1)

    def init_state(self) -> FlatState:
        """psi = ends = B_g everywhere (src/solver.cpp:165-181)."""
        cfg = self.cfg
        Bg = jnp.asarray(
            np.broadcast_to(
                np.asarray(self.tables.B, dtype=np.float64)[None, :],
                (cfg.M // 2, cfg.G),
            ).reshape(self.Bh),
            dtype=self.dtype,
        )
        plane = jnp.broadcast_to(
            Bg[None, None, :, None], (self.chunk, 2, self.Bh, self.nc)
        )
        plane = jnp.asarray(plane)
        return FlatState(plane, plane, plane, plane, plane, plane)

    # -- one fused sub-step ----------------------------------------------------
    # Split into stages so the multi-chip engine (parallel/sharded_fast.py)
    # can reuse the algebra verbatim and inject a cross-shard carry
    # exchange between the local scan and the finish.

    def rhs(self, kind: int, st: FlatState, shift1=None, kc=None):
        """Carry-independent RHS planes (r0, r1, b). `shift1` overrides the
        one-cell-downwind shift (the sharded engine patches the first cell
        with the upstream shard's halo); `kc` overrides the coefficient
        planes (the sharded engine passes row-sharded local slices)."""
        if kc is None:
            kc = self.kcs[kind]
        if shift1 is None:
            shift1 = _shift1_tiled
        # Source term (correction is linear in psi, pre-scaled on host).
        psi = 0.5 * (st.e0 + st.e1)
        S = kc.Sbase + kc.c1 * psi + kc.c0

        # Boundary fills folded out; module doc.
        if kind == BE:
            r0 = S + kc.k_ee * st.e0
            r1 = S + kc.k_ee * st.e1
        elif kind == CN:
            r0 = S + kc.k_ee * st.e0 - kc.q * st.e1 + kc.w * shift1(st.p1)
            r1 = S + kc.q * st.e0 + kc.k_ee * st.e1
        else:  # BDF
            r0 = (
                S + kc.k_ee * st.h0 - 2.0 * kc.w * st.h1
                - kc.k_p * st.p0 - kc.q * st.p1
                + kc.w * (4.0 * shift1(st.h1) + shift1(st.p1))
            )
            r1 = (
                S + 2.0 * kc.w * st.h0 + kc.k_ee * st.h1
                + kc.q * st.p0 - kc.k_p * st.p1
            )

        b = (kc.q * r0 + kc.T0 * r1) * kc.inv_det          # (chunk,2,Bh,nc)
        return r0, r1, b

    def local_scan(self, kind: int, b: jnp.ndarray, kc=None):
        """Two-level scan over this device's cells (zero inflow). Returns
        (pb, pow_t, EXa, EXb, a_powN, tot_b): in-chunk prefixes, a-powers,
        exclusive cross-chunk composites, and the total composite map
        (out = a_powN * in + tot_b) of the whole local axis."""
        if kc is None:
            kc = self.kcs[kind]
        # Level 1: in-chunk scan over t (zero init), no transposes.
        a3 = kc.a[0]                                       # (2, Bh, 1)

        def body(carry, bt):
            new = a3 * carry + bt
            return new, new

        init = jnp.zeros_like(b[0])
        last, pb = lax.scan(body, init, b, unroll=self.unroll)
        # last: (2, Bh, nc) per-chunk b totals; pb: in-chunk prefixes.

        # a^{t+1} and a^{chunk}: tiny cumulative products.
        pow_t = jnp.cumprod(
            jnp.broadcast_to(kc.a, (b.shape[0],) + kc.a.shape[1:]), axis=0
        )                                                  # (chunk,2,Bh,1)
        a_chunk = pow_t[-1]                                # (2, Bh, 1)

        # Level 2: log-depth cross-chunk composition (exclusive).
        a_rep = jnp.broadcast_to(a_chunk, last.shape)
        inc_a, inc_b = lax.associative_scan(_combine, (a_rep, last), axis=-1)
        tot_b = inc_b[..., -1:]                            # (2, Bh, 1)
        a_powN = inc_a[..., -1:]                           # (2, Bh, 1)
        EXa = jnp.concatenate(
            [jnp.ones_like(inc_a[..., :1]), inc_a[..., :-1]], axis=-1
        )
        EXb = jnp.concatenate(
            [jnp.zeros_like(inc_b[..., :1]), inc_b[..., :-1]], axis=-1
        )
        return pb, pow_t, EXa, EXb, a_powN, tot_b

    def inflow(self, kind: int, a_powN: jnp.ndarray, tot_b: jnp.ndarray,
               kc=None, bc=None, scan=None):
        """Effective inflow per half given the GLOBAL total composite. The
        mu>0 reflective inflow is the mu<0 half's outflow = its composite
        applied to its own inflow (solver.cpp:679-683). `bc` overrides the
        (bc_neg, bc_pos_fixed) value planes (the differentiable path
        passes traced boundary sources); the reflective-vs-fixed STRUCTURE
        stays the engine's (it is a static cfg property).

        With internal padding (N_pad > N) the composite total runs past
        the last real cell, so the reflective outflow is instead read
        POSITIONALLY from the scan prefix at cell N-1 — `scan` must then
        be the local_scan outputs (pb, pow_t, EXa, EXb)."""
        if kc is None:
            kc = self.kcs[kind]
        bc_neg, bc_pos_fixed = (self.bc_neg, self.bc_pos_fixed) \
            if bc is None else bc
        init_neg = kc.s * bc_neg                           # (Bh,)
        if self.bc_pos_fixed is None:
            if self.pad:
                assert scan is not None, "padded reflective needs scan="
                pb, pow_t, EXa, EXb = scan
                t, i = self._t_last, self._i_last
                ex_neg = EXa[0, :, i] * init_neg + EXb[0, :, i]
                out_neg = pow_t[t, 0, :, 0] * ex_neg + pb[t, 0, :, i]
            else:
                out_neg = a_powN[0, :, 0] * init_neg + tot_b[0, :, 0]
            bc_pos = out_neg[self.refl_flip]
        else:
            bc_pos = bc_pos_fixed
        return jnp.stack([init_neg, kc.s * bc_pos], axis=0)[..., None]

    def finish(self, kind: int, r0, r1, pb, pow_t, EXa, EXb, incoming,
               kc=None):
        """Reconstruct both cell edges from the incoming carry (the value
        entering this device's first cell, (2, Bh, 1))."""
        if kc is None:
            kc = self.kcs[kind]
        EX = EXa * incoming + EXb                          # (2, Bh, nc)

        # Incoming carry for (t, i): a^t * EX_i + pb[t-1, i].
        pow_t_ex = jnp.concatenate(
            [jnp.ones_like(pow_t[:1]), pow_t[:-1]], axis=0
        )
        pb_ex = jnp.concatenate([jnp.zeros_like(pb[:1]), pb[:-1]], axis=0)
        carry_in = pow_t_ex * EX[None] + pb_ex             # (chunk,2,Bh,nc)

        # Per-cell 2x2 solve given the incoming carry.
        u = r0 + kc.w * carry_in
        ne0 = (kc.T0 * u - kc.q * r1) * kc.inv_det
        ne1 = (kc.q * u + kc.T0 * r1) * kc.inv_det
        return ne0, ne1

    def substep(self, kind: int, st: FlatState, kc=None,
                bc=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
        r0, r1, b = self.rhs(kind, st, kc=kc)
        pb, pow_t, EXa, EXb, a_powN, tot_b = self.local_scan(kind, b, kc=kc)
        incoming = self.inflow(kind, a_powN, tot_b, kc=kc, bc=bc,
                               scan=(pb, pow_t, EXa, EXb))
        return self.finish(kind, r0, r1, pb, pow_t, EXa, EXb, incoming,
                           kc=kc)

    # -- full steps -------------------------------------------------------------

    def step(self, st: FlatState, kcs=None, bc=None) -> FlatState:
        """One full timestep. `kcs`/`bc` override the coefficient dict and
        boundary planes (None -> the engine's host constants); the
        differentiable path (adjoint.make_diff_solve_fast) passes traced
        ones so parameter gradients flow through the same algebra."""
        cfg = self.cfg

        def sub(kind, s):
            return self.substep(kind, s,
                                kc=None if kcs is None else kcs[kind],
                                bc=bc)

        if cfg.ts_method == 1:
            ne0, ne1 = sub(BE, st)
            return FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        if cfg.ts_method == 2:
            st1 = FlatState(st.e0, st.e1, st.e0, st.e1, st.h0, st.h1)
            ne0, ne1 = sub(CN, st1)
            return FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        # BDF2 4-phase cycle (solver.cpp:594-598, 620-625, 700-811).
        p0, p1 = st.e0, st.e1                      # commit prev
        s1 = FlatState(st.e0, st.e1, p0, p1, st.h0, st.h1)
        b0, b1 = sub(BE, s1)                       # phase-0 predictor
        s2 = FlatState(b0, b1, p0, p1, st.h0, st.h1)
        e0, e1 = sub(CN, s2)
        # Snapshot half: plane axis 1 is [mu<0, mu>0]; the mu>0 half keeps
        # the phase-0 BE output (reference quirk — the half_ends copy sits
        # only in the mu<0 branch, solver.cpp:733 vs 784-787) unless the
        # corrected symmetric scheme is requested.
        if cfg.bdf2_symmetric_half:
            h0, h1 = e0, e1
        else:
            h0 = jnp.concatenate([e0[:, :1], b0[:, 1:]], axis=1)
            h1 = jnp.concatenate([e1[:, :1], b1[:, 1:]], axis=1)
        s3 = FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = sub(BE, s3)
        s4 = FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = sub(BDF, s4)
        return FlatState(e0, e1, p0, p1, h0, h1)

    def solve(self, state: Optional[FlatState] = None,
              num_steps: Optional[int] = None) -> FlatState:
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()

        # Cache the jitted runner per step count: a fresh jit closure per
        # call would recompile the identical program every chunk of a
        # checkpointed solve.
        cache = getattr(self, "_solve_cache", None)
        if cache is None:
            cache = self._solve_cache = {}
        run = cache.get(n)
        if run is None:
            @jax.jit
            def run(st):
                return lax.fori_loop(0, n, lambda _, s: self.step(s), st)

            cache[n] = run
        return run(state)


# ---------------------------------------------------------------------------
# Convenience wrappers (used by tests / bench)
# ---------------------------------------------------------------------------

def solve_fast(
    cfg: Config,
    tables,
    state: Optional[FlatState] = None,
    num_steps: Optional[int] = None,
    dtype=jnp.float32,
    chunk: int = 64,
) -> Tuple[FastEngine, FlatState]:
    eng = FastEngine(cfg, tables, dtype=dtype, chunk=chunk)
    return eng, eng.solve(state, num_steps)
