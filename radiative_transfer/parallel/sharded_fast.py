"""Multi-device decomposition of the FAST (tiled, constant-coefficient)
engine — the production mesh path.

parallel/sharded.py shards the readable general engine; this module runs
ops/fast_sweep.py's fused sub-step inside `shard_map` on a 1-D or 2-D
device mesh. Design (see also docs/ARCHITECTURE.md §4):

* State planes (chunk, 2, Bh, nc) shard along the chunk-column axis `nc`
  (contiguous spatial blocks per device, cell j = i*chunk+t) and
  optionally along the flattened (Mh·G) batch axis `Bh` — rows are fully
  independent in the sweep, so batch/"group" sharding is embarrassingly
  parallel (the analogue of data parallelism; the only cross-row
  coupling is the reflective-boundary direction flip, a (Bh,)-sized
  all_gather).
* In the sweep-order storage frame the mu<0 half is pre-reversed, so
  BOTH direction halves sweep k -> k+1 across spatial shards: ONE
  ppermute direction carries every halo and the composite exchange is
  uniform.
* Per sub-step: local two-level scan (zero inflow) -> `all_gather` of
  the K per-shard composite affine maps over 'x' -> each shard folds its
  exclusive prefix and the GLOBAL total (which yields the reflective
  mu>0 inflow from the mu<0 global outflow) -> local reconstruction.
* The CN/BDF one-cell-downwind history shift crosses spatial shard
  boundaries at the first local cell: one `ppermute` of the last-cell
  prev/half edge patches it (the inflow-boundary shard keeps the zero
  fill — the true boundary contribution is folded into the effective
  inflow, see fast_sweep module doc).

Communication per sub-step: 1-3 ppermutes of (2, Bh_local) halo values +
2 all_gathers of (K, 2, Bh_local) composites over 'x', plus (reflective
decks only) one (Bh,)-sized all_gather over 'g' — all independent of the
local cell count (NCCL collectives between GPUs).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config.config import Config
from ..ops import fast_sweep as fs

_COEF_ARRAYS = ("w", "T0", "q", "inv_det", "a", "Sbase", "c1", "c0",
                "k_ee", "k_p")


def make_mesh_1d(n_spatial: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= n_spatial
    return Mesh(np.asarray(devices[:n_spatial]), axis_names=("x",))


def make_mesh_2d(n_group: int, n_spatial: int, devices=None) -> Mesh:
    """(g, x) mesh: 'x' innermost, so each spatial halo exchange is
    between neighbouring devices of one group row."""
    if devices is None:
        devices = jax.devices()
    n = n_group * n_spatial
    assert len(devices) >= n
    arr = np.asarray(devices[:n]).reshape(n_group, n_spatial)
    return Mesh(arr, axis_names=("g", "x"))


class ShardedFastEngine:
    """Drop-in FastEngine running the whole time loop on a device mesh."""

    def __init__(self, cfg: Config, tables, mesh: Mesh,
                 dtype=jnp.float32, chunk: int = 64, unroll: int = 4,
                 spatial_axis: str = "x", group_axis: Optional[str] = "g"):
        self.mesh = mesh
        self.axis = spatial_axis
        self.K = mesh.shape[spatial_axis]
        self.gaxis = (
            group_axis
            if group_axis is not None and group_axis in mesh.shape
            and mesh.shape[group_axis] > 1
            else None
        )
        self.NG = mesh.shape[self.gaxis] if self.gaxis else 1
        # Pick the largest chunk <= `chunk` dividing N whose column count
        # N/chunk splits evenly over the K spatial shards.
        chunk = min(chunk, cfg.N)
        while chunk > 1 and (cfg.N % chunk or (cfg.N // chunk) % self.K):
            chunk -= 1
        valid = cfg.N % chunk == 0 and (cfg.N // chunk) % self.K == 0
        if valid and chunk < min(8, cfg.N // max(self.K, 1)):
            raise ValueError(
                f"N={cfg.N} over {self.K} spatial shards admits only a "
                f"degenerate chunking (chunk={chunk} serialises the scan); "
                "choose N with a power-of-two factor per shard")
        self.eng = fs.FastEngine(cfg, tables, dtype=dtype, chunk=chunk,
                                 unroll=unroll, pad=False)
        if self.eng.nc % self.K:
            raise ValueError(
                f"no chunking of N={cfg.N} splits evenly over "
                f"{self.K} spatial shards (got chunk={self.eng.chunk})")
        if self.eng.Bh % self.NG:
            raise ValueError(
                f"batch rows Bh={self.eng.Bh} not divisible by "
                f"{self.NG} group shards")
        self.cfg = cfg
        row_ax = self.gaxis
        self.plane_spec = P(None, None, row_ax, spatial_axis)
        self.coef_spec = P(None, None, row_ax, None)
        self.bc_spec = P(row_ax)
        self.plane_sharding = NamedSharding(mesh, self.plane_spec)
        self._solve_cache: dict = {}

        # Static per-kind scalars (jnp leaves travel through shard_map).
        self._kind_static = {
            kind: (kc.s, kc.ts) for kind, kc in self.eng.kcs.items()
        }
        eng = self.eng
        self._tb = {
            "coef": {
                kind: {n: getattr(kc, n) for n in _COEF_ARRAYS}
                for kind, kc in eng.kcs.items()
            },
            "bc_neg": eng.bc_neg,
            "bc_pos": (
                eng.bc_pos_fixed
                if eng.bc_pos_fixed is not None
                else np.zeros_like(eng.bc_neg)
            ),
        }
        self._tb_specs = {
            "coef": {
                kind: {n: self.coef_spec for n in _COEF_ARRAYS}
                for kind in eng.kcs
            },
            "bc_neg": self.bc_spec,
            "bc_pos": self.bc_spec,
        }
        self.reflective = eng.bc_pos_fixed is None
        if self.reflective:
            self._refl_flip = np.asarray(eng.refl_flip)

    # -- sharded pieces (run inside shard_map on local blocks) ---------------

    def _kc(self, kind: int, tb) -> fs.KindCoeffs:
        s, ts = self._kind_static[kind]
        return fs.KindCoeffs(s=s, ts=ts, **tb["coef"][kind])

    def _shift1(self, x: jnp.ndarray) -> jnp.ndarray:
        """One-cell-downwind shift with cross-shard halo patch."""
        shifted = fs._shift1_tiled(x)
        if self.K == 1:
            return shifted
        halo = lax.ppermute(
            x[-1, :, :, -1], self.axis,
            [(i, i + 1) for i in range(self.K - 1)],
        )  # (2, Bh_l); the first shard receives zeros = the folded fill
        return shifted.at[0, :, :, 0].set(halo)

    def _inflow(self, kind: int, tb, a_powN, tot_b) -> jnp.ndarray:
        """Effective inflow per half from the GLOBAL total composite; the
        reflective mu>0 inflow crosses row shards via a tiny all_gather."""
        s, _ = self._kind_static[kind]
        init_neg = s * tb["bc_neg"]                       # (Bh_l,)
        if not self.reflective:
            bc_pos = tb["bc_pos"]
        else:
            out_neg = a_powN[0, :, 0] * init_neg + tot_b[0, :, 0]
            if self.gaxis is not None:
                full = lax.all_gather(out_neg, self.gaxis).reshape(-1)
                flipped = full[self._refl_flip]
                g = lax.axis_index(self.gaxis)
                nloc = out_neg.shape[0]
                bc_pos = lax.dynamic_slice_in_dim(flipped, g * nloc, nloc)
            else:
                bc_pos = out_neg[self._refl_flip]
        return jnp.stack([init_neg, s * bc_pos], axis=0)[..., None]

    def _substep(self, kind: int, st: fs.FlatState, tb):
        eng = self.eng
        kc = self._kc(kind, tb)
        r0, r1, b = eng.rhs(kind, st, shift1=self._shift1, kc=kc)
        pb, pow_t, EXa, EXb, a_powN, tot_b = eng.local_scan(kind, b, kc=kc)

        if self.K == 1:
            incoming = self._inflow(kind, tb, a_powN, tot_b)
            return eng.finish(kind, r0, r1, pb, pow_t, EXa, EXb, incoming,
                              kc=kc)

        # Composite exchange: shard order IS sweep order for both halves
        # (the mu<0 half is stored pre-reversed). One tiny all_gather,
        # then a LOG-DEPTH local associative scan of the affine pairs
        # (the K-unrolled fold it replaces built an O(K) graph with an
        # O(K) serial chain — hostile at pod scale; see
        # sharded._compose_affine).
        from .sharded import _compose_affine

        gA = lax.all_gather(a_powN[..., 0], self.axis)   # (K, 2, Bh_l)
        gB = lax.all_gather(tot_b[..., 0], self.axis)
        k = lax.axis_index(self.axis)

        inclA, inclB = lax.associative_scan(_compose_affine, (gA, gB),
                                            axis=0)
        exclA = jnp.concatenate([jnp.ones_like(gA[:1]), inclA[:-1]], 0)
        exclB = jnp.concatenate([jnp.zeros_like(gB[:1]), inclB[:-1]], 0)
        eA = lax.dynamic_index_in_dim(exclA, k, 0, keepdims=False)
        eB = lax.dynamic_index_in_dim(exclB, k, 0, keepdims=False)
        # inclA/inclB's last entry is the GLOBAL total composite.
        inflow = self._inflow(kind, tb, inclA[-1][..., None],
                              inclB[-1][..., None])
        incoming = eA[..., None] * inflow + eB[..., None]
        return eng.finish(kind, r0, r1, pb, pow_t, EXa, EXb, incoming, kc=kc)

    def _step(self, st: fs.FlatState, tb) -> fs.FlatState:
        cfg = self.cfg
        if cfg.ts_method == 1:
            ne0, ne1 = self._substep(fs.BE, st, tb)
            return fs.FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        if cfg.ts_method == 2:
            s1 = fs.FlatState(st.e0, st.e1, st.e0, st.e1, st.h0, st.h1)
            ne0, ne1 = self._substep(fs.CN, s1, tb)
            return fs.FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        # BDF2 4-phase cycle.
        p0, p1 = st.e0, st.e1
        s1 = fs.FlatState(st.e0, st.e1, p0, p1, st.h0, st.h1)
        b0, b1 = self._substep(fs.BE, s1, tb)
        s2 = fs.FlatState(b0, b1, p0, p1, st.h0, st.h1)
        e0, e1 = self._substep(fs.CN, s2, tb)
        # mu>0 half snapshot = phase-0 BE output (reference quirk,
        # solver.cpp:733 vs 784-787; see ops/fast_sweep.py).
        if cfg.bdf2_symmetric_half:
            h0, h1 = e0, e1
        else:
            h0 = jnp.concatenate([e0[:, :1], b0[:, 1:]], axis=1)
            h1 = jnp.concatenate([e1[:, :1], b1[:, 1:]], axis=1)
        s3 = fs.FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = self._substep(fs.BE, s3, tb)
        s4 = fs.FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = self._substep(fs.BDF, s4, tb)
        return fs.FlatState(e0, e1, p0, p1, h0, h1)

    # -- public API ----------------------------------------------------------

    def init_state(self) -> fs.FlatState:
        st = self.eng.init_state()
        put = functools.partial(jax.device_put, device=self.plane_sharding)
        return jax.tree_util.tree_map(put, st)

    def ends(self, st: fs.FlatState) -> jnp.ndarray:
        return self.eng.ends(st)

    def ends_pair(self, x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
        """Tiled edge planes -> global (M, G, N, 2) (checkpoint adapter)."""
        return self.eng.ends_pair(x0, x1)

    def from_ends(self, ends, prev, half) -> fs.FlatState:
        st = self.eng.from_ends(ends, prev, half)
        put = functools.partial(jax.device_put, device=self.plane_sharding)
        return jax.tree_util.tree_map(put, st)

    def solve(self, state: Optional[fs.FlatState] = None,
              num_steps: Optional[int] = None) -> fs.FlatState:
        """Run the whole time loop in ONE shard_map region (no per-step
        dispatch or resharding)."""
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()

        run = self._solve_cache.get(n)
        if run is None:
            spec = fs.FlatState(*([self.plane_spec] * 6))

            def run_local(st, tb):
                return lax.fori_loop(
                    0, n, lambda _, s: self._step(s, tb), st
                )

            run = jax.jit(shard_map(
                run_local, mesh=self.mesh,
                in_specs=(spec, self._tb_specs), out_specs=spec,
            ))
            self._solve_cache[n] = run
        return run(state, self._tb)
