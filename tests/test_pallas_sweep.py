"""Fused GPU sweep kernel (ops/triton_sweep, Pallas-Triton) == the f64
XLA engine, with the kernel run in the Pallas interpreter on the CPU.

Error metric is normalised by the per-array magnitude: the LLNL deck's
optically-thick groups produce values spanning ~10 orders of magnitude,
and a float32 engine is compared with float64 truth. The bar 1e-5 is the
f32 drift bar of tests/test_f32_drift.py for these short runs.
"""

import conftest  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import load_config
from radiative_transfer.models import transport
from radiative_transfer.ops import fast_sweep, triton_sweep

F32_BAR = 1e-5


def _relerr(got, ref):
    scale = np.max(np.abs(ref)) + 1e-300
    return np.max(np.abs(got - ref)) / scale


def _compare(cfg, num_steps, chunk=8, tol=F32_BAR, **kw):
    """Kernel (interpret) vs FastEngine float64 on ends, prev and half."""
    tables, _, _ = transport.build_tables(cfg)
    ref = fast_sweep.FastEngine(cfg, tables, dtype=jnp.float64, chunk=chunk)
    rst = ref.solve(num_steps=num_steps)
    eng = triton_sweep.TritonEngine(cfg, tables, chunk=chunk,
                                    interpret=True, **kw)
    st = eng.solve(num_steps=num_steps)
    pairs = [("e", (st.e0, st.e1), (rst.e0, rst.e1)),
             ("p", (st.p0, st.p1), (rst.p0, rst.p1))]
    if cfg.ts_method == 3:
        pairs.append(("h", (st.h0, st.h1), (rst.h0, rst.h1)))
    for name, got, want in pairs:
        err = _relerr(np.asarray(eng.ends_pair(*got)),
                      np.asarray(ref.ends_pair(*want)))
        assert err < tol, (name, err)
    return eng


@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_gray_deck(ts_method):
    cfg = load_config(
        conftest.reference_deck("single_group.prm"),
        N=64, ts_method=ts_method, max_timesteps=3,
    )
    _compare(cfg, 3)


def test_multigroup_correction_deck():
    cfg = load_config(
        conftest.reference_deck("multi_group_equilibrium.prm"),
        N=64, max_timesteps=3,
    )
    _compare(cfg, 3)


def test_llnl_deck():
    cfg = load_config(
        conftest.reference_deck("llnl_slab_test.prm"), N=32, max_timesteps=2
    )
    _compare(cfg, 2, tol=1e-4)


@pytest.mark.parametrize("scan_tol", [1e-10, 0.0])
@pytest.mark.parametrize("bc_left,bc_right", [(0, 0), (1, 1), (2, 0), (2, 1)])
@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_bc_combinations(ts_method, bc_left, bc_right, scan_tol):
    """Every integrator x boundary pair, through both regimes: the
    look-back (truncated) launch and the exact two-pass scan."""
    cfg = load_config(
        conftest.reference_deck("single_group.prm"),
        M=4, N=64, ts_method=ts_method, max_timesteps=2,
        bc_left_indicator=bc_left, bc_right_indicator=bc_right,
        psi_source=tuple((float(i + 1),) for i in range(4)),
    )
    eng = _compare(cfg, 2, scan_tol=scan_tol)
    assert all(h == 0 for h in eng.H.values()) == (scan_tol == 0.0)


@pytest.mark.parametrize("refl", [True, False])
@pytest.mark.parametrize("N", [61, 63, 67, 100])
def test_padded_n(N, refl):
    """N with no power-of-two chunk: pad cells sit sweep-downstream and
    the reflective outflow is read at the last real cell."""
    cfg = load_config(
        conftest.reference_deck("single_group.prm"), N=N, max_timesteps=2,
        bc_left_indicator=2 if refl else 1,
    )
    eng = _compare(cfg, 2, chunk=16)
    if N != 100:
        assert eng.pad > 0


@pytest.mark.parametrize("deck,overrides,grid", [
    ("single_group.prm", dict(M=4, N=64), (1, 1)),
    ("single_group.prm", dict(M=16, N=2048, X=20.48), (4, 2)),
    ("llnl_slab_test.prm", dict(N=48), (2, 2)),
    ("llnl_slab_test.prm", dict(N=200), (8, 2)),
])
def test_block_tiles(deck, overrides, grid):
    """One tile, several full tiles, and masked partial tiles on both
    axes (248 LLNL rows, chunk-column counts off the power-of-two tile)
    all give the single-tile answer."""
    cfg = load_config(conftest.reference_deck(deck), max_timesteps=2,
                      **overrides)
    eng = _compare(cfg, 2, tol=1e-4)
    RT = eng._rows_tile(eng.R)
    assert (-(-eng.R // RT), -(-eng.nc // eng.CT)) == grid


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_halo_edges(chunk):
    """Look-back length H against the chunk: H < chunk, H == chunk, and
    H > chunk (which switches that kind to the two-pass scan)."""
    cfg = load_config(conftest.reference_deck("single_group.prm"),
                      N=128, max_timesteps=2)
    eng = _compare(cfg, 2, chunk=chunk)
    tables, _, _ = transport.build_tables(cfg)
    for kind, kc in fast_sweep.FastEngine(cfg, tables).kcs.items():
        H = triton_sweep.lookback_cells(float(np.max(kc.a)), 1e-10)
        assert eng.H[kind] == (H if H <= eng.chunk else 0)


# -- accuracy-bounded look-back (ops/triton_sweep.lookback_cells) -----------

def test_scan_npass_bound():
    """The look-back bound: tol=0 disables truncation; a=0 needs one
    cell; a -> 1 cannot be truncated; H is monotone in a and in 1/tol."""
    lb = triton_sweep.lookback_cells
    assert lb(0.5, 0.0) == 0
    assert lb(0.0, 1e-10) == 1
    assert lb(1.0 - 1e-15, 1e-10) == 0
    assert lb(float("nan"), 1e-10) == 0
    assert lb(0.3, 1e-6) <= lb(0.3, 1e-12)
    assert lb(0.1, 1e-10) <= lb(0.9, 1e-10)
    a, tol = 0.6, 1e-10
    H = lb(a, tol)
    assert a ** H / (1 - a) < tol
    assert a ** (H // 2) / (1 - a) >= tol


def test_scan_truncation_accuracy():
    """Default scan_tol vs the exact two-pass scan: differences bounded
    far below the f32 drift floor, on a deck where truncation applies."""
    cfg = load_config(conftest.reference_deck("single_group.prm"),
                      max_timesteps=6, N=256, dt=2e-6)
    tables, _, _ = transport.build_tables(cfg)
    eng_t = triton_sweep.TritonEngine(cfg, tables, interpret=True)
    eng_f = triton_sweep.TritonEngine(cfg, tables, scan_tol=0.0,
                                      interpret=True)
    assert all(h > 0 for h in eng_t.H.values()), eng_t.H
    a = np.asarray(eng_f.ends(eng_f.solve(num_steps=6)))
    b = np.asarray(eng_t.ends(eng_t.solve(num_steps=6)))
    rel = np.max(np.abs(a - b)) / np.max(np.abs(a))
    assert rel < 1e-6, rel


def test_scan_npass_llnl_keeps_more_passes():
    """Optically-thin LLNL groups have carry multipliers near 1 at the
    shipped dt, so no look-back can be truncated (two-pass scan), while
    the gray deck truncates to a few cells."""
    cfg_g = load_config(conftest.reference_deck("single_group.prm"))
    cfg_l = load_config(conftest.reference_deck("llnl_slab_test.prm"))
    tg, _, _ = transport.build_tables(cfg_g)
    tl, _, _ = transport.build_tables(cfg_l)
    eg = triton_sweep.TritonEngine(cfg_g, tg, interpret=True)
    el = triton_sweep.TritonEngine(cfg_l, tl, interpret=True)
    assert max(el.H.values()) == 0
    assert 0 < max(eg.H.values()) <= eg.chunk


def test_block_autotune_and_pinning():
    """The tile covers 512 lanes with at most 128 consecutive chunk
    columns; rows shrink to the launch's row count; chunk is pinned
    verbatim."""
    cfg = load_config(conftest.reference_deck("single_group.prm"),
                      M=32, N=1 << 12, X=1.0, max_timesteps=2)  # Bh=16
    tables, _, _ = transport.build_tables(cfg)
    eng = triton_sweep.TritonEngine(cfg, tables, interpret=True)
    assert eng.chunk == 32 and eng.nc == 128 and eng.CT == 128
    assert eng._rows_tile(16) == 4
    assert eng._rows_tile(1) == 1
    pinned = triton_sweep.TritonEngine(cfg, tables, chunk=256,
                                       interpret=True)
    assert pinned.chunk == 256 and pinned.nc == 16 and pinned.CT == 16
    assert pinned._rows_tile(32) == 32 and pinned._rows_tile(16) == 16


def test_needs_gpu_unless_interpreted():
    """Asking for the GPU kernel on a machine without a GPU is an error,
    never a silent interpreter."""
    cfg = load_config(conftest.reference_deck("single_group.prm"), N=32)
    tables, _, _ = transport.build_tables(cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        triton_sweep.TritonEngine(cfg, tables)


def test_rejects_traced_coefficients():
    cfg = load_config(conftest.reference_deck("single_group.prm"), N=32)
    tables, _, _ = transport.build_tables(cfg)
    eng = triton_sweep.TritonEngine(cfg, tables, interpret=True)
    with pytest.raises(ValueError, match="host"):
        eng.substep(fast_sweep.BE, eng.init_state(), kc=eng.kcs[1])
