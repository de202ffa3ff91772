"""ShardedFastEngine (the multi-device path: XLA under shard_map) ==
single-device FastEngine on the virtual 8-device mesh, at float32 and
float64, over spatial and (group x spatial) meshes, reflective and
source boundaries, and every integrator.

float64 holds roundoff (5e-13: same algebra, different chunking and
composition order); float32 holds 1e-5 of the f32 single-device result
(two f32 evaluation orders, each within the f32 drift bar of f64).
"""

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiative_transfer import Config
from radiative_transfer.models import transport
from radiative_transfer.ops.fast_sweep import FastEngine
from radiative_transfer.parallel import sharded_fast

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "1x8": (1, 8), "2x2": (2, 2),
          "2x4": (2, 4)}
TOL = {"float32": 1e-5, "float64": 5e-13}


def _mesh(name):
    ng, nx = MESHES[name]
    assert len(jax.devices()) >= ng * nx
    if ng == 1:
        return sharded_fast.make_mesh_1d(nx)
    return sharded_fast.make_mesh_2d(ng, nx)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ts_method", [1, 2, 3])
@pytest.mark.parametrize("bc_left", [2, 1], ids=["reflective", "source"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_matches_single_device(mesh, bc_left, ts_method, dtype):
    cfg = Config(
        M=4, G=2, N=128, X=1.28, efirst=0.1, elast=10.0,
        bc_left_indicator=bc_left, bc_right_indicator=1,
        psi_source=((1.5, 0.3), (0.7, 2.2), (1.1, 0.4), (0.2, 1.9)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=1.0, use_correction=True,
        ts_method=ts_method, dt=1e-5, max_timesteps=3,
        include_validation=False,
    )
    jdt = jnp.dtype(dtype)
    tables, _, _ = transport.build_tables(cfg)
    ref_eng = FastEngine(cfg, tables, dtype=jdt, chunk=8)
    ref = ref_eng.solve(num_steps=3)
    eng = sharded_fast.ShardedFastEngine(cfg, tables, _mesh(mesh),
                                         dtype=jdt, chunk=8)
    st = eng.solve(num_steps=3)
    scale = np.max(np.abs(np.asarray(ref_eng.ends(ref), np.float64)))
    pairs = [((st.e0, st.e1), (ref.e0, ref.e1)),
             ((st.p0, st.p1), (ref.p0, ref.p1))]
    if ts_method == 3:
        pairs.append(((st.h0, st.h1), (ref.h0, ref.h1)))
    for got, want in pairs:
        a = np.asarray(eng.ends_pair(*got), np.float64)
        b = np.asarray(ref_eng.ends_pair(*want), np.float64)
        assert np.max(np.abs(a - b)) / scale < TOL[dtype]
