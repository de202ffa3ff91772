"""Mesh-path communication: the collectives one step issues, and the
weak-scaling ladder (benchmarks/weak_scaling.py --virtual) end to end.

An added collective or a serialisation is the regression that costs a
mesh run 2-10x. Its count is pinned here exactly from the lowered
program (deterministic), rather than through a timing ratio on a
shared CPU host."""

import json
import os
import subprocess
import sys

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import pytest

from radiative_transfer import Config
from radiative_transfer.models import transport
from radiative_transfer.parallel import sharded_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mesh", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
@pytest.mark.parametrize("bc_left", [1, 2], ids=["source", "reflective"])
@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_collectives_per_step(ts_method, bc_left, mesh):
    """Per sub-step: two all_gathers of the chunk composite pair, plus one
    over the group axis for a reflective boundary on a 2-D mesh; per
    step, one halo ppermute per shifted history plane (CN: p1; BDF2's
    CN and BDF sub-steps: p1, then h1 and p1)."""
    cfg = Config(
        M=4, G=2, N=128, X=1.28, efirst=0.1, elast=10.0,
        bc_left_indicator=bc_left, bc_right_indicator=1,
        psi_source=((1.5, 0.3), (0.7, 2.2), (1.1, 0.4), (0.2, 1.9)),
        rho=1.0, kappa_grey=1.0, T=1.0, ts_method=ts_method, dt=1e-5,
        max_timesteps=1, include_validation=False,
    )
    tables, _, _ = transport.build_tables(cfg)
    m = (sharded_fast.make_mesh_1d(mesh[1]) if mesh[0] == 1
         else sharded_fast.make_mesh_2d(*mesh))
    eng = sharded_fast.ShardedFastEngine(cfg, tables, m, dtype=jnp.float32,
                                         chunk=8)
    txt = jax.jit(lambda s: eng.solve(s, num_steps=1)).lower(
        eng.init_state()).as_text()
    subs = 4 if ts_method == 3 else 1
    per_sub = 2 + (bc_left == 2 and mesh[0] > 1)
    assert txt.count("stablehlo.all_gather") == subs * per_sub
    assert txt.count("stablehlo.collective_permute") == {1: 0, 2: 1,
                                                         3: 3}[ts_method]
    assert txt.count("stablehlo.all_reduce") == 0


def test_virtual_ladder_runs():
    """The ladder runs every rung to 8 shards on the virtual mesh, with
    the zero-communication control at the deepest rung."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "weak_scaling.py"),
         "--virtual", "--workload", "gray", "--cells-per-shard", "512",
         "--steps", "4", "--repeats", "1", "--control", "last"],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    assert [r["shards"] for r in rows] == [1, 2, 4, 8]
    assert all(r["updates_per_s"] > 0 for r in rows)
    assert rows[-1]["comm_efficiency"] > 0
    assert all(r["platform"] == "cpu" for r in rows)
