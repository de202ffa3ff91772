"""Multi-card engines (general ``sharded``, fast ``sharded_fast``) and the
engine selection every entry point shares."""

import jax.numpy as jnp

from . import distributed, sharded, sharded_fast  # noqa: F401


def make_multichip_engine(cfg, tables, mesh=None, engine: str = "auto",
                          dtype=jnp.float32, scan_tol: float = 1e-10, **kw):
    """The engine for (cfg, mesh, dtype).

    ``engine='auto'``:

    * one device (``mesh`` None or of one device), float32 on a GPU: the
      fused sweep kernel (ops/triton_sweep.TritonEngine);
    * one device otherwise (float64 anywhere, float32 on the CPU): the
      XLA engine ops/fast_sweep.FastEngine — the GPU computes f64 in
      hardware;
    * a mesh of several devices: ShardedFastEngine (XLA under
      shard_map; the collectives go to NCCL on GPUs).

    ``engine='fast'`` pins ShardedFastEngine on ``mesh``. ``kw`` goes to
    the engine's constructor (chunk, unroll). Every engine exposes
    init_state/solve/ends/from_ends with identical semantics.
    """
    from .. import backend

    if engine not in ("auto", "fast"):
        raise ValueError(f"unknown engine {engine!r} (auto/fast)")
    if engine == "fast" or (mesh is not None and mesh.size > 1):
        return sharded_fast.ShardedFastEngine(cfg, tables, mesh, dtype=dtype,
                                              **kw)
    if jnp.dtype(dtype) == jnp.float32 and backend.platform() == "gpu":
        from ..ops.triton_sweep import TritonEngine

        return TritonEngine(cfg, tables, scan_tol=scan_tol, **kw)
    from ..ops.fast_sweep import FastEngine

    return FastEngine(cfg, tables, dtype=dtype, **kw)
