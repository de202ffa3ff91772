"""Multi-host launch helpers.

The reference has no distributed backend (its only parallel artifact is
an unused MPICXX hook, reference: CMakeLists.txt:37-43). The equivalent
here is jax.distributed: every host runs the same program, `initialize()`
wires the processes together, and the engines in this package
(parallel/sharded.py, parallel/sharded_fast.py) then build meshes over
jax.devices() — which spans ALL hosts' devices once distributed mode is
up. One process driving the GPUs of one host needs no coordinator:
`initialize()` then finds none and the run stays a single process.

Typical multi-host driver:

    from radiative_transfer.parallel import distributed, sharded_fast
    distributed.initialize(coordinator_address="host0:1234",
                           num_processes=n, process_id=i)
    mesh = sharded_fast.make_mesh_2d(n_group, n_spatial)
    eng = sharded_fast.ShardedFastEngine(cfg, tables, mesh)
    final = eng.solve()                            # SPMD across hosts

Failure policy: fail fast (any process error aborts the job);
utils/checkpoint.py provides exact restartability.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialize jax.distributed (no-op if already initialized or single
    process). Cluster environments JAX recognises supply the arguments;
    elsewhere pass them explicitly. With none given and none found, the
    run is one process.

    Returns a summary dict {process_index, process_count, local_devices,
    global_devices}.
    """
    # IMPORTANT: nothing here may touch the XLA backend (jax.devices(),
    # jax.default_backend(), ...) before jax.distributed.initialize —
    # backend instantiation makes distributed init impossible.
    already = getattr(jax.distributed, "global_state", None)
    needs_init = not (already is not None and already.client is not None)
    explicit = coordinator_address is not None
    if needs_init:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except (RuntimeError, ValueError):
            if explicit:
                # The caller named a coordinator: a failed init means the
                # job CANNOT be what was asked for (fail-fast policy,
                # module doc) — swallowing it would run a silently
                # smaller, wrong problem on each host.
                raise
            # Env-discovered path only: single-process run (no
            # coordinator in the environment), already initialized, or a
            # backend was already created. Multi-host jobs additionally
            # detect silent failure via assert_mesh_spans_hosts.
            pass
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_multi_host() -> bool:
    return jax.process_count() > 1


def host_array(x):
    """Bring an array to the host as the FULL global array on every
    process. Multi-host meshes produce jax.Arrays that are not fully
    addressable from any one process — np.asarray on those raises;
    process_allgather reassembles them."""
    import numpy as np

    if isinstance(x, np.ndarray):
        return x
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def assert_mesh_spans_hosts(mesh) -> None:
    """Sanity guard for multi-host meshes: every process must contribute
    devices (a mesh silently built from local devices only would solve a
    different, smaller problem on each host)."""
    if not is_multi_host():
        return
    dev_processes = {d.process_index for d in mesh.devices.flat}
    assert len(dev_processes) == jax.process_count(), (
        f"mesh spans processes {sorted(dev_processes)} but "
        f"{jax.process_count()} processes are running"
    )
