"""Checkpoint / resume for the transport solve.

The reference has no checkpointing — only end-of-run CSV dumps
(reference: src/main.cc:117-133); a long multigroup run that dies must
restart from t=0. Here the full step state pytree {ends, prev_ends,
half_ends} plus the step index is periodically written as a compressed
.npz (bit-exact float64 round-trip), so any run can resume exactly.

Exactness across the BDF2 sub-cycle: the framework's step function runs
all 4 BDF2 phases (BE/CN/BE/BDF of dt/2) atomically inside one
full-timestep transition (models/transport.py make_step_fn), so a
checkpoint at a full-step boundary captures the complete integrator
history — no separate `_it % 4` phase needs saving (the reference's
sub-step counter, src/solver.cpp:620-625, is internal to our step).

A config fingerprint (every field that affects the trajectory) is stored
and verified on load; resuming with a different problem is an error.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Optional, Tuple

import jax
import numpy as np

from ..config.config import Config
from ..models.transport import State

_CKPT_RE = re.compile(r"ckpt_(\d{9})\.npz$")

# Fields excluded from the trajectory fingerprint: they do not change the
# step function (max_timesteps is a stopping criterion; validation is a
# setup-time assert).
_NON_TRAJECTORY_FIELDS = ("max_timesteps", "include_validation")


def config_fingerprint(cfg: Config) -> str:
    d = dataclasses.asdict(cfg)
    for k in _NON_TRAJECTORY_FIELDS:
        d.pop(k, None)
    return json.dumps(d, sort_keys=True)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:09d}.npz")


def _host_array(x) -> np.ndarray:
    """Bring a state leaf to the host as a full global array (gathers
    non-fully-addressable multi-host arrays; every process ends up with
    identical data, so the process-0-writes logic and any check_fn see
    the same state everywhere)."""
    from ..parallel.distributed import host_array

    return host_array(x)


def _barrier(tag: str) -> None:
    """Cross-process sync (no-op single-process): a checkpoint write must
    complete before any process can race ahead (or exit, tearing down the
    coordinator under the writer)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)


def _assert_same_start(start: int) -> None:
    """Multi-host resume guard: process 0 alone writes checkpoints, so
    ckpt_dir MUST be a shared filesystem — if it is not, processes find
    different newest checkpoints and would run different chunk counts
    into mismatched collectives (a silent distributed hang). Gather the
    resumed step and fail fast with guidance instead."""
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    starts = np.asarray(multihost_utils.process_allgather(
        np.int64(start), tiled=False)).ravel()
    if not (starts == starts[0]).all():
        raise RuntimeError(
            f"processes resumed from different checkpoint steps "
            f"{starts.tolist()} — the checkpoint directory must be a "
            "filesystem shared by every process (process 0 is the only "
            "writer)")


def save_checkpoint(ckpt_dir: str, state: State, step: int, cfg: Config) -> str:
    """Write the state at full-step `step`. Atomic (write + rename).

    Multi-host safe: state leaves are gathered to every host
    (_host_array), but only process 0 touches the filesystem — a shared
    checkpoint directory must not see concurrent writers — and a barrier
    holds every process until the file is in place."""
    path = checkpoint_path(ckpt_dir, step)
    host = State(
        ends=_host_array(state.ends),
        prev_ends=_host_array(state.prev_ends),
        half_ends=_host_array(state.half_ends),
    )
    if jax.process_index() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(
                fh,
                ends=host.ends,
                prev_ends=host.prev_ends,
                half_ends=host.half_ends,
                step=np.int64(step),
                fingerprint=np.frombuffer(
                    config_fingerprint(cfg).encode(), dtype=np.uint8
                ),
            )
        os.replace(tmp, path)
    _barrier(f"ckpt-{step}")
    return path


def load_checkpoint(path: str, cfg: Optional[Config] = None) -> Tuple[State, int]:
    """Load (state, step). If `cfg` is given, the stored fingerprint must
    match, guarding against resuming a different problem."""
    with np.load(path) as z:
        if cfg is not None:
            stored = bytes(z["fingerprint"]).decode()
            want = config_fingerprint(cfg)
            if stored != want:
                raise ValueError(
                    f"checkpoint {path} was written for a different problem:\n"
                    f"  stored : {stored}\n  current: {want}"
                )
        state = State(
            ends=z["ends"], prev_ends=z["prev_ends"], half_ends=z["half_ends"]
        )
        step = int(z["step"])
    return state, step


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-step checkpoint in `ckpt_dir`, or None."""
    best, best_step = None, -1
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz")):
        m = _CKPT_RE.search(p)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def solve_with_checkpoints(
    cfg: Config,
    tables,
    state: State,
    ckpt_dir: str,
    every: int,
    resume: bool = True,
    num_steps: Optional[int] = None,
    check_fn=None,
    solve_fn=None,
) -> Tuple[State, int]:
    """Run the solve in chunks of `every` steps, checkpointing after each
    chunk; on entry, resume from the newest valid checkpoint if present.
    `check_fn(ends, step)` (utils/debug.make_ends_checker) runs after each
    chunk INCLUDING the resumed state, before anything is written — a
    failing check aborts without committing a poisoned checkpoint.
    `solve_fn(state, n) -> state` overrides the default single-device
    chunk runner (e.g. parallel.sharded.solve_sharded bound to a mesh).

    Returns (final_state, start_step_resumed_from). The trajectory is
    bit-identical to an uninterrupted `transport.solve` because chunking a
    fori_loop at full-step boundaries does not change any computation.
    """
    import functools

    from jax import lax

    from ..models import transport

    total = cfg.max_timesteps if num_steps is None else num_steps
    start = 0
    if resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            state, start = load_checkpoint(latest, cfg)
            if check_fn is not None:
                check_fn(state.ends, start)
    if resume:
        _assert_same_start(start)

    if solve_fn is not None:
        run_chunk = solve_fn
    else:
        step = transport.make_step_fn(cfg, tables)

        @functools.partial(jax.jit, static_argnums=1)
        def run_chunk(s: State, n: int) -> State:
            return lax.fori_loop(0, n, lambda _, x: step(x), s)

    done = start
    while done < total:
        n = min(every, total - done)
        state = run_chunk(state, n)  # compiles once per distinct n
        done += n
        if check_fn is not None:
            check_fn(state.ends, done)
        save_checkpoint(ckpt_dir, state, done, cfg)
    return state, start


def solve_with_checkpoints_engine(
    eng,
    cfg: Config,
    ckpt_dir: str,
    every: int,
    resume: bool = True,
    num_steps: Optional[int] = None,
    check_fn=None,
):
    """Checkpointed solve for the fast/triton/multi-device engines (any
    engine exposing init_state/solve/from_ends and the FlatState layout
    with ends_pair). Checkpoints store the same portable global
    (M, G, N, 2) arrays as the general engine — the engine layout is
    converted at chunk boundaries, so a run checkpointed by one engine
    can resume under another (or under the general solver).

    Note: engines may run reduced precision (float32); the checkpoint
    stores their arrays as float64 containers without adding information.
    """
    total = cfg.max_timesteps if num_steps is None else num_steps

    def global_state(state) -> State:
        # _host_array handles multi-host meshes (the converted arrays are
        # not fully addressable from one process there).
        return State(
            ends=_host_array(
                eng.ends_pair(state.e0, state.e1)).astype(np.float64),
            prev_ends=_host_array(
                eng.ends_pair(state.p0, state.p1)).astype(np.float64),
            half_ends=_host_array(
                eng.ends_pair(state.h0, state.h1)).astype(np.float64),
        )

    start = 0
    state = None
    if resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            gstate, start = load_checkpoint(latest, cfg)
            if check_fn is not None:
                check_fn(gstate.ends, start)
            state = eng.from_ends(gstate.ends, gstate.prev_ends,
                                  gstate.half_ends)
    if resume:
        _assert_same_start(start)
    if state is None:
        state = eng.init_state()

    done = start
    while done < total:
        n = min(every, total - done)
        state = eng.solve(state, num_steps=n)
        done += n
        gstate = global_state(state)
        if check_fn is not None:
            check_fn(gstate.ends, done)
        save_checkpoint(ckpt_dir, gstate, done, cfg)
    return state, start
