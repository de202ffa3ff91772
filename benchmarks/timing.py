"""Device timing shared by the benchmark scripts.

JAX dispatch is asynchronous, so every timed call ends in
``jax.block_until_ready``. The first call compiles and warms up and is
never timed; compile time is reported apart (``compile_run``).
"""

from __future__ import annotations

import time

import jax


def compile_run(fn, *args):
    """(compiled, seconds): ahead-of-time compile of ``jax.jit(fn)`` for
    ``args``. ``compiled.memory_analysis()`` gives the step's buffers."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def time_runs(run, state, repeats: int = 5):
    """(seconds of each timed call, final output). ``run`` is chained on
    its own output; one untimed warm-up call comes first."""
    out = jax.block_until_ready(run(state))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(out))
        times.append(time.perf_counter() - t0)
    return times, out


def time_best(run, state, repeats: int = 3):
    """(fastest timed call in seconds, final output)."""
    times, out = time_runs(run, state, repeats)
    return min(times), out
