"""Profiling and tracing: wall-clock step metrics + XLA profiler traces.

The reference has no timing instrumentation at all (its solve loop,
reference: src/solver.cpp:590-823, prints only progress banners). The
framework treats per-step wall-clock and the cell-angle-group
updates/s rate (the BASELINE.md north-star metric) as first-class:

* `StepMetrics` — accumulate per-chunk timings, report mean/min ms/step
  and updates/s;
* `trace(logdir)` — context manager around jax.profiler for a Perfetto/
  TensorBoard-viewable device trace;
* `measure_solve` — time a jitted solve with compile excluded.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax


def updates_per_step(cfg) -> int:
    """Cell-angle-group sub-updates in ONE full timestep: BDF2 runs 4
    sub-steps (solver.cpp:700-811), BE/CN one."""
    subs = 4 if cfg.ts_method == 3 else 1
    return subs * cfg.M * cfg.G * cfg.N


@dataclass
class StepMetrics:
    """Wall-clock accumulator for chunked solve loops."""

    updates_per_step: int
    steps: int = 0
    seconds: float = 0.0
    chunks: List[float] = field(default_factory=list)

    def add(self, steps: int, seconds: float) -> None:
        self.steps += steps
        self.seconds += seconds
        self.chunks.append(seconds)

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.seconds / max(self.steps, 1)

    @property
    def updates_per_s(self) -> float:
        return self.updates_per_step * self.steps / max(self.seconds, 1e-12)

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self.seconds:.3f} s "
            f"({self.ms_per_step:.3f} ms/step, "
            f"{self.updates_per_s / 1e6:.1f} M updates/s)"
        )


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """jax.profiler device trace into `logdir` (no-op when logdir is None).
    View with TensorBoard's profile plugin or Perfetto."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def measure_solve(run, state, repeats: int = 3):
    """Best-of-N wall-clock of `run(state)` with compile/warm-up excluded.
    Every timed repeat runs from the SAME input, so the returned result is
    exactly one application of `run`. Returns (result, best_seconds)."""
    out = jax.block_until_ready(run(state))  # compile + warm-up
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    return out, best
