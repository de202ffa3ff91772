"""Numeric guards: the functional replacement for the reference's asserts.

The reference guards its solve with hard `assert`s — per-step
`assert(validate_correction())` (reference: src/solver.cpp:609-612) and
per-cell positivity asserts inside the integrators (solver.cpp:402, 488,
585: `assert(res(0) > 0 && res(1) > 0)` in debug builds). Those patterns
don't translate to compiled XLA programs, where control flow cannot abort
mid-graph. The equivalents here:

* `checked_step(step)` — wrap a step function with `jax.experimental.
  checkify` checks (finite ψ, and optionally positive edge intensities),
  returning (error, state); errors are recorded functionally and raised
  on the host via `err.throw()`.
* `assert_state_finite(state)` — host-side guard between solve chunks
  (pairs with utils/checkpoint.solve_with_checkpoints).
* `nan_debug()` — context manager enabling jax's global NaN debugging
  (`jax_debug_nans`), which re-runs the offending primitive un-jitted
  and points at it.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify


def checked_step(step: Callable, positivity: bool = False) -> Callable:
    """Wrap a State -> State step with functional error checks.

    Returns a function State -> (checkify.Error, State). Compose with jit:

        err, state = jax.jit(checked_step(step))(state)
        err.throw()   # host-side; raises with the failing check's message

    With positivity=True also enforces the reference's debug-build
    positivity assertion on both cell edges (solver.cpp:402) — off by
    default because vacuum-boundary problems legitimately produce
    near-zero (and, at f32 roundoff, slightly negative) edge values.
    """

    def guarded(state):
        new = step(state)
        checkify.check(
            jnp.all(jnp.isfinite(new.ends)),
            "non-finite intensity in ends after step",
        )
        if positivity:
            checkify.check(
                jnp.all(new.ends > 0),
                "non-positive edge intensity (reference debug assert, "
                "solver.cpp:402)",
            )
        return new

    return checkify.checkify(guarded)


def make_ends_checker(positivity: bool = False) -> Callable:
    """Per-chunk numeric guard for the drivers (CLI --check).

    Returns check(ends, step=None) raising checkify.JaxRuntimeError with
    the failing check NAMED if the (M, G, N, 2) edge-intensity array is
    non-finite (or non-positive with positivity=True — the reference's
    debug-build assert, solver.cpp:402). Composes with the chunked solvers
    (utils/checkpoint.py, cli --balance-every): one device-side reduction
    per chunk, no effect on the solve trajectory.
    """

    def _verify(ends):
        checkify.check(
            jnp.all(jnp.isfinite(ends)),
            "check 'finite-intensity' failed: non-finite value in ends "
            "(solver.cpp:609-612 analogue)",
        )
        if positivity:
            checkify.check(
                jnp.all(ends > 0),
                "check 'positive-intensity' failed: non-positive edge "
                "intensity (solver.cpp:402 analogue)",
            )

    verify = jax.jit(checkify.checkify(_verify))

    def check(ends, step=None) -> None:
        err, _ = verify(jnp.asarray(ends))
        try:
            err.throw()
        except Exception as e:
            where = f" at step {step}" if step is not None else ""
            raise type(e)(f"{e}{where}") from None

    return check


def assert_state_finite(state) -> None:
    """Host-side: raise FloatingPointError if any state leaf is non-finite."""
    for name, leaf in zip(state._fields, state):
        arr = np.asarray(jax.device_get(leaf))
        if not np.all(np.isfinite(arr)):
            bad = int(np.size(arr) - np.count_nonzero(np.isfinite(arr)))
            raise FloatingPointError(
                f"state.{name} contains {bad} non-finite values"
            )


@contextlib.contextmanager
def nan_debug():
    """Enable jax_debug_nans within the context (slow; debugging only)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
