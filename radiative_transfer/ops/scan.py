"""Batched first-order affine recurrences (the parallelised sweep core).

The reference's spatial sweep is a strictly sequential per-cell loop
carrying one upwind edge value per (direction, group)
(reference: src/solver.cpp:700-811, carried state at 359/397/540/579).
Each cell applies an affine map to the carry:

    carry_j = a_j * carry_{j-1} + b_j

Composition of affine maps is associative, so the whole N-cell chain is
computed in log-depth with `lax.associative_scan`, batched over the
(M, G) axes — this is the accelerator restructuring of the hot loop.

The scan returns the PREFIX COMPOSITION (pref_a, pref_b) rather than the
carry itself, so that

    carry_j = pref_a_j * init + pref_b_j

can be evaluated for any boundary value `init` after the fact. That form
is exactly what the multi-chip decomposition needs: each shard scans
locally, shards exchange their (M, G)-sized total composites, and every
carry is recovered without re-scanning (see parallel/sharded.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _combine(left, right):
    """Compose affine maps: (apply left, then right)."""
    a_l, b_l = left
    a_r, b_r = right
    return a_r * a_l, a_r * b_l + b_r


def affine_scan(
    a: jnp.ndarray,
    b: jnp.ndarray,
    axis: int = -1,
    chunk: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inclusive prefix composition of x -> a*x + b along `axis`.

    Returns (pref_a, pref_b) with pref_j = f_j ∘ ... ∘ f_0.

    Dispatches to a two-level chunked scan when the axis is long: a pure
    `lax.associative_scan` unrolls log2(N) combine levels into the graph,
    which at N ~ 1e6 (and 8 scans per BDF2 step) makes XLA compilation
    minutes-long and the memory traffic O(N log N). The chunked form keeps
    compile time O(1) in N and traffic O(N).
    """
    if axis not in (-1, a.ndim - 1):
        return lax.associative_scan(_combine, (a, b), axis=axis)
    n = a.shape[-1]
    if n % chunk != 0 or n // chunk < 4:
        return lax.associative_scan(_combine, (a, b), axis=-1)
    return _affine_scan_chunked(a, b, chunk)


def _affine_scan_chunked(
    a: jnp.ndarray, b: jnp.ndarray, chunk: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-level scan along the last axis.

    Level 1: `lax.scan` over the in-chunk position (sequential depth
    `chunk`), vectorised over all N/chunk chunks at once — each step is a
    full-width elementwise op over (batch, N/chunk) elements, and the scan body
    compiles ONCE regardless of N.
    Level 2: exclusive associative composition of the N/chunk chunk-total
    maps (log2(N/chunk) levels over small arrays), then a fused fixup.
    """
    batch = a.shape[:-1]
    n = a.shape[-1]
    nc = n // chunk

    a2 = jnp.moveaxis(a.reshape(*batch, nc, chunk), -1, 0)  # (chunk, *batch, nc)
    b2 = jnp.moveaxis(b.reshape(*batch, nc, chunk), -1, 0)

    def body(carry, ab):
        new = _combine(carry, ab)
        return new, new

    init = (jnp.ones_like(a2[0]), jnp.zeros_like(b2[0]))
    (tot_a, tot_b), (pa, pb) = lax.scan(body, init, (a2, b2))
    # pa/pb: (chunk, *batch, nc) in-chunk inclusive prefixes.

    ca, cb = lax.associative_scan(_combine, (tot_a, tot_b), axis=-1)
    # Exclusive across chunks: chunk 0 sees the identity map.
    ex_a = jnp.concatenate([jnp.ones_like(ca[..., :1]), ca[..., :-1]], axis=-1)
    ex_b = jnp.concatenate([jnp.zeros_like(cb[..., :1]), cb[..., :-1]], axis=-1)

    # Global prefix = (in-chunk prefix) ∘ (exclusive chunk prefix).
    g_a = pa * ex_a
    g_b = pa * ex_b + pb

    g_a = jnp.moveaxis(g_a, 0, -1).reshape(*batch, n)
    g_b = jnp.moveaxis(g_b, 0, -1).reshape(*batch, n)
    return g_a, g_b


def affine_scan_sequential(a: jnp.ndarray, b: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference implementation via lax.scan over the last axis (sequential,
    used in tests to validate the associative version)."""
    a_t = jnp.moveaxis(a, -1, 0)
    b_t = jnp.moveaxis(b, -1, 0)

    def body(carry, ab):
        new = _combine(carry, ab)
        return new, new

    init = (jnp.ones_like(a_t[0]), jnp.zeros_like(b_t[0]))
    _, (pa, pb) = lax.scan(body, init, (a_t, b_t))
    return jnp.moveaxis(pa, 0, -1), jnp.moveaxis(pb, 0, -1)


def apply_prefix(
    pref_a: jnp.ndarray, pref_b: jnp.ndarray, init: jnp.ndarray
) -> jnp.ndarray:
    """carry_j = pref_a_j * init + pref_b_j (init broadcast along the scan axis)."""
    return pref_a * init[..., None] + pref_b
