"""The platform the solver runs on.

Every choice that depends on the hardware (engine routing, whether a GPU
kernel may be built) asks :func:`platform`, so there is one place that
knows which JAX platforms are supported.
"""

from __future__ import annotations

import jax

SUPPORTED = ("cpu", "gpu")


def platform() -> str:
    """``'cpu'`` or ``'gpu'``: the platform of JAX's default device.

    Any other platform is an error: no routing rule was written for it.
    """
    p = jax.devices()[0].platform
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}; this solver runs on "
            f"{' or '.join(SUPPORTED)}")
    return p


def require_gpu(what: str) -> None:
    """Raise unless JAX's default device is a GPU. GPU kernels call this
    before they compile, so a machine without a GPU gets a clear error
    instead of a silent interpreter or a fallback."""
    p = platform()
    if p != "gpu":
        raise RuntimeError(
            f"{what} is a GPU kernel and JAX's platform is {p!r}; run it "
            "on a GPU, or pass interpret=True (tests only)")
