"""radiative_transfer: multigroup thermal radiative transfer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference 1-D slab-geometry discrete-ordinates (S_N) radiative-transfer
miniapp (Helblindi/radiative-transfer), re-designed for accelerators:

* pure-functional state pytrees instead of shared mutable Eigen arrays;
* batched scan-parallel sweeps (associative scan over cells) instead of
  sequential per-cell 2x2 solves;
* multi-chip spatial decomposition via jax.sharding + shard_map with
  closed-form cross-shard carry composition (no wavefront serialisation);
* all T-frozen physics tables hoisted to setup.

float64 is enabled at import: the reference is a double-precision code
and its validation tolerances (1e-6 absolute on O(1) quantities over
thousands of steps) require it. Performance paths pass explicit float32
arrays where appropriate.

Compiled programs are cached on disk: in ``JAX_COMPILATION_CACHE_DIR``
when it is set (JAX reads it itself), else in ``.jax_cache/`` at the
root of the checkout (git-ignored), a fixed path so that later runs
find it.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))

# Honor JAX_PLATFORMS even when jax was imported (and picked its
# platform) before the env var was set.
if _os.environ.get("JAX_PLATFORMS"):
    _jax.config.update("jax_platforms", _os.environ["JAX_PLATFORMS"])

from . import constants  # noqa: E402
from .config.config import Config, load_config  # noqa: E402
from .models import transport  # noqa: E402


def __getattr__(name):
    # Lazy heavy/optional submodules: parallel engines, plotting, utils.
    import importlib

    lazy = {
        "parallel", "plot", "native", "ops", "utils", "data", "cli",
        "adjoint", "ensemble", "backend",
    }
    if name in lazy:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = ["Config", "load_config", "constants", "transport", "adjoint",
           "backend", "cli", "data", "ensemble", "native", "ops", "parallel", "plot",
           "utils", "__version__"]
