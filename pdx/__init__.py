"""pdx — PDE discovery framework on JAX/XLA for NVIDIA GPUs.

A ground-up JAX/XLA rebuild of the capabilities of the reference
``pde-discovery-laser-matter`` pipeline: preprocess (registration, denoising,
blockwise averaging) -> derivatives (finite-difference / spectral /
local-polynomial / weak-form) -> candidate term library Theta(u) -> sparse
regression (STRidge and robust variants) -> multi-metric validation
(holdouts, one-step prediction, k-step rollout stability).

Design principles:
  * every numerical primitive is a pure, jittable function over ``(..., H, W)``
    arrays, vmappable over leading time/patch/bootstrap axes;
  * sparse regression runs on sufficient statistics (Gram matrices), so
    thousands of STRidge fits (hyperparameter grids, bootstrap ensembles,
    patch grids) are one batched masked-Cholesky solve;
  * static shapes everywhere: masked weighting instead of row filtering,
    fixed support-mask STRidge, padded patch grids;
  * multi-device scaling via jax.sharding.Mesh + NamedSharding (psum Gram
    reduction over the sample axis, sharded patch/hyperparameter axes).
"""

__version__ = "0.1.0"

from pathlib import Path as _Path

import jax as _jax

# Sparse-regression recovery is precision-critical: on the GPU the default
# f32 matmul precision may run in TF32 (10-bit mantissa), which corrupts
# Gram-matrix accumulation enough to move discovered coefficients by
# percent-level amounts. HIGHEST keeps true-f32 GEMMs at negligible cost for
# this workload's GEMM sizes. Kernels that want lower precision ask for it explicitly via
# preferred_element_type/precision arguments.
_jax.config.update("jax_default_matmul_precision", "highest")

_REPO_CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"


def compilation_cache_dir() -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when it
    is set (JAX reads it itself), else ``<repo>/.jax_cache``."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_REPO_CACHE_DIR)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for this process, so that
    pipeline stages compile once per machine, not once per process. Entry
    points call it on the GPU; the CPU stays uncached (XLA:CPU cache entries
    embed host features that can mismatch across processes). Returns the
    cache directory."""
    import os

    cache_dir = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", cache_dir)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
