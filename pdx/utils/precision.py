"""Precision resolution: make 'float64' requests behave sensibly per backend.

When a pipeline config asks for float64: on the CPU, enable x64 (parity
mode); on an accelerator without x64 enabled, fall back to float32 loudly
once (that path compensates with HIGHEST matmul precision, see
pdx/__init__.py). The GPU computes float64 natively; honouring it there is a
ROADMAP item, kept apart so the float32 path is what gets measured.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp

_warned = False


def resolve_dtype(dtype_str: str) -> jnp.dtype:
    global _warned
    dtype = jnp.dtype(dtype_str)
    if dtype == jnp.float64:
        if jax.default_backend() == "cpu":
            if not jax.config.jax_enable_x64:
                jax.config.update("jax_enable_x64", True)
        elif not jax.config.jax_enable_x64:
            if not _warned:
                warnings.warn(
                    f"float64 requested on the {jax.default_backend()} backend: using float32 "
                    "(Gram accumulation runs at HIGHEST matmul precision)."
                )
                _warned = True
            return jnp.dtype(jnp.float32)
    return dtype
