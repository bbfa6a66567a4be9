"""Registration quality metrics.

Parity: compute_registration_metrics
(pde_discovery_improved_registration.py:148-171) — mean residual optical-flow
magnitude between consecutive frames before vs after registration, and the
percent improvement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from pdx.register.farneback import _seq_pairs, batched_pair_flows


def mean_flow_magnitude(U: Array, **flow_kwargs) -> Array:
    """Mean |flow| over all consecutive frame pairs (batched).

    The reference's metric uses light Farnebäck parameters
    (pyr 0.5 / levels 3 / win 15 / iters 3 / poly 5 / sigma 1.2).
    """
    kwargs = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2, gaussian_win=False)
    kwargs.update(flow_kwargs)
    flow_static = tuple(sorted(kwargs.items()))
    # flat-gather-batched pyramid programs, chunked to bound HBM temps
    # (farneback.batched_pair_flows; the vmap-style batched gather lowered
    # pathologically where this was first tuned, the one-giant-program form
    # spilled)
    a, b = _seq_pairs(U)
    fx, fy = batched_pair_flows(a, b, flow_static=flow_static)
    return _mag_mean(fx, fy)


@jax.jit
def _mag_mean(fx, fy):
    return jnp.mean(jnp.sqrt(fx**2 + fy**2))


def registration_improvement(U_before: Array, U_after: Array, **flow_kwargs) -> dict[str, Array]:
    """(avg_before, avg_after, improvement%) — reference metric."""
    before = mean_flow_magnitude(U_before, **flow_kwargs)
    after = mean_flow_magnitude(U_after, **flow_kwargs)
    return {
        "avg_flow_before": before,
        "avg_flow_after": after,
        "improvement_pct": (before - after) / (before + 1e-12) * 100.0,
    }
