"""Mesh construction + sharded Gram reduction (the framework's collectives).

The workload's parallel axes (SURVEY §2.9): samples (data-parallel Gram
accumulation with a psum over the mesh), patches / bootstrap members /
hyperparameter grid points (embarrassingly parallel batched solves, sharded
over the mesh), and frames (batched FFT/stencil evaluation).

Everything reaches XLA collectives implicitly through jit + NamedSharding /
shard_map — no hand-rolled communication backend: pick a 1-D mesh, annotate
shardings, and let XLA insert the psum/all-gathers (NCCL over NVLink on GPUs).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pdx.ops.linalg import gram_stats

_STAT_KEYS = ("G", "b", "sx", "n", "syy", "sy")


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D device mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def shard_batch(x: Array, mesh: Mesh, axis_name: str = "data") -> Array:
    """Place ``x`` with its leading axis sharded over ``axis_name``."""
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def maybe_shard_leading(
    arrs: tuple[Array, ...], mesh_mode: str = "auto", axis_name: str = "data"
) -> tuple[tuple[Array, ...], int]:
    """Shard the common leading (patch/member/grid) axis over all devices.

    Pads to a device-count multiple by repeating the final slice — callers
    slice results back to the returned original length, so padding never
    changes results. No-op (and no copy) on a single device or when
    ``mesh_mode == 'off'``. Returns (arrays, original_leading_len).
    """
    n_dev = jax.device_count()
    P0 = int(arrs[0].shape[0])
    use = mesh_mode == "on" or (mesh_mode == "auto" and n_dev > 1)
    if not use or n_dev < 2:
        return arrs, P0
    pad = (-P0) % n_dev
    mesh = make_mesh(n_dev, axis_name)
    out = []
    for a in arrs:
        if pad:
            a = jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)], axis=0)
        out.append(shard_batch(a, mesh, axis_name))
    return tuple(out), P0


def sharded_gram_stats(
    X: Array, y: Array, mesh: Mesh, axis_name: str = "data", weights: Array | None = None
) -> dict[str, Array]:
    """Gram sufficient statistics with the sample axis sharded over the mesh.

    Each device computes its local statistics with :func:`gram_stats`; one
    psum per statistic (an NCCL all-reduce over NVLink on GPUs) produces the
    replicated (p, p)/(p,) stats. This is the
    multi-chip form of :func:`pdx.ops.linalg.gram_stats` — the only
    cross-device communication the regression stack needs, O(p^2) bytes.

    ``weights`` (0/1 rows) lets callers zero-pad to a device-count multiple
    with EXACT statistics (padding rows contribute nothing, including to the
    row count n).
    """
    if weights is None:
        weights = jnp.ones((X.shape[0],), dtype=X.dtype)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P(), P(), P(), P()),
    )
    def local_stats(Xl, yl, wl):
        s = gram_stats(Xl, yl, wl)
        return tuple(jax.lax.psum(s[k], axis_name) for k in _STAT_KEYS)

    return dict(zip(_STAT_KEYS, local_stats(X, y, weights)))
