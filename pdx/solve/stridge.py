"""STRidge (sequentially thresholded ridge) — masked, static-shape, batched.

Algorithm parity: ``stridge`` (ks2d_stridge_benchmark.py:404-428):

  1. standardize columns (mean/std; std==0 -> 1);
  2. ridge solve on the standardized system;
  3. loop max_iter times: zero |c| < threshold; if all small, c = 0 and stop;
     refit ridge on the surviving support;
  4. unscale by /(scale + 1e-12).

Batched formulation: the data matrix is touched exactly once to build the
sufficient statistics (G = X^T X, b = X^T y, column sums); standardization is
a linear transform of those stats; each threshold iteration is a masked
(p, p) solve with static shapes (inactive rows become identity rows). The
reference's early ``break`` is replaced by a fixed-point iteration: once the
support stops changing the masked solve is idempotent, and the all-small case
drives the mask to zero which is itself a fixed point — so running the loop
for the full max_iter yields bit-identical results.

Because everything downstream of the stats is (p, p)-sized, a full
alpha x threshold grid (or bootstrap axis, or patch axis) is one vmap.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.linalg import gram_stats, standardized_stats, masked_ridge_solve


@dataclass
class StridgeResult:
    coeffs: Array  # unscaled coefficients in original column units
    mask: Array  # final support mask
    n_active: Array


def _stridge_iterations(
    Gs: Array, bs: Array, alpha: Array | float, threshold: Array | float, max_iter: int,
    init_mask: Array | None = None,
) -> tuple[Array, Array]:
    """Core masked iteration on standardized stats. Returns (coeffs_std, mask).

    ``init_mask`` restricts the fit to a column subset from the start —
    EXACTLY equivalent to fitting on the subset matrix (model families as
    masks over one shared Gram)."""
    p = Gs.shape[-1]
    mask0 = jnp.ones(bs.shape, dtype=Gs.dtype) if init_mask is None else init_mask.astype(Gs.dtype)
    c0 = masked_ridge_solve(Gs, bs, mask0, alpha)

    def body(_, state):
        c, m = state
        small = jnp.abs(c) < threshold
        all_small = jnp.all(small | (m <= 0))
        # support shrinks monotonically; all-small zeroes the mask entirely
        m_new = jnp.where(all_small, jnp.zeros_like(m), m * (~small).astype(m.dtype))
        c_new = masked_ridge_solve(Gs, bs, m_new, alpha)
        return c_new, m_new

    c, m = jax.lax.fori_loop(0, max_iter, body, (c0, mask0))
    return c, m


def stridge_from_stats(
    stats: dict[str, Array],
    *,
    alpha: float | Array = 1e-3,
    threshold: float | Array = 1e-6,
    max_iter: int = 25,
    init_mask: Array | None = None,
) -> StridgeResult:
    """STRidge from raw sufficient statistics (see :func:`pdx.ops.linalg.gram_stats`)."""
    Gs, bs, _mean, scale = standardized_stats(stats)
    c_std, mask = _stridge_iterations(Gs, bs, alpha, threshold, max_iter, init_mask)
    coeffs = c_std / (scale + 1e-12)
    return StridgeResult(coeffs=coeffs, mask=mask, n_active=jnp.sum(mask > 0, axis=-1))


def stridge(
    X: Array,
    y: Array,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    weights: Array | None = None,
) -> Array:
    """Drop-in equivalent of the reference ``stridge(X, y, ...)``, returning
    unscaled coefficients. ``weights`` enables bootstrap/trimmed reuse."""
    stats = gram_stats(X, y, weights)
    return stridge_from_stats(stats, alpha=alpha, threshold=threshold, max_iter=max_iter).coeffs


# ---------------------------------------------------------------------------
# QR-based STRidge: identical algorithm, data-matrix solves
# ---------------------------------------------------------------------------


def _masked_ridge_qr(Xs: Array, y: Array, mask: Array, alpha) -> Array:
    """Ridge solve on the active support via QR of the augmented matrix
    [X*m ; sqrt(alpha) diag(m) + diag(1-m)] — same minimizer as the Gram
    path but conditioned as cond(X) instead of cond(X)^2. The f32 answer on
    an ill-conditioned dictionary (e.g. the 9-term rich KS library) matches
    the f64 Gram solve to ~1e-5 where the f32 Gram path loses percent-level
    accuracy (SURVEY §7.4 risk)."""
    n, p = Xs.shape
    m = mask.astype(Xs.dtype)
    Xm = Xs * m[None, :]
    sqrt_a = jnp.sqrt(jnp.asarray(alpha, Xs.dtype))
    aug = sqrt_a * jnp.eye(p, dtype=Xs.dtype) * m[None, :] + jnp.eye(p, dtype=Xs.dtype) * (1.0 - m)[None, :]
    A = jnp.concatenate([Xm, aug], axis=0)
    b = jnp.concatenate([y, jnp.zeros((p,), Xs.dtype)])
    Q, R = jnp.linalg.qr(A)
    sol = jax.scipy.linalg.solve_triangular(R, Q.T @ b, lower=False)
    return sol * m


def stridge_qr(
    X: Array,
    y: Array,
    *,
    alpha: float | Array = 1e-3,
    threshold: float | Array = 1e-6,
    max_iter: int = 25,
) -> Array:
    """STRidge with QR inner solves (reference algorithm, better f32
    conditioning). Returns unscaled coefficients."""
    from pdx.ops.linalg import _zero_std_tol

    mean = jnp.mean(X, axis=0)
    std = jnp.std(X, axis=0)
    scale = jnp.where(std > _zero_std_tol(mean, std.dtype), std, 1.0)
    Xs = (X - mean) / scale

    def solve_fn(m):
        return _masked_ridge_qr(Xs, y, m, alpha)

    p = X.shape[1]
    mask0 = jnp.ones((p,), dtype=X.dtype)
    c0 = solve_fn(mask0)

    def body(_, state):
        c, m = state
        small = jnp.abs(c) < threshold
        all_small = jnp.all(small | (m <= 0))
        m_new = jnp.where(all_small, jnp.zeros_like(m), m * (~small).astype(m.dtype))
        return solve_fn(m_new), m_new

    c, _m = jax.lax.fori_loop(0, max_iter, body, (c0, mask0))
    return c / (scale + 1e-12)


@partial(jax.jit, static_argnames=("max_iter",))
def _grid_solve_qr(X, y, X_te, y_te, rms_scale, alphas, thresholds, max_iter):
    """QR grid sweep + device-side test metrics (f32-accurate twin of
    _grid_solve_and_score in the ks2d pipeline)."""

    def solve_one(a, t):
        return stridge_qr(X, y, alpha=a, threshold=t, max_iter=max_iter)

    f_t = jax.vmap(solve_one, in_axes=(None, 0))
    coeffs = jax.vmap(f_t, in_axes=(0, None))(alphas, thresholds) / rms_scale
    preds = jnp.einsum("atp,np->atn", coeffs, X_te)
    resid2 = jnp.sum((preds - y_te[None, None, :]) ** 2, axis=-1)
    sst = jnp.sum((y_te - jnp.mean(y_te)) ** 2)
    r2 = 1.0 - resid2 / (sst + 1e-18)
    err = jnp.sqrt(resid2 / y_te.shape[0])
    n_active = jnp.sum(jnp.abs(coeffs) > 0, axis=-1)
    return coeffs, r2, err, n_active


@partial(jax.jit, static_argnames=("max_iter",))
def _grid_solve(Gs, bs, scale, alphas, thresholds, max_iter):
    def solve_one(a, t):
        c_std, m = _stridge_iterations(Gs, bs, a, t, max_iter)
        return c_std / (scale + 1e-12), m

    # grid over (alpha, threshold): vmap twice
    f_t = jax.vmap(solve_one, in_axes=(None, 0))
    f_at = jax.vmap(f_t, in_axes=(0, None))
    return f_at(alphas, thresholds)


def stridge_grid(
    stats: dict[str, Array],
    alphas: Array,
    thresholds: Array,
    *,
    max_iter: int = 25,
) -> tuple[Array, Array]:
    """Batched STRidge over a full alpha x threshold grid.

    Replaces the reference's 30-fit Python double loop
    (ks2d_stridge_benchmark.py:1720-1743) with one device dispatch.
    Returns (coeffs[(A, T, p)], masks[(A, T, p)]).
    """
    Gs, bs, _mean, scale = standardized_stats(stats)
    alphas = jnp.asarray(alphas, dtype=Gs.dtype)
    thresholds = jnp.asarray(thresholds, dtype=Gs.dtype)
    return _grid_solve(Gs, bs, scale, alphas, thresholds, max_iter)
