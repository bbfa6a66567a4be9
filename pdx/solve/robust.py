"""Robust sparse-regression family: Huber-IRLS, trimmed, sign-constrained,
bootstrap-ensemble, and the combined robust pipeline.

Algorithm parity (ks2d_stridge_benchmark.py):
  * huber_weight / irls_huber_fit        :436-469
  * stridge_huber                        :472-502
  * trimmed_stridge                      :505-549
  * stridge_sign_constrained             :552-600
  * ensemble_stridge                     :603-644
  * robust_stridge                       :647-748

Batched formulation: every variant is the same masked threshold loop as
:mod:`pdx.solve.stridge` with a pluggable masked inner solver; bootstrap
members are gathered subsample matrices vmapped over the member axis, so a
30-50 member ensemble is one batched dispatch. Bootstrap index sets are drawn
on the host (numpy Generator, reference draw order) for sample-for-sample
golden parity.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.linalg import masked_ridge_solve


def huber_weight(r: Array, delta: float = 1.35) -> Array:
    """w = 1 for |r| <= delta else delta/|r| (+1e-12 guard)."""
    abs_r = jnp.abs(r)
    return jnp.where(abs_r <= delta, 1.0, delta / (abs_r + 1e-12))


def _masked_weighted_ridge(X: Array, y: Array, w: Array, col_mask: Array, alpha) -> Array:
    """Solve (Xm^T W Xm + alpha I)|support = Xm^T W y with static shapes."""
    Xm = X * col_mask[None, :]
    G = Xm.T @ (Xm * w[:, None])
    b = Xm.T @ (w * y)
    return masked_ridge_solve(G, b, col_mask, alpha)


def irls_huber(
    X: Array,
    y: Array,
    *,
    alpha: float = 1e-3,
    delta: float = 1.35,
    max_iter: int = 50,
    tol: float = 1e-6,
    col_mask: Array | None = None,
) -> Array:
    """IRLS with Huber loss and MAD residual scale.

    Parity: irls_huber_fit (ks2d_stridge_benchmark.py:442-469), including the
    convergence quirk that on convergence the *previous* iterate is returned.
    """
    p = X.shape[1]
    if col_mask is None:
        col_mask = jnp.ones((p,), dtype=X.dtype)
    Xm = X * col_mask[None, :]
    ones = jnp.ones(X.shape[0], dtype=X.dtype)
    beta0 = _masked_weighted_ridge(X, y, ones, col_mask, alpha)

    def cond(state):
        _, i, done = state
        return (i < max_iter) & (~done)

    def body(state):
        beta, i, _ = state
        r = y - Xm @ beta
        sigma = jnp.median(jnp.abs(r)) * 1.4826 + 1e-12
        w = huber_weight(r / sigma, delta=delta)
        beta_new = _masked_weighted_ridge(X, y, w, col_mask, alpha)
        converged = jnp.max(jnp.abs(beta_new - beta)) < tol
        beta_out = jnp.where(converged, beta, beta_new)
        return beta_out, i + 1, converged

    beta, _, _ = jax.lax.while_loop(cond, body, (beta0, jnp.asarray(0), jnp.asarray(False)))
    return beta


def _standardize_data(X: Array) -> tuple[Array, Array, Array]:
    from pdx.ops.linalg import _zero_std_tol

    mean = jnp.mean(X, axis=0)
    std = jnp.std(X, axis=0)
    scale = jnp.where(std > _zero_std_tol(mean, std.dtype), std, 1.0)
    return (X - mean) / scale, mean, scale


def _threshold_loop(solve_fn, c0: Array, threshold, max_iter: int, sign_fn=None):
    """Shared STRidge threshold loop with a pluggable masked solver.

    solve_fn(mask) -> coefficients on that support (zeros elsewhere).
    sign_fn(c) -> c with wrong-signed entries zeroed (optional).
    """
    m0 = jnp.ones_like(c0)

    def body(_, state):
        c, m = state
        if sign_fn is not None:
            c = sign_fn(c)
        small = jnp.abs(c) < threshold
        all_small = jnp.all(small | (m <= 0))
        m_new = jnp.where(all_small, jnp.zeros_like(m), m * (~small).astype(m.dtype))
        c_new = solve_fn(m_new)
        if sign_fn is not None:
            c_new = sign_fn(c_new)
        return c_new, m_new

    c, m = jax.lax.fori_loop(0, max_iter, body, (c0, m0))
    return c, m


def _make_sign_fn(signs):
    if signs is None:
        return None
    s = jnp.asarray(signs)

    def sign_fn(c):
        wrong = ((s == -1) & (c > 0)) | ((s == 1) & (c < 0))
        return jnp.where(wrong, 0.0, c)

    return sign_fn


def stridge_huber(
    X: Array,
    y: Array,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    huber_delta: float = 1.35,
    huber_iter: int = 50,
) -> Array:
    """STRidge with Huber-IRLS inner solves (ks2d_stridge_benchmark.py:472-502)."""
    Xs, _mean, scale = _standardize_data(X)

    def solve_fn(mask):
        return irls_huber(Xs, y, alpha=alpha, delta=huber_delta, max_iter=huber_iter, col_mask=mask)

    c0 = solve_fn(jnp.ones(X.shape[1], dtype=X.dtype))
    c, _m = _threshold_loop(solve_fn, c0, threshold, max_iter)
    return c / (scale + 1e-12)


def trimmed_stridge(
    X: Array,
    y: Array,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    trim_frac: float = 0.1,
) -> Array:
    """STRidge on residual-trimmed rows (ks2d_stridge_benchmark.py:505-549).

    Static shapes: trimming is a 0/1 row-weight vector from an argsort of the
    initial-fit residuals, feeding weighted Gram stats.
    """
    n, p = X.shape
    Xs, _mean, scale = _standardize_data(X)
    full_mask = jnp.ones((p,), dtype=X.dtype)
    ones = jnp.ones((n,), dtype=X.dtype)
    c_init = _masked_weighted_ridge(Xs, y, ones, full_mask, alpha)

    n_trim = int(n * trim_frac)
    if n_trim > 0:
        resid = jnp.abs(y - Xs @ c_init)
        order = jnp.argsort(resid)
        keep = order[: n - n_trim]
        w = jnp.zeros((n,), dtype=X.dtype).at[keep].set(1.0)
    else:
        w = ones

    def solve_fn(mask):
        return _masked_weighted_ridge(Xs, y, w, mask, alpha)

    c0 = solve_fn(full_mask)
    c, _m = _threshold_loop(solve_fn, c0, threshold, max_iter)
    return c / (scale + 1e-12)


def stridge_sign_constrained(
    X: Array,
    y: Array,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    signs: list[int] | None = None,
) -> Array:
    """STRidge with physics-informed sign constraints
    (ks2d_stridge_benchmark.py:552-600): wrong-signed coefficients are zeroed
    before thresholding and again after each refit."""
    Xs, _mean, scale = _standardize_data(X)
    ones_rows = jnp.ones(X.shape[0], dtype=X.dtype)
    sign_fn = _make_sign_fn(signs)

    def solve_fn(mask):
        return _masked_weighted_ridge(Xs, y, ones_rows, mask, alpha)

    c0 = solve_fn(jnp.ones(X.shape[1], dtype=X.dtype))
    c, _m = _threshold_loop(solve_fn, c0, threshold, max_iter, sign_fn=sign_fn)
    return c / (scale + 1e-12)


def bootstrap_indices(
    n: int, n_sub: int, n_bootstrap: int, seed: int
) -> np.ndarray:
    """Host-side bootstrap index sets, reference draw order
    (np.random.default_rng(seed).choice(n, n_sub, replace=True) per member)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n, size=n_sub, replace=True) for _ in range(n_bootstrap)])


@partial(jax.jit, static_argnames=("use_huber", "max_iter", "huber_iter"))
def _ensemble_members(X, y, idx, alpha, threshold, huber_delta, use_huber, max_iter, huber_iter):
    def member(one_idx):
        X_sub = X[one_idx]
        y_sub = y[one_idx]
        if use_huber:
            return stridge_huber(
                X_sub, y_sub, alpha=alpha, threshold=threshold, max_iter=max_iter,
                huber_delta=huber_delta, huber_iter=huber_iter,
            )
        from pdx.solve.stridge import stridge as _stridge

        return _stridge(X_sub, y_sub, alpha=alpha, threshold=threshold, max_iter=max_iter)

    return jax.vmap(member)(idx)


def ensemble_stridge(
    X: Array,
    y: Array,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    n_bootstrap: int = 50,
    subsample_frac: float = 0.7,
    seed: int = 0,
    use_huber: bool = False,
    huber_delta: float = 1.35,
) -> tuple[Array, Array]:
    """Bootstrap-ensemble STRidge (ks2d_stridge_benchmark.py:603-644).

    All members run as one vmapped batch; aggregation is median (robust) with
    std for uncertainty.
    """
    n = y.shape[0]
    n_sub = max(int(n * subsample_frac), 1)
    idx = jnp.asarray(bootstrap_indices(n, n_sub, n_bootstrap, seed))
    all_coeffs = _ensemble_members(
        X, y, idx, alpha, threshold, huber_delta, use_huber, max_iter, 50
    )
    return jnp.median(all_coeffs, axis=0), jnp.std(all_coeffs, axis=0)


def robust_stridge(
    X: Array,
    y: Array,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    use_huber: bool = True,
    huber_delta: float = 1.35,
    trim_frac: float = 0.05,
    n_bootstrap: int = 30,
    signs: list[int] | None = None,
    bootstrap_seed: int = 42,
) -> tuple[Array, dict]:
    """Combined robust pipeline: trim -> bootstrap{(Huber|ridge) + STRidge
    thresholding + sign constraints} -> median/std/95% CI
    (ks2d_stridge_benchmark.py:647-748).

    Note the reference standardizes once globally; bootstrap members are NOT
    restandardized — preserved here.
    """
    n, p = X.shape
    Xs, _mean, scale = _standardize_data(X)
    ones = jnp.ones((n,), dtype=X.dtype)
    full_mask = jnp.ones((p,), dtype=X.dtype)
    c_init = _masked_weighted_ridge(Xs, y, ones, full_mask, alpha)
    resid = jnp.abs(y - Xs @ c_init)

    n_trim = int(n * trim_frac)
    if n_trim > 0:
        order = jnp.argsort(resid)
        keep = order[: n - n_trim]
        Xs_clean = Xs[keep]
        y_clean = y[keep]
    else:
        Xs_clean = Xs
        y_clean = y
    n_clean = n - n_trim

    idx = jnp.asarray(bootstrap_indices(n_clean, int(n_clean * 0.8), n_bootstrap, bootstrap_seed))
    sign_fn = _make_sign_fn(signs)

    def member(one_idx):
        X_sub = Xs_clean[one_idx]
        y_sub = y_clean[one_idx]
        ones_sub = jnp.ones(X_sub.shape[0], dtype=X.dtype)

        if use_huber:
            def solve_fn(mask):
                return irls_huber(X_sub, y_sub, alpha=alpha, delta=huber_delta, col_mask=mask)
        else:
            def solve_fn(mask):
                return _masked_weighted_ridge(X_sub, y_sub, ones_sub, mask, alpha)

        c0 = solve_fn(full_mask)
        c, _m = _threshold_loop(solve_fn, c0, threshold, max_iter)
        if sign_fn is not None:
            c = sign_fn(c)
        return c

    all_coeffs = jax.vmap(member)(idx)  # (B, p)

    denom = scale + 1e-12
    coeffs = jnp.median(all_coeffs, axis=0) / denom
    info = {
        "std": jnp.std(all_coeffs, axis=0) / denom,
        "ci_95_low": jnp.percentile(all_coeffs, 2.5, axis=0) / denom,
        "ci_95_high": jnp.percentile(all_coeffs, 97.5, axis=0) / denom,
        "n_trimmed": n_trim,
        "n_bootstrap": n_bootstrap,
    }
    return coeffs, info
