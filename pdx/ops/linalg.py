"""Ridge / masked-ridge solves and standardization on sufficient statistics.

The device shape of the reference's thousands of tiny ridge solves
(``ks2d_stridge_benchmark.py:55-60`` and every STRidge variant) is: build the
Gram matrix G = X^T X and moment b = X^T y once (one GEMM, optionally
psum-reduced across a sharded sample axis), then every (hyperparameter x
bootstrap x patch) fit is a masked (p, p) solve — vmappable to a single
batched solve.

Support masking keeps shapes static under jit: inactive rows/columns of the
system are replaced by identity rows so the solution is exactly the
active-submatrix solve scattered back to p dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def gram_stats(X: Array, y: Array, weights: Array | None = None) -> dict[str, Array]:
    """Sufficient statistics for (weighted) least squares.

    Returns G = X^T W X, b = X^T W y, sx = column weighted sums, n = total
    weight, syy = y^T W y, sy = sum of W y. With integer weights this exactly
    reproduces bootstrap resampling with replacement.
    """
    if weights is None:
        Xw = X
        yw = y
        n = jnp.asarray(X.shape[0], dtype=X.dtype)
    else:
        Xw = X * weights[:, None]
        yw = y * weights
        n = jnp.sum(weights)
    G = X.T @ Xw
    b = X.T @ yw
    return {
        "G": G,
        "b": b,
        "sx": jnp.sum(Xw, axis=0),
        "n": n,
        "syy": jnp.sum(y * yw),
        "sy": jnp.sum(yw),
    }


def standardized_stats(stats: dict[str, Array]) -> tuple[Array, Array, Array, Array]:
    """Convert raw Gram stats to standardized-column stats.

    Mirrors ``standardize_fit`` (ks2d_stridge_benchmark.py:43-52): per-column
    mean/std, std = 1 where std == 0. Returns (Gs, bs, mean, scale) where
    Gs = Xs^T Xs and bs = Xs^T y for Xs = (X - mean) / scale.

    Note: Xs^T y keeps the full y (the reference does not center y):
    Xs^T y = (b - mean * sy) / scale.
    """
    G, b, sx, n, sy = stats["G"], stats["b"], stats["sx"], stats["n"], stats["sy"]
    mean = sx / n
    var = jnp.diagonal(G, axis1=-2, axis2=-1) / n - mean**2
    std = jnp.sqrt(jnp.maximum(var, 0.0))
    scale = jnp.where(std > _zero_std_tol(mean, std.dtype), std, 1.0)
    Gc = G - n * mean[..., :, None] * mean[..., None, :]
    Gs = Gc / (scale[..., :, None] * scale[..., None, :])
    bs = (b - mean * sy) / scale
    return Gs, bs, mean, scale


def _zero_std_tol(mean: Array, dtype) -> Array:
    """Relative zero-variance cutoff for column standardization.

    NumPy's pairwise summation gives std(ones) == 0 exactly, so the
    reference's ``std > 0`` guard works; XLA's reduction order can leave
    O(eps) residual std on exactly-constant columns (measured 1.1e-16 on a
    ones column), and dividing coefficients by that residual blows them up
    by ~1e16.

    The cutoff must be relative to |mean| ONLY: a constant column's residual
    std is O(eps * |mean|), while a genuine zero-mean column with tiny std
    (weak-form integral features are routinely ~1e-6) must still be
    standardized — an absolute floor here broke the weak-form golden parity.
    Exactly-zero columns fall out via the strict ``std > 0`` comparison."""
    eps = jnp.finfo(dtype).eps
    return jnp.sqrt(eps) * 10.0 * jnp.abs(mean)


def ridge_solve(G: Array, b: Array, alpha: float | Array) -> Array:
    """Solve (G + alpha I) c = b (normal-equation ridge, no intercept).

    Parity: ``ridge_fit`` (ks2d_stridge_benchmark.py:55-60).
    """
    p = G.shape[-1]
    eye = jnp.eye(p, dtype=G.dtype)
    return jnp.linalg.solve(G + alpha * eye, b[..., None])[..., 0]


def masked_ridge_solve(G: Array, b: Array, mask: Array, alpha: float | Array) -> Array:
    """Ridge solve restricted to the active support, with static shapes.

    Equivalent to solving (G[m, m] + alpha I) c_m = b[m] and scattering c_m
    back: inactive rows/cols are replaced by identity rows with zero RHS.
    """
    p = G.shape[-1]
    m = mask.astype(G.dtype)
    eye = jnp.eye(p, dtype=G.dtype)
    A = (
        G * (m[..., :, None] * m[..., None, :])
        + alpha * eye * m[..., None, :] * jnp.ones_like(m)[..., :, None]
        + eye * (1.0 - m)[..., None, :]
    )
    rhs = b * m
    sol = jnp.linalg.solve(A, rhs[..., None])[..., 0]
    return sol * m


def column_standardize_stats(X: Array) -> tuple[Array, Array]:
    """(mean, scale) per column; scale = std with zeros replaced by 1.

    Parity: ``standardize_fit`` (ks2d_stridge_benchmark.py:43-48).
    """
    mean = jnp.mean(X, axis=0)
    std = jnp.std(X, axis=0)
    scale = jnp.where(std > _zero_std_tol(mean, std.dtype), std, 1.0)
    return mean, scale


def test_sse_from_stats(c: Array, G_te: Array, b_te: Array, syy_te: Array) -> Array:
    """Sum of squared residuals ||X_te c - y_te||^2 from test sufficient stats."""
    quad = jnp.einsum("...p,...pq,...q->...", c, G_te, c)
    cross = jnp.einsum("...p,...p->...", c, b_te)
    return quad - 2.0 * cross + syy_te
