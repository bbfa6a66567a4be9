"""Local 3-D polynomial (Savitzky-Golay style) derivative estimation — batched.

Parity: _poly3d_exponents / _poly3d_design / local_poly_derivatives
(patch_based_pde_discovery.py:176-246): fit p(t, x, y) of total degree ``deg``
over a (2rt+1) x (2rs+1) x (2rs+1) neighborhood by least squares and read
(u, u_t, u_x, u_y, u_xx, u_yy) from the coefficients.

Key idea: the design matrix A depends only on the (fixed) offset
grid, never on the point — the reference recomputes A and calls lstsq per
sample point (thousands of LAPACK calls); here the extraction operator
E = S @ pinv(A) is computed once on the host and every point's derivatives are
one row of a single (n_points, K) x (K, 6) GEMM after a batched gather.
Numerically identical to per-point lstsq (same minimum-norm LS solution).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from jax import Array


def poly3d_exponents(deg: int) -> list[tuple[int, int, int]]:
    """Exponent enumeration order parity: patch_based_pde_discovery.py:176-182."""
    exps: list[tuple[int, int, int]] = []
    for a in range(deg + 1):
        for b in range(deg + 1 - a):
            for c in range(deg + 1 - a - b):
                exps.append((a, b, c))
    return exps


@lru_cache(maxsize=32)
def _extraction_operator(rt: int, rs: int, deg: int, dt: float, dx: float, dy: float) -> np.ndarray:
    """E[(K, 6)] mapping flattened neighborhood values -> (u, ut, ux, uy, uxx, uyy).

    Neighborhood flattening order matches the reference: meshgrid(tt, yy, xx,
    indexing='ij').ravel() with local physical coordinates (t*dt, y*dy, x*dx);
    design built on (t, x, y) per the reference call signature.
    """
    t_off = np.arange(-rt, rt + 1, dtype=np.float64) * dt
    y_off = np.arange(-rs, rs + 1, dtype=np.float64) * dy
    x_off = np.arange(-rs, rs + 1, dtype=np.float64) * dx
    Tt, Yy, Xx = np.meshgrid(t_off, y_off, x_off, indexing="ij")
    t_flat, x_flat, y_flat = Tt.ravel(), Xx.ravel(), Yy.ravel()

    exps = poly3d_exponents(deg)
    A = np.column_stack([(t_flat**a) * (x_flat**b) * (y_flat**c) for a, b, c in exps])
    pinv = np.linalg.pinv(A)  # (n_coefs, K)

    def row(a, b, c, scale=1.0):
        try:
            i = exps.index((a, b, c))
        except ValueError:
            return np.zeros(pinv.shape[1])
        return scale * pinv[i]

    E = np.stack(
        [
            row(0, 0, 0),
            row(1, 0, 0),
            row(0, 1, 0),
            row(0, 0, 1),
            row(0, 2, 0, 2.0),
            row(0, 0, 2, 2.0),
        ],
        axis=1,
    )  # (K, 6)
    return E


def local_poly_derivatives_batch(
    U: Array,
    points: np.ndarray | Array,
    *,
    rt: int,
    rs: int,
    deg: int,
    dt: float,
    dx: float,
    dy: float,
) -> Array:
    """Derivatives for a batch of points.

    ``U`` is (T, H, W) indexed U[t, y, x]; ``points`` is (N, 3) int rows
    (t0, y0, x0). Returns (N, 6): (u, u_t, u_x, u_y, u_xx, u_yy).
    """
    pts = jnp.asarray(points)
    T, H, W = U.shape
    Kt, Ks = 2 * rt + 1, 2 * rs + 1
    ot = jnp.arange(-rt, rt + 1)
    os_ = jnp.arange(-rs, rs + 1)
    ti = pts[:, 0:1, None, None] + ot[None, :, None, None]  # (N, Kt, 1, 1)
    yi = pts[:, 1:2, None, None] + os_[None, None, :, None]  # (N, 1, Ks, 1)
    xi = pts[:, 2:3, None, None] + os_[None, None, None, :]  # (N, 1, 1, Ks)
    flat_idx = (ti * H + yi) * W + xi  # broadcast -> (N, Kt, Ks, Ks)
    vals = U.reshape(-1)[flat_idx].reshape(pts.shape[0], Kt * Ks * Ks)

    E = jnp.asarray(_extraction_operator(rt, rs, deg, float(dt), float(dx), float(dy)), dtype=U.dtype)
    return vals @ E  # (N, 6)
