"""Smoothing / denoising filter bank.

Parity targets:
  * ``ks2d_stridge_benchmark.py:145-161`` — reflect-padded temporal moving
    average via cumsum;
  * ``ks2d_stridge_benchmark.py:1003-1014`` — 1-D edge-padded moving average;
  * scipy.ndimage.gaussian_filter / median_filter as used by
    ``analyze_results.py:217,246`` and ``comprehensive_benchmark.py:168-239``;
  * ``comprehensive_benchmark.py:190-203`` — hand-rolled TV iteration;
  * scipy.signal.savgol_filter (temporal, mode="interp") as used by
    ``pde_discovery_improved_registration.py:370`` and
    ``patch_based_sindy.py:88-119``.

All filters are pure jittable functions acting on the trailing axes (or axis 0
for temporal filters) and batch freely.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array


def time_smooth_moving_average(U: Array, window: int) -> Array:
    """Centered moving average along axis 0 with reflect padding.

    Parity: ``ks2d_stridge_benchmark.py:145-161`` (odd window required).
    """
    window = int(window)
    if window <= 1:
        return U
    if window % 2 == 0:
        raise ValueError("temporal moving-average window must be an odd integer")
    pad = window // 2
    U_pad = jnp.pad(U, [(pad, pad)] + [(0, 0)] * (U.ndim - 1), mode="reflect")
    zero = jnp.zeros_like(U_pad[:1])
    cs = jnp.concatenate([zero, jnp.cumsum(U_pad, axis=0)], axis=0)
    return (cs[window:] - cs[:-window]) / float(window)


def smooth_1d(x: Array, window: int) -> Array:
    """Centered moving average on the trailing axis with edge padding.

    Parity: ``ks2d_stridge_benchmark.py:1003-1014`` (even windows are bumped
    to the next odd value).
    """
    w = int(window)
    if w <= 1:
        return x
    if w % 2 == 0:
        w += 1
    pad = w // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    cs = jnp.concatenate([jnp.zeros_like(xp[..., :1]), jnp.cumsum(xp, axis=-1)], axis=-1)
    return (cs[..., w:] - cs[..., :-w]) / float(w)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d semantics (order 0)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    return phi / phi.sum()


@partial(jax.jit, static_argnames=("sigma", "truncate"))
def gaussian_filter_reflect(f: Array, sigma: float, truncate: float = 4.0) -> Array:
    """Separable Gaussian filter matching scipy.ndimage.gaussian_filter defaults.

    Jitted with static sigma: the eager per-tap loop dispatched ~2*radius
    primitives per axis (55 s of a 115 s analyze preprocess on a slow
    CPU host).

    scipy's default mode is "reflect" = symmetric padding (edge sample
    repeated), radius = int(truncate * sigma + 0.5). Acts on the trailing two
    axes.
    """
    sigma = float(sigma)
    if sigma <= 0:
        return f
    radius = int(truncate * sigma + 0.5)
    from pdx.ops.interp import _SEP_PREC, band_matrix, use_banded_sep

    if use_banded_sep():
        # accelerator lowering: one banded matmul per axis — see
        # interp.band_matrix; the shifted-add sweep below issues 2*radius+1
        # vector ops per axis
        kt = tuple(np.asarray(_gaussian_kernel1d(sigma, radius), np.float64))
        H, W = f.shape[-2], f.shape[-1]
        Mh = jnp.asarray(band_matrix(kt, H), f.dtype)
        Mw = jnp.asarray(band_matrix(kt, W), f.dtype)
        out = jnp.einsum("hp,...pw->...hw", Mh, f, precision=_SEP_PREC)
        return jnp.einsum("wv,...hv->...hw", Mw, out, precision=_SEP_PREC)

    k = jnp.asarray(_gaussian_kernel1d(sigma, radius), dtype=f.dtype)

    def conv_axis(x: Array, axis: int) -> Array:
        pads = [(0, 0)] * x.ndim
        pads[axis] = (radius, radius)
        xp = jnp.pad(x, pads, mode="symmetric")
        xp = jnp.moveaxis(xp, axis, -1)
        # correlate with symmetric kernel == convolve
        n = xp.shape[-1]
        out = jnp.zeros(xp.shape[:-1] + (n - 2 * radius,), dtype=x.dtype)
        for i in range(2 * radius + 1):
            out = out + k[i] * xp[..., i : n - 2 * radius + i]
        return jnp.moveaxis(out, -1, axis)

    out = conv_axis(f, f.ndim - 2)
    out = conv_axis(out, f.ndim - 1)
    return out


@partial(jax.jit, static_argnames=("sigma", "axis", "truncate"))
def gaussian_filter1d_reflect(x: Array, sigma: float, axis: int = -1, truncate: float = 4.0) -> Array:
    """1-D scipy-compatible Gaussian filter along ``axis`` (jitted, static sigma)."""
    sigma = float(sigma)
    if sigma <= 0:
        return x
    radius = int(truncate * sigma + 0.5)
    k = jnp.asarray(_gaussian_kernel1d(sigma, radius), dtype=x.dtype)
    pads = [(0, 0)] * x.ndim
    pads[axis] = (radius, radius)
    xp = jnp.pad(x, pads, mode="symmetric")
    xp = jnp.moveaxis(xp, axis, -1)
    n = xp.shape[-1]
    out = jnp.zeros(xp.shape[:-1] + (n - 2 * radius,), dtype=x.dtype)
    for i in range(2 * radius + 1):
        out = out + k[i] * xp[..., i : n - 2 * radius + i]
    return jnp.moveaxis(out, -1, axis)


def median_filter_3x3(f: Array) -> Array:
    """3x3 median filter with symmetric (scipy 'reflect') borders.

    Parity: scipy.ndimage.median_filter(size=3) as used in
    ``comprehensive_benchmark.py:181-186``.
    """
    return median_filter_2d(f, 3)


def median_filter_2d(f: Array, size: int = 3) -> Array:
    """Odd-size k x k median filter with symmetric (scipy 'reflect') borders.

    Parity: scipy.ndimage.median_filter(size=k) — the reference exposes the
    ``size`` parameter (comprehensive_benchmark.py:179-183) though it only
    ever calls size=3. Implementation: the k^2 shifted window views stacked
    on a trailing axis and sorted — a rank filter as one fused sort over a
    static-size axis, batched over every leading (time/patch) axis. Window
    materialization is k^2 x the field size; fine for the k in {3,5,7}
    denoising range this bank targets.
    """
    k = int(size)
    if k < 1 or k % 2 == 0:
        raise ValueError(f"median filter size must be odd and >= 1, got {size}")
    if k == 1:
        return f
    n = k // 2
    pads = [(0, 0)] * (f.ndim - 2) + [(n, n), (n, n)]
    p = jnp.pad(f, pads, mode="symmetric")
    stack = jnp.stack(
        [p[..., i : i + f.shape[-2], j : j + f.shape[-1]] for i in range(k) for j in range(k)],
        axis=-1,
    )
    return jnp.sort(stack, axis=-1)[..., (k * k) // 2]


def tv_denoise(f: Array, weight: float = 0.1, n_iter: int = 50) -> Array:
    """Hand-rolled TV-flavored smoothing iteration.

    Parity: ``comprehensive_benchmark.py:190-203`` — forward-difference
    gradients with wrap, normalized divergence, and the (unusual)
    ``u = data + weight * div`` update that re-anchors to the input each step.
    Acts on the trailing two axes; iterations unrolled under jit via scan.
    """
    import jax

    def step(u, _):
        gx = jnp.roll(u, -1, axis=-2) - u
        gy = jnp.roll(u, -1, axis=-1) - u
        norm = jnp.sqrt(gx**2 + gy**2 + 1e-8)
        div = (gx - jnp.roll(gx, 1, axis=-2)) / norm + (gy - jnp.roll(gy, 1, axis=-1)) / norm
        return f + weight * div, None

    out, _ = jax.lax.scan(step, f, None, length=int(n_iter))
    return out


def gaussian_filter3d_reflect(U: Array, sigma_t: float, sigma_s: float, truncate: float = 4.0) -> Array:
    """Separable 3-D (t, y, x) Gaussian with scipy-compatible reflect borders
    (notebook 09's 3-D denoising: scipy gaussian_filter with a
    (sigma_t, sigma_s, sigma_s) tuple)."""
    out = U
    if sigma_t > 0:
        out = gaussian_filter1d_reflect(out, sigma_t, axis=0, truncate=truncate)
    if sigma_s > 0:
        out = gaussian_filter_reflect(out, sigma_s, truncate=truncate)
    return out


def tv_denoise_curvature(f: Array, weight: float = 0.05, n_iter: int = 3) -> Array:
    """Curvature-flow TV variant (notebook 08 ``denoise_total_variation``):
    iterate img += weight * div(grad img / |grad img|) with np.gradient
    derivatives; unlike :func:`tv_denoise` this does NOT re-anchor to the
    input each step and is bounded for weak gradients (unit-gradient
    divergence = curvature)."""
    import jax

    def grad(a, axis):
        return jnp.gradient(a, axis=axis)

    def step(img, _):
        gx = grad(img, -2)
        gy = grad(img, -1)
        mag = jnp.sqrt(gx**2 + gy**2) + 1e-8
        div = grad(gx / mag, -2) + grad(gy / mag, -1)
        return img + weight * div, None

    out, _ = jax.lax.scan(step, f, None, length=int(n_iter))
    return out


def _savgol_coeffs(window: int, polyorder: int) -> np.ndarray:
    """Savitzky-Golay smoothing coefficients (scipy.signal.savgol_coeffs,
    deriv=0): least-squares fit of a degree-``polyorder`` polynomial over the
    centered window, evaluated at the center."""
    if window % 2 == 0:
        raise ValueError("savgol window must be odd")
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)  # (window, p+1)
    # coeffs c s.t. smoothed center = c @ values; c = e0^T (A^T A)^-1 A^T
    ATA = A.T @ A
    rhs = np.zeros(polyorder + 1)
    rhs[0] = 1.0
    sol = np.linalg.solve(ATA, rhs)
    return A @ sol  # (window,)


@partial(jax.jit, static_argnames=("window", "polyorder"))
def savgol_time(U: Array, window: int, polyorder: int) -> Array:
    """Savitzky-Golay filter along axis 0 with scipy's mode="interp" edges.

    Interior: correlation with the smoothing kernel. Edges: exact polynomial
    least-squares fit over the first/last ``window`` samples evaluated at the
    edge positions (scipy.signal.savgol_filter mode="interp" semantics).
    """
    window = int(window)
    polyorder = int(polyorder)
    T = U.shape[0]
    if window > T:
        raise ValueError("savgol window longer than sequence")
    half = window // 2
    coeffs = jnp.asarray(_savgol_coeffs(window, polyorder), dtype=U.dtype)

    # interior via shifted sum
    interior = jnp.zeros((T - 2 * half,) + U.shape[1:], dtype=U.dtype)
    for i in range(window):
        interior = interior + coeffs[i] * U[i : T - 2 * half + i]

    # edge fits: degree-polyorder LSQ over first/last `window` samples
    x = np.arange(window, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)
    # evaluation matrices: P_edge[i] = row that maps window-values -> fitted value at pos i
    proj = A @ np.linalg.solve(A.T @ A, A.T)  # (window, window)
    Pl = jnp.asarray(proj[:half], dtype=U.dtype)  # evaluate at 0..half-1
    Pr = jnp.asarray(proj[window - half :], dtype=U.dtype)  # last half positions

    first = jnp.tensordot(Pl, U[:window], axes=(1, 0))
    last = jnp.tensordot(Pr, U[T - window :], axes=(1, 0))
    return jnp.concatenate([first, interior, last], axis=0)
