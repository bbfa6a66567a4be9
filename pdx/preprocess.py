"""Denoising/preprocessor bank (L2).

Parity: preprocess_* (comprehensive_benchmark.py:168-239) — Gaussian, median,
hand-rolled TV, bilateral approximation, temporal window mean, per-frame
z-score detrend, global exponential detrend. All batched device ops, jitted
(one program per stage instead of an eager dispatch per op).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.filters import gaussian_filter_reflect, median_filter_3x3, tv_denoise


def preprocess_none(U: Array) -> Array:
    return U


@partial(jax.jit, static_argnames=("sigma",))
def preprocess_gaussian(U: Array, sigma: float = 1.0) -> Array:
    return gaussian_filter_reflect(U, sigma)


@partial(jax.jit, static_argnames=("out_h", "out_w", "sigma", "eps", "dtype_name"))
def resize_denoise_normalize(
    U_raw: Array, *, out_h: int, out_w: int, sigma: float, eps: float = 0.0,
    dtype_name: str = "float64",
) -> Array:
    """Fused preprocessing head shared by the real-image pipelines:
    INTER_AREA downsample -> cast -> Gaussian denoise -> min-max normalize
    as ONE compiled program.

    The downsample runs at the input dtype BEFORE the f64 cast — for u8/u16
    frames the 2x block mean is exact in f32 (sums of <=4 integers are
    representable), so results are bit-identical to the cast-first order
    while moving 4x less data through this host's slow memory (the cast-
    first formulation cost ~40 s of the analyze warm path on CPU).
    """
    from pdx.ops.interp import resize_area

    U = resize_area(U_raw, out_h, out_w)
    U = U.astype(jnp.dtype(dtype_name))
    U = gaussian_filter_reflect(U, sigma)
    return (U - U.min()) / (U.max() - U.min() + eps)


@partial(jax.jit, static_argnames=("size",))
def preprocess_median(U: Array, size: int = 3) -> Array:
    """Odd-size median filter (comprehensive_benchmark.py:179-183 exposes
    size=; only size=3 is ever called there)."""
    from pdx.ops.filters import median_filter_2d

    return median_filter_2d(U, size)


@partial(jax.jit, static_argnames=("weight", "n_iter"))
def preprocess_tv(U: Array, weight: float = 0.1, n_iter: int = 50) -> Array:
    return tv_denoise(U, weight=weight, n_iter=n_iter)


@partial(jax.jit, static_argnames=("sigma_s", "sigma_r"))
def preprocess_bilateral(U: Array, sigma_s: float = 2.0, sigma_r: float = 0.1) -> Array:
    """Bilateral-like filtering (comprehensive_benchmark.py:204-212)."""
    smoothed = gaussian_filter_reflect(U, sigma_s)
    diff = U - smoothed
    w = jnp.exp(-(diff**2) / (2.0 * sigma_r**2))
    return w * U + (1.0 - w) * smoothed


@partial(jax.jit, static_argnames=("window",))
def preprocess_temporal(U: Array, window: int = 3) -> Array:
    """Clamped temporal window mean (comprehensive_benchmark.py:214-221):
    frame i averages frames [max(0, i-h), min(T, i+h+1)) — edge windows
    shrink rather than reflect."""
    T = U.shape[0]
    half = window // 2
    zero = jnp.zeros_like(U[:1])
    cs = jnp.concatenate([zero, jnp.cumsum(U, axis=0)], axis=0)  # (T+1, ...)
    i = jnp.arange(T)
    lo = jnp.maximum(0, i - half)
    hi = jnp.minimum(T, i + half + 1)
    sums = cs[hi] - cs[lo]
    counts = (hi - lo).astype(U.dtype).reshape((-1,) + (1,) * (U.ndim - 1))
    return sums / counts


@jax.jit
def preprocess_detrend(U: Array) -> Array:
    """Per-frame z-score (comprehensive_benchmark.py:223-229)."""
    mean = U.mean(axis=(-2, -1), keepdims=True)
    std = U.std(axis=(-2, -1), keepdims=True)
    return (U - mean) / (std + 1e-10)


@jax.jit
def preprocess_detrend_global(U: Array) -> Array:
    """Divide out a fitted global exponential intensity trend, then z-score
    the whole stack (comprehensive_benchmark.py:231-239)."""
    T = U.shape[0]
    means = U.mean(axis=(-2, -1))
    t = jnp.arange(T, dtype=U.dtype)
    log_means = jnp.log(jnp.abs(means) + 1e-10)
    # linear fit in log space (closed form)
    tbar = t.mean()
    lbar = log_means.mean()
    slope = jnp.sum((t - tbar) * (log_means - lbar)) / jnp.sum((t - tbar) ** 2)
    intercept = lbar - slope * tbar
    trend = jnp.exp(slope * t + intercept)
    out = U / (trend[:, None, None] + 1e-10)
    return (out - out.mean()) / (out.std() + 1e-10)


@partial(jax.jit, static_argnames=("noise_type", "noise_level"))
def preprocess_adaptive(U: Array, noise_type: str = "gaussian", noise_level: float = 0.1) -> Array:
    """Adaptive denoising policy (notebook 08 cell 5 ``denoise_adaptive``):
    escalate from temporal Savitzky-Golay to + light spatial Gaussian to + TV
    as the (estimated) noise level grows; median-first for impulse noise."""
    from pdx.ops.filters import savgol_time

    if noise_type == "gaussian":
        if noise_level <= 0.1:
            return savgol_time(U, 5, 2)
        if noise_level <= 0.5:
            return gaussian_filter_reflect(savgol_time(U, 5, 2), 0.3)
        from pdx.ops.filters import tv_denoise_curvature

        out = gaussian_filter_reflect(savgol_time(U, 7, 2), 0.5)
        return tv_denoise_curvature(out, weight=0.05, n_iter=2)
    # impulse (salt & pepper) noise
    if noise_level <= 0.1:
        return median_filter_3x3(U)
    out = median_filter_3x3(U)
    return savgol_time(out, 5, 2)


@partial(jax.jit, static_argnames=("n_bins",))
def poisson_noise_check(U: Array, n_bins: int = 20) -> dict[str, Array]:
    """Photon-noise diagnostic (notebook 09's Poisson-noise check): bin pixels
    by local mean intensity and regress local variance on mean. A slope ~ 1
    (in photon units) indicates Poisson-dominated noise; ~ 0 indicates
    additive Gaussian noise.

    Local mean/variance come from the temporal axis (per-pixel statistics
    over frames), which separates noise from static spatial structure.
    """
    mean_px = jnp.mean(U, axis=0).reshape(-1)
    var_px = jnp.var(U, axis=0).reshape(-1)
    lo, hi = jnp.quantile(mean_px, 0.02), jnp.quantile(mean_px, 0.98)
    edges = jnp.linspace(lo, hi, n_bins + 1)
    idx = jnp.clip(jnp.searchsorted(edges, mean_px) - 1, 0, n_bins - 1)
    counts = jnp.zeros(n_bins).at[idx].add(1.0)
    mean_bin = jnp.zeros(n_bins).at[idx].add(mean_px) / jnp.maximum(counts, 1)
    var_bin = jnp.zeros(n_bins).at[idx].add(var_px) / jnp.maximum(counts, 1)
    valid = counts > 10
    x = jnp.where(valid, mean_bin, 0.0)
    y = jnp.where(valid, var_bin, 0.0)
    n = jnp.sum(valid)
    xm = jnp.sum(x) / n
    ym = jnp.sum(y) / n
    cov = jnp.sum(jnp.where(valid, (x - xm) * (y - ym), 0.0))
    varx = jnp.sum(jnp.where(valid, (x - xm) ** 2, 0.0))
    slope = cov / (varx + 1e-30)
    return {
        "slope": slope,
        "intercept": ym - slope * xm,
        "mean_bins": mean_bin,
        "var_bins": var_bin,
        "bin_counts": counts,
    }


PREPROCESSORS = {
    "none": preprocess_none,
    "gaussian": preprocess_gaussian,
    "median": preprocess_median,
    "tv": preprocess_tv,
    "bilateral": preprocess_bilateral,
    "temporal": preprocess_temporal,
    "detrend": preprocess_detrend,
    "detrend_global": preprocess_detrend_global,
    "adaptive": preprocess_adaptive,
}
