"""1-D SINDy pipeline: discovery on (noisy / shifted / varying-IC) KS-1D data.

Covers the notebook 06/07/10 workflow (BASELINE.json configs[2], "1D SINDy on
noisy synthetic data"): spectral vs finite-difference derivative backends,
denoising bank (spectral low-pass, Gaussian, Savitzky-Golay), 1-D
registration (cross-correlation / phase-correlation integer alignment to a
mean reference), Lasso/STRidge/least-squares regression on the KS library
[u_xx, u_xxxx, (u^2)_x], ensemble over ICs, MAD noise estimation, and
F1-score support recovery vs ground truth (a, b, c) = (-1, -1, -0.5).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array

from pdx.sim.ks1d import Ks1dConfig, simulate_ks1d, spatially_shifted_data, varying_ic_data
from pdx.ops.spectral import spectral_derivative_1d, lowpass_1d
from pdx.ops.fd import d4_1d_periodic
from pdx.ops.filters import gaussian_filter1d_reflect, savgol_time
from pdx.ops.metrics import f1_support_score, r2_score
from pdx.ops.linalg import gram_stats
from pdx.solve.stridge import stridge_from_stats
from pdx.solve.lasso import lasso_ista

KS1D_TRUE = np.array([-1.0, -1.0, -0.5])  # [u_xx, u_xxxx, (u^2)_x]


@dataclass(frozen=True)
class Sindy1dConfig:
    L: float = 100.0
    N: int = 200
    dt: float = 0.05
    n_steps: int = 2000
    scenario: str = "clean"  # clean | noisy | shifted | varying_ic
    noise_rel: float = 0.05
    noise_seed: int = 0
    derivative: str = "spectral"  # spectral | finite
    denoise: str = "none"  # none | spectral | gaussian | savgol
    denoise_keep_frac: float = 0.33
    denoise_sigma: float = 1.0
    savgol_window: int = 7
    savgol_poly: int = 3
    register: bool = False
    register_method: str = "crosscorr"  # crosscorr | phasecorr
    regressor: str = "lasso"  # lasso | stridge | lstsq
    lasso_alpha: float = 1e-3
    stridge_alpha: float = 1e-6
    stridge_threshold: float = 1e-3
    subsample: int = 50_000
    dtype: str = "float64"


@partial(jax.jit, static_argnames=("derivative",))
def build_library_1d(U: Array, L: float, dt: float, derivative: str) -> tuple[Array, Array]:
    """X = [u_xx, u_xxxx, (u^2)_x] on frames U[:-1], y = forward-difference u_t.
    Jitted: one program instead of an eager dispatch per op."""
    Uk = U[:-1]
    ut = (U[1:] - Uk) / dt
    if derivative == "spectral":
        uxx = spectral_derivative_1d(Uk, L, order=2)
        uxxxx = spectral_derivative_1d(Uk, L, order=4)
        u2x = spectral_derivative_1d(Uk**2, L, order=1)
    else:
        dx = L / U.shape[-1]
        ux_m = jnp.roll(Uk, 1, -1)
        ux_p = jnp.roll(Uk, -1, -1)
        uxx = (ux_p - 2 * Uk + ux_m) / dx**2
        uxxxx = d4_1d_periodic(Uk, dx)
        u2 = Uk**2
        u2x = (jnp.roll(u2, -1, -1) - jnp.roll(u2, 1, -1)) / (2 * dx)
    X = jnp.stack([uxx.reshape(-1), uxxxx.reshape(-1), u2x.reshape(-1)], axis=1)
    return X, ut.reshape(-1)


@partial(jax.jit, static_argnames=("method",))
def register_1d(U: Array, method: str = "crosscorr") -> Array:
    """Integer alignment of each frame to the mean reference frame.

    crosscorr: argmax of periodic cross-correlation (notebook 10 c26
    find_shift_crosscorr, computed via FFT for all frames at once).
    phasecorr: argmax of the normalized cross-power spectrum.
    """
    ref = jnp.mean(U, axis=0)
    F_ref = jnp.fft.fft(ref)
    F_u = jnp.fft.fft(U)
    cross = F_u * jnp.conj(F_ref)
    if method == "phasecorr":
        cross = cross / (jnp.abs(cross) + 1e-12)
    corr = jnp.fft.ifft(cross).real  # corr[s] = sum u(x) ref(x - s)
    n = U.shape[-1]
    shift = jnp.argmax(corr, axis=-1)
    shift = jnp.where(shift > n // 2, shift - n, shift)
    return jax.vmap(lambda u, s: jnp.roll(u, -s))(U, shift)


@jax.jit
def estimate_noise_mad(U: Array) -> Array:
    """Robust noise-level estimate from the second spatial difference:
    sigma ~ 1.4826 * MAD(u[i+1] - 2 u[i] + u[i-1]) / sqrt(6).

    For smooth signals the second difference is noise-dominated (O(dx^2)
    signal content), so this stays near zero on clean data and tracks the
    injected sigma on noisy data (the role of notebook 10's MAD estimator).
    """
    d2 = U[2:] - 2 * U[1:-1] + U[:-2]  # temporal: signal content O(dt^2)
    return 1.4826 * jnp.median(jnp.abs(d2)) / jnp.sqrt(6.0)


def run(cfg: Sindy1dConfig) -> dict[str, Any]:
    from pdx.utils.precision import resolve_dtype

    resolve_dtype(cfg.dtype)
    sim = Ks1dConfig(L=cfg.L, N=cfg.N, dt=cfg.dt, n_steps=cfg.n_steps)

    if cfg.scenario == "shifted":
        U, _true_shifts = spatially_shifted_data(sim)
    elif cfg.scenario == "varying_ic":
        U = varying_ic_data(sim)
    else:
        U = simulate_ks1d(sim)
        if cfg.scenario == "noisy":
            rng = np.random.default_rng(cfg.noise_seed)
            sigma = cfg.noise_rel * float(jnp.std(U))
            U = U + jnp.asarray(rng.normal(0, sigma, size=U.shape), dtype=U.dtype)

    noise_est = float(estimate_noise_mad(U))

    if cfg.register:
        U = register_1d(U, cfg.register_method)

    if cfg.denoise == "spectral":
        U = lowpass_1d(U, cfg.denoise_keep_frac)
    elif cfg.denoise == "gaussian":
        U = gaussian_filter1d_reflect(U, cfg.denoise_sigma, axis=-1)
    elif cfg.denoise == "savgol":
        U = savgol_time(U, cfg.savgol_window, cfg.savgol_poly)

    X, y = build_library_1d(U, cfg.L, cfg.dt, cfg.derivative)
    n_total = int(y.shape[0])
    if n_total > cfg.subsample:
        idx = np.random.default_rng(0).choice(n_total, cfg.subsample, replace=False)
        X, y = X[jnp.asarray(idx)], y[jnp.asarray(idx)]

    if cfg.regressor == "lasso":
        coef, _b = lasso_ista(X, y, cfg.lasso_alpha, max_iter=5000, fit_intercept=False)
    elif cfg.regressor == "stridge":
        coef = stridge_from_stats(
            gram_stats(X, y), alpha=cfg.stridge_alpha, threshold=cfg.stridge_threshold
        ).coeffs
    else:
        stats = gram_stats(X, y)
        coef = jnp.linalg.solve(
            stats["G"] + 1e-12 * jnp.eye(3, dtype=X.dtype), stats["b"]
        )

    coef_np = np.asarray(coef)
    rel_err = np.abs(coef_np - KS1D_TRUE) / np.abs(KS1D_TRUE) * 100.0
    y_pred = X @ coef
    return {
        "config": dataclasses.asdict(cfg),
        "term_names": ["u_xx", "u_xxxx", "(u^2)_x"],
        "coeffs": coef_np,
        "true_coeffs": KS1D_TRUE,
        "rel_err_pct": rel_err,
        "r2": float(r2_score(y, y_pred)),
        "f1_support": float(f1_support_score(jnp.asarray(coef_np), jnp.asarray(KS1D_TRUE), tol=1e-2)),
        "noise_mad_estimate": noise_est,
    }


def ensemble_over_ics(cfg: Sindy1dConfig, n_ics: int = 5, seed: int = 0) -> dict[str, Any]:
    """Discovery over an ensemble of random initial conditions
    (notebook 10's ensemble-IC study): median aggregate + std."""
    rng = np.random.default_rng(seed)
    sim = Ks1dConfig(L=cfg.L, N=cfg.N, dt=cfg.dt, n_steps=cfg.n_steps)
    coefs = []
    for _ in range(n_ics):
        u0 = jnp.asarray(rng.normal(0, 1, cfg.N) * 0.1)
        U = simulate_ks1d(sim, u0=u0)
        X, y = build_library_1d(U, cfg.L, cfg.dt, cfg.derivative)
        coef = stridge_from_stats(gram_stats(X, y), alpha=1e-8, threshold=1e-3).coeffs
        coefs.append(np.asarray(coef))
    C = np.stack(coefs)
    return {"median": np.median(C, axis=0), "std": C.std(axis=0), "all": C}


def cmd_sindy1d(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx sindy1d")
    parser.add_argument("--scenario", choices=["clean", "noisy", "shifted", "varying_ic"], default="clean")
    parser.add_argument("--noise-rel", type=float, default=0.05)
    parser.add_argument("--derivative", choices=["spectral", "finite"], default="spectral")
    parser.add_argument("--denoise", choices=["none", "spectral", "gaussian", "savgol"], default="none")
    parser.add_argument("--register", action="store_true")
    parser.add_argument("--regressor", choices=["lasso", "stridge", "lstsq"], default="lasso")
    parser.add_argument("--n-steps", type=int, default=2000)
    args = parser.parse_args(argv)
    out = run(
        Sindy1dConfig(
            scenario=args.scenario, noise_rel=args.noise_rel, derivative=args.derivative,
            denoise=args.denoise, register=args.register, regressor=args.regressor,
            n_steps=args.n_steps,
        )
    )
    print(f"Estimated noise (MAD): {out['noise_mad_estimate']:.4g}")
    for n, c, t, e in zip(out["term_names"], out["coeffs"], out["true_coeffs"], out["rel_err_pct"]):
        print(f"  {n:9s}: est={c:+.6f}  true={t:+.2f}  rel_err={e:.2f}%")
    print(f"R2={out['r2']:.6f}  F1(support)={out['f1_support']:.3f}")
    return 0
