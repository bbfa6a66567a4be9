"""Comprehensive benchmark: 21 discovery methods x 8 corruption regimes.

End-to-end parity with ``scripts/comprehensive_benchmark.py``: KS-2D on a
64x64 grid (dt=1e-4, save_every=50, clip guard, deterministic sin/cos IC) ->
corruption suite N1-N7 -> methods M01-M21 (preprocessor bank, robust
regressors, Fourier derivatives, convolutional weak form, frame-bootstrap
ensemble, DMD preconditioners, detrending) -> per-(noise, method) relative
coefficient error, rankings, JSON dump.

Reference quirks preserved: the FD biharmonic uses dx for both axes
(comprehensive_benchmark.py:344-350, valid since dx == dy); the weak-form
method draws subsample indices but fits on the full library (:449-453) — the
draw is still consumed to keep the RNG stream aligned. Reference bug fixed:
the hardcoded absolute output path (:661) is a config field.

Method deviations (documented): M07 uses Huber-IRLS with MAD scale rather
than sklearn's concomitant-scale L-BFGS HuberRegressor; M08 implements
textbook RANSAC (100 trials, MAD threshold) rather than sklearn's; both are
the same estimator families and are validated by ranking behavior, not
bit-parity.

Device structure: each method's per-frame loops become batched stencil /
FFT / convolution passes; the Ridge fits are Gram solves; DMD runs its GEMMs
on device with the tiny complex eig on host; the (method, regime) matrix is
embarrassingly parallel.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp

from pdx.io_host.artifacts import write_json
from pdx.preprocess import (
    preprocess_gaussian,
    preprocess_median,
    preprocess_tv,
    preprocess_bilateral,
    preprocess_temporal,
    preprocess_detrend,
    preprocess_detrend_global,
)
from pdx.solve.dmd import standard_dmd, multiscale_dmd, sparse_dmd

TRUE_COEF = np.array([-1.0, -1.0, -0.5])


@dataclass(frozen=True)
class ComprehensiveConfig:
    output_dir: str = "outputs/latest/benchmark"
    Lx: float = 100.0
    Ly: float = 100.0
    Nx: int = 64
    Ny: int = 64
    dt: float = 1e-4
    n_seconds: float = 1.0
    save_every: int = 50
    n_subsample: int = 20_000
    methods: tuple[str, ...] = ()  # empty = all
    noises: tuple[str, ...] = ()  # empty = all
    seed: int = 42
    dtype: str = "float64"
    multi_device: bool = True  # round-robin regimes over available devices
    write_artifacts: bool = True
    # batch the ridge-family methods (14 of 21 share the lib+ridge program)
    # into one vmapped dispatch per regime; RNG draws stay in the legacy
    # visit order, so coefficients are identical to the sequential path
    batch_solves: bool = True


# ---------------------------------------------------------------------------
# data generation (comprehensive_benchmark.py:79-113)
# ---------------------------------------------------------------------------


def simulate_clean(cfg: ComprehensiveConfig) -> jnp.ndarray:
    from pdx.utils.precision import resolve_dtype

    dtype = resolve_dtype(cfg.dtype)
    if cfg.dtype == "float64" and jnp.dtype(dtype).itemsize < 8:
        # the accelerator lacks f64: integrating the chaotic KS trajectory in
        # f32 accumulates rounding into a systematically biased dataset (the
        # recovered biharmonic coefficient collapses from -1 to ~-0.22, 52%
        # error even with an exact solver). Generate the data on the host CPU
        # in f64 and fit on the accelerator in f32 — the f32 FIT on f64 data
        # matches the all-f64 result to 3 digits.
        with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
            U64 = _simulate_clean_typed(cfg, jnp.float64)
            host = np.asarray(U64)
        return jnp.asarray(host.astype(np.float32))
    return _simulate_clean_typed(cfg, dtype)


def _simulate_clean_typed(cfg: ComprehensiveConfig, dtype) -> jnp.ndarray:
    dx = cfg.Lx / cfg.Nx
    x = np.linspace(0, cfg.Lx, cfg.Nx, endpoint=False)
    y = np.linspace(0, cfg.Ly, cfg.Ny, endpoint=False)
    X, Y = np.meshgrid(x, y)  # reference uses default 'xy' indexing
    u0 = 0.1 * (
        np.sin(2 * np.pi * X / cfg.Lx) * np.cos(2 * np.pi * Y / cfg.Ly)
        + 0.5 * np.sin(4 * np.pi * X / cfg.Lx) * np.sin(4 * np.pi * Y / cfg.Ly)
    )
    total_steps = int(cfg.n_seconds / cfg.dt)
    n_frames = total_steps // cfg.save_every

    def lap(f):
        return (
            jnp.roll(f, -1, 0) + jnp.roll(f, 1, 0) + jnp.roll(f, -1, 1) + jnp.roll(f, 1, 1) - 4 * f
        ) / (dx**2)

    def rhs(u):
        l = lap(u)
        gx = (jnp.roll(u, -1, 0) - jnp.roll(u, 1, 0)) / (2 * dx)
        gy = (jnp.roll(u, -1, 1) - jnp.roll(u, 1, 1)) / (2 * dx)
        return -l - lap(l) - 0.5 * (gx**2 + gy**2)

    se = cfg.save_every

    def step_fn(v, _):
        return jnp.clip(v + cfg.dt * rhs(v), -10, 10), None

    def outer(u, _):
        # reference saves AFTER the update whenever step % save_every == 0,
        # i.e. the saved frame is the state after (k*save_every + 1) updates
        u, _ = step_fn(u, None)
        saved = u
        u, _ = jax.lax.scan(step_fn, u, None, length=se - 1)
        return u, saved

    _, U = jax.lax.scan(outer, jnp.asarray(u0, dtype=dtype), None, length=n_frames)
    return U


def corruption_suite(U_clean: np.ndarray) -> dict[str, np.ndarray]:
    """Host-side scipy corruption suite — exact parity with
    comprehensive_benchmark.py:120-157 (scipy spline shifts, per-call seeds)."""
    from scipy.ndimage import shift as ndshift, gaussian_filter

    def add_shifts(data, max_shift=1.5):
        result = np.zeros_like(data)
        np.random.seed(123)
        for i in range(len(data)):
            s = np.random.uniform(-max_shift, max_shift, 2) if i > 0 else [0, 0]
            result[i] = ndshift(data[i], s, mode="wrap")
        return result

    def add_noise(data, std=0.02):
        np.random.seed(456)
        return data + std * np.std(data) * np.random.randn(*data.shape)

    def add_blur(data, sigma=1.5):
        return np.stack([gaussian_filter(f, sigma=sigma) for f in data])

    def add_drift(data, decay_rate=0.02):
        t = np.arange(len(data))
        return data * np.exp(-decay_rate * t)[:, None, None]

    return {
        "N1_shifts": add_shifts(U_clean, 1.5),
        "N2_noise": add_noise(U_clean, 0.03),
        "N3_blur": add_blur(U_clean, 1.5),
        "N4_drift": add_drift(U_clean, 0.02),
        "N5_shifts_noise": add_noise(add_shifts(U_clean, 1.5), 0.02),
        "N6_blur_noise": add_noise(add_blur(U_clean, 1.0), 0.02),
        "N7_all": add_noise(add_blur(add_drift(add_shifts(U_clean, 1.0), 0.015), 1.0), 0.02),
    }


# ---------------------------------------------------------------------------
# discovery core (comprehensive_benchmark.py:327-471)
# ---------------------------------------------------------------------------


def _derivative_fields(U: jnp.ndarray, dx: float, use_fourier: bool):
    """(ux, uy, lap, biharm) for the frame stack; square grid (dx == dy)."""
    if use_fourier:
        n = U.shape[-1]
        k = 2 * np.pi * np.fft.fftfreq(n, dx)
        KX, KY = jnp.meshgrid(jnp.asarray(k), jnp.asarray(k), indexing="ij")
        k2 = KX**2 + KY**2
        F = jnp.fft.fft2(U)
        ux = jnp.fft.ifft2(1j * KX * F).real
        uy = jnp.fft.ifft2(1j * KY * F).real
        lap = jnp.fft.ifft2(-k2 * F).real
        biharm = jnp.fft.ifft2(k2**2 * F).real
    else:
        ux = (jnp.roll(U, -1, -2) - jnp.roll(U, 1, -2)) / (2 * dx)
        uy = (jnp.roll(U, -1, -1) - jnp.roll(U, 1, -1)) / (2 * dx)

        def lap_op(f):
            return (
                jnp.roll(f, -1, -2) + jnp.roll(f, 1, -2) + jnp.roll(f, -1, -1) + jnp.roll(f, 1, -1) - 4 * f
            ) / (dx**2)

        lap = lap_op(U)
        biharm = lap_op(lap)
    return ux, uy, lap, biharm


@partial(jax.jit, static_argnames=("use_fourier", "margin"))
def _build_lib_tgt(U: jnp.ndarray, dx: float, dt_frame: float, use_fourier: bool, margin: int):
    """Stacked [lap, biharm, |grad u|^2] library + forward-difference target
    over the interior margin crop — one batched pass for all frames.

    Jitted: one program for the whole library instead of an eager
    dispatch per op."""
    Uk = U[:-1]
    dudt = (U[1:] - Uk) / dt_frame
    ux, uy, lap, biharm = _derivative_fields(Uk, dx, use_fourier)
    grad_sq = ux**2 + uy**2
    m = margin
    sel = (slice(None), slice(m, -m), slice(m, -m))
    lib = jnp.stack(
        [lap[sel].reshape(-1), biharm[sel].reshape(-1), grad_sq[sel].reshape(-1)], axis=1
    )
    return lib, dudt[sel].reshape(-1)


@jax.jit
def _centered_ridge(X: jnp.ndarray, y: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """sklearn Ridge(fit_intercept=True).coef_ equivalence: center X and y,
    then solve the ridge problem via augmented QR. QR keeps the error at
    cond(X)*eps instead of the Gram normal equations' cond(X)^2*eps — on f32
    backends the [lap, biharm, gradsq] library's biharmonic column
    (~k^4 scaling) makes the squared condition number unusable."""
    xm = jnp.mean(X, axis=0)
    ym = jnp.mean(y)
    p = X.shape[1]
    A = jnp.concatenate([X - xm, jnp.sqrt(alpha) * jnp.eye(p, dtype=X.dtype)], axis=0)
    b = jnp.concatenate([y - ym, jnp.zeros((p,), dtype=X.dtype)])
    Q, R = jnp.linalg.qr(A)
    return jax.scipy.linalg.solve_triangular(R, Q.T @ b, lower=False)


def _ransac_fit(X: np.ndarray, y: np.ndarray, rng: np.random.Generator, max_trials: int = 100) -> np.ndarray:
    """Textbook RANSAC with LinearRegression base (deviation from sklearn
    documented in the module docstring)."""
    n, p = X.shape
    min_samples = p + 1
    resid_thr = np.median(np.abs(y - np.median(y)))
    best_mask = None
    best_count = -1
    Xh = np.column_stack([X, np.ones(n)])
    for _ in range(max_trials):
        idx = rng.choice(n, size=min_samples, replace=False)
        coef, *_ = np.linalg.lstsq(Xh[idx], y[idx], rcond=None)
        resid = np.abs(y - Xh @ coef)
        inliers = resid < resid_thr
        c = int(inliers.sum())
        if c > best_count:
            best_count = c
            best_mask = inliers
    coef, *_ = np.linalg.lstsq(Xh[best_mask], y[best_mask], rcond=None)
    return coef[:p]


def _ridge_one(U, idx, dx, dt_frame, use_fourier, margin):
    """sindy_discover's ridge path as one traceable unit: lib + std scaling
    + row gather + centered ridge QR + unscale. Shared by the vmapped
    per-regime family dispatch and the single-method jit below."""
    lib, tgt = _build_lib_tgt(U, dx, dt_frame, use_fourier, margin)
    scales = jnp.std(lib, axis=0)
    scales = jnp.where(scales < 1e-10, 1.0, scales)
    Xs = (lib / scales)[idx]
    ys = tgt[idx]
    return _centered_ridge(Xs, ys, 1e-4) / scales


@partial(jax.jit, static_argnames=("use_fourier", "margin"))
def _batched_ridge_family(U_stack, idx_stack, dx, dt_frame, use_fourier, margin):
    """One vmapped dispatch for every ridge-family method of a regime."""
    return jax.vmap(
        lambda U, idx: _ridge_one(U, idx, dx, dt_frame, use_fourier, margin)
    )(U_stack, idx_stack)


# single-method programs: each method used to run its scaling/gather/center
# glue EAGERLY between the jitted stages — ~250 tiny one-op executables per
# matrix, one dispatch each. One fused program per method family instead.
@partial(jax.jit, static_argnames=("use_fourier", "margin"))
def _ridge_fit_idx(U, idx, dx, dt_frame, use_fourier, margin):
    return _ridge_one(U, idx, dx, dt_frame, use_fourier, margin)


@partial(jax.jit, static_argnames=("use_fourier", "margin", "max_iter"))
def _huber_fit_idx(U, idx, dx, dt_frame, use_fourier, margin, max_iter=200):
    from pdx.solve.robust import irls_huber

    lib, tgt = _build_lib_tgt(U, dx, dt_frame, use_fourier, margin)
    scales = jnp.std(lib, axis=0)
    scales = jnp.where(scales < 1e-10, 1.0, scales)
    Xs = (lib / scales)[idx]
    ys = tgt[idx]
    xm = jnp.mean(Xs, axis=0)
    ym = jnp.mean(ys)
    coef = irls_huber(Xs - xm, ys - ym, alpha=1e-4, delta=1.35, max_iter=max_iter)
    return coef / scales


@partial(jax.jit, static_argnames=("use_fourier", "margin"))
def _subsample_rows(U, idx, dx, dt_frame, use_fourier, margin):
    """(Xs, ys, scales) for the host-side RANSAC loop — one program instead
    of eager std/where/divide/gather."""
    lib, tgt = _build_lib_tgt(U, dx, dt_frame, use_fourier, margin)
    scales = jnp.std(lib, axis=0)
    scales = jnp.where(scales < 1e-10, 1.0, scales)
    return (lib / scales)[idx], tgt[idx], scales


def sindy_discover(
    U: jnp.ndarray,
    dx: float,
    dt_frame: float,
    *,
    use_fourier: bool = True,
    regressor: str = "ridge",
    margin: int = 3,
    n_subsample: int = 20_000,
) -> np.ndarray:
    """Parity: sindy_discover (comprehensive_benchmark.py:352-403).

    Subsample indices come from the module-level legacy np.random stream in
    the reference's draw order.
    """
    T, H, W = U.shape
    n_total = (T - 1) * (H - 2 * margin) * (W - 2 * margin)
    n_samples = min(n_subsample, n_total)
    idx = jnp.asarray(
        np.random.choice(n_total, n_samples, replace=False)  # legacy global stream
    )

    if regressor == "huber":
        return np.asarray(_huber_fit_idx(U, idx, dx, dt_frame, use_fourier, margin))
    if regressor == "ransac":
        Xs, ys, scales = _subsample_rows(U, idx, dx, dt_frame, use_fourier, margin)
        coef = _ransac_fit(np.asarray(Xs), np.asarray(ys), np.random.default_rng(0))
        return np.asarray(coef / np.asarray(scales))
    return np.asarray(_ridge_fit_idx(U, idx, dx, dt_frame, use_fourier, margin))


@partial(jax.jit, static_argnames=("test_width", "margin"))
def _weak_form_lib_tgt(U: jnp.ndarray, phi_j: jnp.ndarray, dx: float, dt_frame: float,
                       test_width: int, margin: int):
    """Device half of weak_form_sindy: 121-tap wrap convolution of the library
    fields. Jitted — the eager path dispatches once per tap."""
    Uk = U[:-1]
    dudt = (U[1:] - Uk) / dt_frame
    ux, uy, lap, biharm = _derivative_fields(Uk, dx, use_fourier=False)
    grad_sq = ux**2 + uy**2

    def conv_wrap(f):
        k = 2 * test_width + 1
        pad = [(0, 0)] * (f.ndim - 2) + [(test_width, test_width)] * 2
        p = jnp.pad(f, pad, mode="wrap")
        out = jnp.zeros_like(f)
        H, W = f.shape[-2], f.shape[-1]
        for i in range(k):
            for j in range(k):
                out = out + phi_j[i, j] * p[..., i : i + H, j : j + W]
        return out

    m = margin
    sel = (slice(None), slice(m, -m), slice(m, -m))
    lib = jnp.stack(
        [conv_wrap(lap)[sel].reshape(-1), conv_wrap(biharm)[sel].reshape(-1), conv_wrap(grad_sq)[sel].reshape(-1)],
        axis=1,
    )
    tgt = conv_wrap(dudt)[sel].reshape(-1)
    scales = jnp.std(lib, axis=0)
    scales = jnp.where(scales < 1e-10, 1.0, scales)
    return lib, tgt, scales


def weak_form_sindy(
    U: jnp.ndarray, dx: float, dt_frame: float, *, test_width: int = 5, margin: int = 5,
    n_subsample: int = 20_000,
) -> np.ndarray:
    """Parity: weak_form_sindy (comprehensive_benchmark.py:409-454) incl. the
    quirk that the subsample draw is consumed but the fit uses all rows."""
    x = np.arange(-test_width, test_width + 1)
    Xk, Yk = np.meshgrid(x, x)
    sigma = test_width / 2
    phi = np.exp(-(Xk**2 + Yk**2) / (2 * sigma**2))
    phi /= phi.sum()
    phi_j = jnp.asarray(phi, dtype=U.dtype)

    T, H, W = U.shape
    n_total = (T - 1) * (H - 2 * margin) * (W - 2 * margin)
    _ = np.random.choice(n_total, min(n_subsample, n_total), replace=False)  # consumed, unused (reference quirk)
    return np.asarray(_weak_fit(U, phi_j, dx, dt_frame, test_width, margin))


@partial(jax.jit, static_argnames=("test_width", "margin"))
def _weak_fit(U, phi_j, dx, dt_frame, test_width, margin):
    lib, tgt, scales = _weak_form_lib_tgt(U, phi_j, dx, dt_frame, test_width, margin)
    return _centered_ridge(lib / scales, tgt, 1e-4) / scales


@partial(jax.jit, static_argnames=("use_fourier", "margin"))
def _ridge_fit_frames(U, frame_idx, idx, dx, dt_frame, use_fourier, margin):
    """Bootstrap-member fit with the frame gather fused into the program
    (one dispatch per member instead of an eager gather + fit chain)."""
    return _ridge_one(U[frame_idx], idx, dx, dt_frame, use_fourier, margin)


def ensemble_sindy(U: jnp.ndarray, dx: float, dt_frame: float, n_ensemble: int = 5) -> np.ndarray:
    """Frame-bootstrap ensemble (comprehensive_benchmark.py:456-471).

    Host draws stay in the legacy global-stream order (frame bootstrap,
    then the member's subsample); each member runs as one jitted program.
    Members recompile per distinct unique-frame count — the reference's
    unique-sorted bootstrap makes the member length data-dependent.
    """
    coefs = []
    n_frames, H, W = U.shape
    margin = 3
    for _ in range(n_ensemble):
        idx = np.random.choice(n_frames, n_frames, replace=True)
        idx = np.sort(np.unique(idx))
        if len(idx) < 3:
            continue
        n_total = (len(idx) - 1) * (H - 2 * margin) * (W - 2 * margin)
        n_samples = min(20_000, n_total)
        sample_idx = np.random.choice(n_total, n_samples, replace=False)
        coefs.append(
            np.asarray(
                _ridge_fit_frames(
                    U, jnp.asarray(idx), jnp.asarray(sample_idx),
                    dx, dt_frame, True, margin,
                )
            )
        )
    return np.median(np.stack(coefs), axis=0)


def build_methods(cfg: ComprehensiveConfig, dx: float, dt_frame: float) -> dict[str, Callable]:
    sd = lambda d, **kw: sindy_discover(d, dx, dt_frame, n_subsample=cfg.n_subsample, **kw)
    return {
        "M01_baseline": lambda d: sd(d),
        "M02_gaussian": lambda d: sd(preprocess_gaussian(d)),
        "M03_median": lambda d: sd(preprocess_median(d)),
        "M04_tv": lambda d: sd(preprocess_tv(d)),
        "M05_bilateral": lambda d: sd(preprocess_bilateral(d)),
        "M06_temporal": lambda d: sd(preprocess_temporal(d)),
        "M07_huber": lambda d: sd(d, regressor="huber"),
        "M08_ransac": lambda d: sd(d, regressor="ransac"),
        "M09_fourier": lambda d: sd(d, use_fourier=True),
        "M10_weak_form": lambda d: weak_form_sindy(d, dx, dt_frame, n_subsample=cfg.n_subsample),
        "M11_ensemble": lambda d: ensemble_sindy(d, dx, dt_frame),
        "M12_dmd": lambda d: sd(standard_dmd(d, rank=30)),
        "M13_dmd_opt": lambda d: sd(standard_dmd(d, rank=50)),
        "M14_dmd_fourier": lambda d: sd(standard_dmd(d, rank=40), use_fourier=True),
        "M15_sparse_dmd": lambda d: sd(sparse_dmd(d, rank=30)),
        "M16_multiscale_dmd": lambda d: sd(multiscale_dmd(d)),
        "M17_physics_dmd": lambda d: sd(multiscale_dmd(d, low_rank=8, high_rank=20), use_fourier=True),
        "M18_detrend": lambda d: sd(preprocess_detrend(d)),
        "M19_detrend_global": lambda d: sd(preprocess_detrend_global(d)),
        "M20_detrend_dmd": lambda d: sd(standard_dmd(preprocess_detrend(d), rank=40)),
        "M21_detrend_multiscale": lambda d: sd(multiscale_dmd(preprocess_detrend(d))),
    }


def _method_specs(cfg: ComprehensiveConfig) -> dict[str, tuple[str, Callable | None]]:
    """(family, preprocess) per method. The 'fourier' ridge family batches
    into one vmapped dispatch per regime; the rest run individually in visit
    order (huber = async single dispatch; ransac/weak/ensemble sync on host
    by construction)."""
    # NOTE: every ridge method uses use_fourier=True — the reference's
    # sindy_discover default (comprehensive_benchmark.py:352) applies to all
    # of them, making M09 a duplicate of M01 by construction (quirk kept).
    return {
        "M01_baseline": ("fourier", lambda d: d),
        "M02_gaussian": ("fourier", preprocess_gaussian),
        "M03_median": ("fourier", preprocess_median),
        "M04_tv": ("fourier", preprocess_tv),
        "M05_bilateral": ("fourier", preprocess_bilateral),
        "M06_temporal": ("fourier", preprocess_temporal),
        "M07_huber": ("huber", lambda d: d),
        "M08_ransac": ("ransac", lambda d: d),
        "M09_fourier": ("fourier", lambda d: d),
        "M10_weak_form": ("weak", None),
        "M11_ensemble": ("ensemble", None),
        "M12_dmd": ("fourier", lambda d: standard_dmd(d, rank=30)),
        "M13_dmd_opt": ("fourier", lambda d: standard_dmd(d, rank=50)),
        "M14_dmd_fourier": ("fourier", lambda d: standard_dmd(d, rank=40)),
        "M15_sparse_dmd": ("fourier", lambda d: sparse_dmd(d, rank=30)),
        "M16_multiscale_dmd": ("fourier", lambda d: multiscale_dmd(d)),
        "M17_physics_dmd": ("fourier", lambda d: multiscale_dmd(d, low_rank=8, high_rank=20)),
        "M18_detrend": ("fourier", preprocess_detrend),
        "M19_detrend_global": ("fourier", preprocess_detrend_global),
        "M20_detrend_dmd": ("fourier", lambda d: standard_dmd(preprocess_detrend(d), rank=40)),
        "M21_detrend_multiscale": ("fourier", lambda d: multiscale_dmd(preprocess_detrend(d))),
    }


def _run_methods_batched(
    cfg: ComprehensiveConfig, method_names: list[str], data: jnp.ndarray,
    dx: float, dt_frame: float,
) -> dict[str, dict]:
    """Per-regime method sweep with the ridge families batched.

    Walks the methods in the legacy visit order so every np.random draw
    (subsample indices, weak-form consumed draw, ensemble bootstraps) happens
    in exactly the reference sequence — coefficients are identical to the
    sequential path; only the dispatch structure changes (one vmapped solve
    for the whole ridge family instead of 14 separate chains).
    """
    specs = _method_specs(cfg)
    T, H, W = data.shape
    margin = 3
    n_total = (T - 1) * (H - 2 * margin) * (W - 2 * margin)
    n_samples = min(cfg.n_subsample, n_total)

    family: dict[str, list] = {"fourier": []}
    singles: dict[str, jnp.ndarray] = {}
    results: dict[str, dict] = {}
    times: dict[str, float] = {}

    for name in method_names:
        fam, pre = specs[name]
        t0 = time.time()
        try:
            if fam == "fourier":
                d_pre = pre(data)
                idx = np.random.choice(n_total, n_samples, replace=False)
                family[fam].append((name, d_pre, jnp.asarray(idx)))
            elif fam == "huber":
                d_pre = pre(data)
                idx = np.random.choice(n_total, n_samples, replace=False)
                singles[name] = _huber_fit_idx(
                    d_pre, jnp.asarray(idx), dx, dt_frame, True, margin
                )
            elif fam == "ransac":
                # Fourier derivatives — sindy_discover's default, matching the
                # reference M08 (comprehensive_benchmark.py:485,352) and this
                # module's sequential path
                singles[name] = jnp.asarray(
                    sindy_discover(data, dx, dt_frame,
                                   regressor="ransac", n_subsample=cfg.n_subsample)
                )
            elif fam == "weak":
                singles[name] = jnp.asarray(
                    weak_form_sindy(data, dx, dt_frame, n_subsample=cfg.n_subsample)
                )
            else:  # ensemble
                singles[name] = jnp.asarray(ensemble_sindy(data, dx, dt_frame))
        except Exception as e:
            results[name] = {"error": float("inf"), "coef": [0, 0, 0], "time": 0.0,
                             "error_msg": str(e)}
        times[name] = time.time() - t0

    # one vmapped dispatch per family, method axis sharded over the device
    # mesh when one is available (SURVEY §2.9: the benchmark-matrix axis)
    from pdx.shard.mesh import maybe_shard_leading

    for fam, use_fourier in (("fourier", True),):
        jobs = family[fam]
        if not jobs:
            continue
        t0 = time.time()
        try:
            U_stack = jnp.stack([j[1] for j in jobs])
            idx_stack = jnp.stack([j[2] for j in jobs])
            (U_stack, idx_stack), n_jobs = maybe_shard_leading(
                (U_stack, idx_stack), "auto" if cfg.multi_device else "off"
            )
            coefs = _batched_ridge_family(U_stack, idx_stack, dx, dt_frame, use_fourier, margin)[:n_jobs]
            for vi, (name, _d, _i) in enumerate(jobs):
                singles[name] = coefs[vi]
        except Exception as e:
            for name, _d, _i in jobs:
                results[name] = {"error": float("inf"), "coef": [0, 0, 0], "time": 0.0,
                                 "error_msg": str(e)}
            continue
        solve_t = (time.time() - t0) / len(jobs)
        for name, _d, _i in jobs:
            times[name] += solve_t

    # ONE bundled device->host read for every method's coefficients: the
    # per-name np.asarray loop paid ~21 sequential round-trips per
    # regime (~168 across the matrix). Fall back to per-name reads if the
    # bundled get fails so one poisoned value can't sink the whole regime.
    import jax as _jax

    try:
        singles = _jax.device_get(singles)
    except Exception:
        pass
    for name in method_names:
        if name in results:  # failed earlier
            continue
        try:
            coef = np.asarray(singles[name])
            results[name] = {
                "error": compute_error(coef),
                "coef": [float(c) for c in coef],
                "time": float(times[name]),
            }
        except Exception as e:
            results[name] = {"error": float("inf"), "coef": [0, 0, 0], "time": 0.0,
                             "error_msg": str(e)}
    return results


def compute_error(coef: np.ndarray, true: np.ndarray = TRUE_COEF) -> float:
    return float(np.linalg.norm(coef - true) / np.linalg.norm(true) * 100.0)


def run(cfg: ComprehensiveConfig) -> dict[str, Any]:
    dx = cfg.Lx / cfg.Nx
    dt_frame = cfg.dt * cfg.save_every

    np.random.seed(cfg.seed)  # legacy global stream, reference draw order
    U_clean = simulate_clean(cfg)
    datasets: dict[str, jnp.ndarray] = {"N0_clean": U_clean}
    for name, arr in corruption_suite(np.asarray(U_clean)).items():
        datasets[name] = jnp.asarray(arr, dtype=U_clean.dtype)

    methods = build_methods(cfg, dx, dt_frame)
    if cfg.methods:
        unknown = sorted(set(cfg.methods) - set(methods))
        if unknown:
            raise ValueError(f"unknown methods {unknown}; valid: {sorted(methods)}")
        methods = {k: v for k, v in methods.items() if k in set(cfg.methods)}
    if cfg.noises:
        unknown = sorted(set(cfg.noises) - set(datasets))
        if unknown:
            raise ValueError(f"unknown noise regimes {unknown}; valid: {sorted(datasets)}")
        datasets = {k: v for k, v in datasets.items() if k in set(cfg.noises) or k == "N0_clean"}

    # coarse-grain multi-device parallelism: the (noise-regime, method) matrix
    # is embarrassingly parallel; placing each regime's dataset on a different
    # device makes the async dispatch queue overlap regimes across chips
    # (jitted programs follow their inputs' placement)
    devices = jax.devices()
    if cfg.multi_device and len(devices) > 1:
        datasets = {
            name: jax.device_put(data, devices[i % len(devices)])
            for i, (name, data) in enumerate(datasets.items())
        }

    results: dict[str, dict] = {}
    if cfg.batch_solves:
        for noise_name, data in datasets.items():
            results[noise_name] = _run_methods_batched(
                cfg, list(methods.keys()), data, dx, dt_frame
            )
        return _finalize(cfg, datasets, methods, results)
    for noise_name, data in datasets.items():
        results[noise_name] = {}
        for method_name, fn in methods.items():
            try:
                t0 = time.time()
                coef = np.asarray(fn(data))  # one transfer; scalar reads below
                elapsed = time.time() - t0
                err = compute_error(coef)
                results[noise_name][method_name] = {
                    "error": err,
                    "coef": [float(c) for c in coef],
                    "time": float(elapsed),
                }
            except Exception as e:  # a failing method scores inf, not a crash
                results[noise_name][method_name] = {
                    "error": float("inf"),
                    "coef": [0, 0, 0],
                    "time": 0.0,
                    "error_msg": str(e),
                }

    return _finalize(cfg, datasets, methods, results)


def _finalize(cfg, datasets, methods, results) -> dict[str, Any]:
    method_avg = {}
    for m in methods:
        errs = [
            results[n][m]["error"]
            for n in results
            if m in results[n] and np.isfinite(results[n][m]["error"])
        ]
        if errs:
            method_avg[m] = float(np.mean(errs))
    sorted_methods = sorted(method_avg.items(), key=lambda x: x[1])

    output = {
        "true_coef": TRUE_COEF.tolist(),
        "noise_configs": list(datasets.keys()),
        # observability for the multi_device round-robin: which device each
        # regime's dataset (and therefore its whole method sweep) ran on
        "placement": {n: str(next(iter(d.devices()))) for n, d in datasets.items()},
        "methods": list(methods.keys()),
        "results": results,
        "rankings": dict(sorted_methods),
        "best_overall": sorted_methods[0][0] if sorted_methods else None,
        "best_per_noise": {
            n: min(results[n].items(), key=lambda x: x[1]["error"])[0] for n in results
        },
    }
    if cfg.write_artifacts:
        write_json(Path(cfg.output_dir) / "benchmark_results.json", output)
    return output


def cmd_comprehensive(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx comprehensive")
    parser.add_argument("--output-dir", default="outputs/latest/benchmark")
    parser.add_argument("--methods", default="", help="comma-separated subset (default all)")
    parser.add_argument("--noises", default="", help="comma-separated subset (default all)")
    parser.add_argument("--n-seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    cfg = ComprehensiveConfig(
        output_dir=args.output_dir,
        methods=tuple(m for m in args.methods.split(",") if m),
        noises=tuple(n for n in args.noises.split(",") if n),
        n_seconds=args.n_seconds,
    )
    out = run(cfg)
    print(f"{'':20}", *[f"{n[:8]:>10}" for n in out["noise_configs"]])
    for m in out["methods"]:
        row = [f"{m:<20}"]
        for n in out["noise_configs"]:
            e = out["results"][n][m]["error"]
            row.append(f"{e:>10.1f}" if np.isfinite(e) else f"{'FAIL':>10}")
        print("".join(row))
    print(f"\nBEST OVERALL: {out['best_overall']}")
    return 0
