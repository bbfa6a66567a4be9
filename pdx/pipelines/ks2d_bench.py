"""KS-2D ground-truth STRidge benchmark pipeline.

End-to-end parity with ``scripts/ks2d_stridge_benchmark.py`` main()
(:1107-1840): simulate -> perturb -> (stabilize) -> (denoise) ->
{pointwise | blockwise | weakform} dataset -> {standard | huber | trimmed |
sign_constrained | ensemble | robust} STRidge (optionally alpha x threshold
grid search) -> ground-truth coefficient errors + rollout RMSE.

Device structure: simulation is one lax.scan; the dictionary is one
batched stencil/FFT pass; the regression consumes Gram sufficient statistics
so the 30-point grid search is a single vmapped masked-solve dispatch; the
rollout is one more scan. Host work is limited to RNG index draws (numpy,
reference draw order for golden parity) and result formatting.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from pdx.sim.ks2d import Ks2dConfig, simulate_ks2d
from pdx.sim.perturb import PerturbConfig, apply_perturbation_suite
from pdx.register.phasecorr import stabilize_translation_sequence, estimate_interframe_shifts
from pdx.ops.filters import time_smooth_moving_average, smooth_1d
from pdx.ops.spectral import gaussian_smooth_periodic, gradients_spectral
from pdx.ops.fd import gradients_periodic
from pdx.ops.metrics import rmse, r2_score
from pdx.ops.linalg import gram_stats
from pdx.library.dictionaries import (
    build_dictionary_true,
    build_dictionary_rich,
    display_names,
)
from pdx.library.pointwise import forward_difference_ut, build_pointwise_dataset
from pdx.library.blockwise import build_blockwise_dataset
from pdx.library.weakform import build_weakform_dataset
from pdx.solve.stridge import stridge_from_stats, stridge_grid
from pdx.solve.robust import (
    stridge_huber,
    trimmed_stridge,
    stridge_sign_constrained,
    ensemble_stridge,
    robust_stridge,
)
from pdx.validate.rollout import rollout_rmse_curve_named

KS_GT = {"lap": -1.0, "bih": -1.0, "gradsq": -0.5}

GRID_ALPHAS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
GRID_THRESHOLDS = (1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5)


@dataclass(frozen=True)
class Ks2dBenchConfig:
    """Mirrors the reference CLI (ks2d_stridge_benchmark.py:1108-1353)."""

    # simulation
    Nx: int = 100
    Ny: int = 100
    n_seconds: float = 2.0
    dt: float = 1e-3
    save_every: int = 1
    # dataset method
    method: str = "pointwise"  # pointwise | blockwise | weakform
    dictionary: str = "true"  # true | rich
    derivatives: str = "finite"  # finite | spectral
    spectral_cutoff: float = 1.0
    include_advection: bool = False
    enforce_no_advection: bool = False
    n_sample: int = 50_000
    # perturbation
    perturbation: str = "none"
    noise_rel: float = 0.0
    noise_seed: int = 999
    shift_max: float = 1.5
    shift_mode: str = "constant"
    blur_sigma: float = 1.5
    drift: float = 0.02
    # stabilization / u_t correction
    stabilize_shifts: bool = False
    stabilize_mode: str = "to_first"
    stabilize_est_sigma: float = 0.0
    correct_shift_ut: bool = False
    ut_shift_smooth: int = 7
    ut_adv_deriv: str = "spectral"
    ut_adv_cutoff: float = 0.5
    # denoising
    denoise_time_window: int = 1
    denoise_space_sigma: float = 0.0
    denoise_space_on: str = "features"  # features | all
    # weak form
    weak_max_k: int = 3
    weak_basis: str = "gaussian"
    weak_n_phi: int = 64
    weak_sigma_px: float = 6.0
    weak_grad_cutoff: float | None = None  # None -> 0.65 in spectral mode
    weak_motion_correct: bool = False
    weak_motion_est_sigma: float = 0.0
    weak_motion_smooth: int = 7
    weak_motion_clip_px: float = -1.0
    # 'spectral' = reference-parity quadrature; 'fd' = discrete-adjoint
    # stencil columns consistent with the FD simulator (see weakform.py)
    weak_operator: str = "spectral"
    # blockwise
    block_t: int = 3
    block_x: int = 8
    block_y: int = 8
    # regression
    regression: str = "standard"  # standard | huber | trimmed | sign_constrained | ensemble
    robust: bool = False
    grid_search: bool = False
    alpha: float = 1e-6
    threshold: float = 1e-10
    huber_delta: float = 1.35
    trim_frac: float = 0.05
    n_bootstrap: int = 30
    sign_constraints: tuple[int, ...] = ()
    # rollout
    rollout_steps: int = 50
    # numerics
    dtype: str = "float64"  # float64 requires jax x64; accelerators resolve it to float32
    # auto | gram | qr | fullfield. 'auto': QR inner solves on f32 backends
    # (cond(X) vs cond(X)^2; rescues ill-conditioned rich dictionaries),
    # Gram sufficient statistics on f64. 'fullfield': Gram statistics of the
    # stencil terms summed over the FULL field (every sample or every block,
    # no subsampling/split; selection by full-set train R^2). Requires
    # pointwise or blockwise, finite differences, grid search.
    solver: str = "auto"
    # multi-device: shard the sample axis over all devices (psum Gram, which
    # XLA hands to NCCL over NVLink); 'auto' enables it when more than one
    # device is visible
    mesh: str = "auto"  # auto | off | on


def _effective_noise_rel(cfg: Ks2dBenchConfig) -> float:
    """N2/N5/N6/N7 default to 3% noise when unspecified (main:1410-1413)."""
    noise_rel = float(cfg.noise_rel)
    if cfg.perturbation in {"N2_noise", "N5_shifts_noise", "N6_blur_noise", "N7_all"} and noise_rel == 0.0:
        return 0.03
    return noise_rel


def prepare_frames(cfg: Ks2dBenchConfig) -> dict[str, Any]:
    """simulate -> perturb -> stabilize -> denoise. Returns field dict."""
    dtype = jnp.dtype(cfg.dtype)
    sim = Ks2dConfig(
        Nx=cfg.Nx, Ny=cfg.Ny, dt=cfg.dt, n_seconds=cfg.n_seconds, save_every=cfg.save_every
    )
    U_clean, dx, dy, DT = simulate_ks2d(sim, dtype=dtype)

    perturb = PerturbConfig(
        perturbation=cfg.perturbation,
        noise_rel=_effective_noise_rel(cfg),
        noise_seed=cfg.noise_seed,
        shift_max_px=cfg.shift_max,
        shift_mode=cfg.shift_mode,
        blur_sigma=cfg.blur_sigma,
        drift_per_frame=cfg.drift,
    )
    U = apply_perturbation_suite(U_clean, perturb)

    if cfg.stabilize_shifts:
        U = stabilize_translation_sequence(
            U, mode=cfg.stabilize_mode, estimate_sigma_px=cfg.stabilize_est_sigma, border="wrap"
        )

    U_for_ut = U
    if cfg.denoise_time_window > 1:
        U_for_ut = time_smooth_moving_average(U_for_ut, cfg.denoise_time_window)
    U_for_features = U_for_ut
    if cfg.denoise_space_sigma > 0:
        if cfg.denoise_space_on == "all":
            U_for_ut = gaussian_smooth_periodic(U_for_ut, cfg.denoise_space_sigma)
            U_for_features = U_for_ut
        else:
            U_for_features = gaussian_smooth_periodic(U_for_features, cfg.denoise_space_sigma)

    return {
        "U_clean": U_clean,
        "U": U,
        "U_for_ut": U_for_ut,
        "U_for_features": U_for_features,
        "dx": dx,
        "dy": dy,
        "DT": DT,
        "sim": sim,
    }


def build_dataset(cfg: Ks2dBenchConfig, fr: dict[str, Any], rng: np.random.Generator):
    """Dataset branch dispatch (main:1472-1636). Returns (names, X, y)."""
    dx, dy, DT = fr["dx"], fr["dy"], fr["DT"]
    U_for_ut, U_for_features = fr["U_for_ut"], fr["U_for_features"]

    if cfg.method == "weakform":
        # the reference restricts weakform to the true dictionary
        # (ks2d_stridge_benchmark.py:1473-1474); pdx lifts this — 'rich'
        # builds every decoy by integration by parts (see library/weakform.py)
        clip_px = float(cfg.weak_motion_clip_px)
        if clip_px <= 0:
            clip_px = (
                float(cfg.shift_max)
                if cfg.perturbation in {"N1_shifts", "N5_shifts_noise", "N7_all"}
                else 0.0
            )
        names, X_all, y_all = build_weakform_dataset(
            U_for_ut,
            dx=dx,
            dy=dy,
            dt_frame=DT,
            lx=float(cfg.Nx * dx),
            ly=float(cfg.Ny * dy),
            max_k=cfg.weak_max_k,
            basis=cfg.weak_basis,
            n_phi=cfg.weak_n_phi,
            sigma_px=cfg.weak_sigma_px,
            grad_cutoff=cfg.weak_grad_cutoff,
            motion_correct=cfg.weak_motion_correct,
            motion_est_sigma_px=cfg.weak_motion_est_sigma,
            motion_smooth_window=cfg.weak_motion_smooth,
            motion_clip_px=clip_px if clip_px > 0 else None,
            dictionary=cfg.dictionary,
            operator=cfg.weak_operator,
        )
        n_total = int(y_all.shape[0])
        n_sample = int(min(cfg.n_sample, n_total))
        idx = rng.choice(n_total, size=n_sample, replace=False)
        return names, X_all[jnp.asarray(idx)], y_all[jnp.asarray(idx)]

    U_frames = U_for_features[:-1]
    Ut = forward_difference_ut(U_for_ut, DT)

    if cfg.correct_shift_ut:
        sx_px, sy_px = estimate_interframe_shifts(U_for_ut, estimate_sigma_px=cfg.stabilize_est_sigma)
        sx_px = smooth_1d(sx_px, window=cfg.ut_shift_smooth)
        sy_px = smooth_1d(sy_px, window=cfg.ut_shift_smooth)
        U_adv = U_for_ut[:-1]
        if cfg.ut_adv_deriv == "spectral":
            ux_adv, uy_adv = gradients_spectral(U_adv, dx, dy, cutoff_frac=cfg.ut_adv_cutoff)
        else:
            ux_adv, uy_adv = gradients_periodic(U_adv, dx, dy)
        vx = (-sx_px * dx) / DT
        vy = (-sy_px * dy) / DT
        Ut = Ut + vx[:, None, None] * ux_adv + vy[:, None, None] * uy_adv

    include_adv = cfg.include_advection and not cfg.enforce_no_advection
    if cfg.dictionary == "true":
        names, terms = build_dictionary_true(
            U_frames, dx, dy,
            deriv=cfg.derivatives, spectral_cutoff=cfg.spectral_cutoff,
            include_advection=include_adv,
        )
    else:
        names, terms = build_dictionary_rich(
            U_frames, dx, dy,
            deriv=cfg.derivatives, spectral_cutoff=cfg.spectral_cutoff,
            drop_advection=cfg.enforce_no_advection,
        )

    if cfg.method == "blockwise":
        X_all, y_all = build_blockwise_dataset(
            Ut, terms, block_t=cfg.block_t, block_x=cfg.block_x, block_y=cfg.block_y
        )
        return names, X_all, y_all

    # pointwise
    n_total = int(np.prod(Ut.shape))
    n_sample = int(min(cfg.n_sample, n_total))
    flat_idx = rng.choice(n_total, size=n_sample, replace=False)
    X_all, y_all = build_pointwise_dataset(Ut, terms, flat_idx)
    return names, X_all, y_all


import jax as _jax


@partial(_jax.jit, static_argnames=("names", "deriv", "use_qr"))
def _fused_pointwise_grid(
    U_for_ut, U_for_features, flat_idx, tr_idx, te_idx, DT, dx, dy,
    alphas, thresholds, names, deriv, use_qr,
):
    """One-dispatch pointwise benchmark core: forward-difference target ->
    dictionary -> row gather -> train/test split -> RMS scaling -> full
    alpha x threshold STRidge grid -> device-side test metrics.

    Everything between the simulator scan and the tiny host-side selection is
    a single XLA program — no intermediate HBM round trips or dispatch gaps.
    """
    Ut = forward_difference_ut(U_for_ut, DT)
    U_frames = U_for_features[:-1]
    if set(names) <= {"lap", "bih", "gradsq", "ux", "uy"}:
        _n, terms = build_dictionary_true(
            U_frames, dx, dy, deriv=deriv, include_advection="ux" in names
        )
    else:
        _n, terms = build_dictionary_rich(
            U_frames, dx, dy, deriv=deriv, drop_advection="ux" not in names
        )
    p = terms.shape[0]
    X_all = terms.reshape(p, -1)[:, flat_idx].T
    y_all = Ut.reshape(-1)[flat_idx]
    X_tr, y_tr = X_all[tr_idx], y_all[tr_idx]
    X_te, y_te = X_all[te_idx], y_all[te_idx]

    scale = jnp.sqrt(jnp.mean(X_tr**2, axis=0)) + 1e-12
    const = jnp.asarray([1.0 if n == "one" else 0.0 for n in names], dtype=X_tr.dtype)
    scale = jnp.where(const > 0, 1.0, scale)
    X_tr_s = X_tr / scale

    if use_qr:
        return _grid_solve_qr_inline(X_tr_s, y_tr, X_te, y_te, scale, alphas, thresholds)
    stats = gram_stats(X_tr_s, y_tr)
    coeffs_grid, _masks = stridge_grid(stats, alphas, thresholds, max_iter=25)
    coeffs_grid = coeffs_grid / scale
    return _score_grid(coeffs_grid, X_te, y_te)


@partial(_jax.jit, static_argnames=("DT", "dx", "dy", "names", "blocks"))
def _fullfield_grid(U_for_ut, U_for_features, DT, dx, dy, alphas, thresholds,
                    names, blocks):
    """Full-field variant of :func:`_fused_pointwise_grid`.

    The Gram statistics of the stencil term list are summed over EVERY
    sample (``blocks=None``) or over every (bt, bx, by) block mean
    (``blocks=(bt, bx, by)``), with no 50k-row subsample and no design
    matrix (pdx.library.fullfield). The alpha x threshold grid then runs on
    the (p, p) statistics and is scored by full-set train R^2 from the same
    statistics: there is no held-out row set on this path, and with ~2M
    samples the train/test distinction is noise.
    """
    from pdx.library.fullfield import blockwise_gram, fullfield_gram

    Ut = forward_difference_ut(U_for_ut, DT)
    U = U_for_features[:-1]
    if blocks is None:
        stats = fullfield_gram(U, Ut, dx, dy, names)
    else:
        bt, bx, by = blocks
        stats = blockwise_gram(U, Ut, dx, dy, names, block_t=bt, block_x=bx, block_y=by)
    return _grid_from_stats(stats, alphas, thresholds)


def _grid_from_stats(stats, alphas, thresholds):
    """RMS-scaled alpha x threshold STRidge grid + full-set metrics, all from
    (p, p) sufficient statistics — no materialized design matrix."""
    # RMS column scaling as a pure stats transform (main:1645-1655 analog)
    s = jnp.sqrt(jnp.diagonal(stats["G"]) / stats["n"]) + 1e-12
    sstats = {
        "G": stats["G"] / (s[:, None] * s[None, :]),
        "b": stats["b"] / s,
        "sx": stats["sx"] / s,
        "n": stats["n"],
        "sy": stats["sy"],
        "syy": stats["syy"],
    }
    coeffs_s, _masks = stridge_grid(sstats, alphas, thresholds, max_iter=25)
    coeffs_grid = coeffs_s / s
    # full-set metrics from raw statistics: ||y - Xc||^2 = syy - 2c.b + c'Gc
    resid2 = (
        stats["syy"]
        - 2.0 * jnp.einsum("atp,p->at", coeffs_grid, stats["b"])
        + jnp.einsum("atp,pq,atq->at", coeffs_grid, stats["G"], coeffs_grid)
    )
    resid2 = jnp.maximum(resid2, 0.0)
    sst = stats["syy"] - stats["sy"] ** 2 / stats["n"]
    r2 = 1.0 - resid2 / (sst + 1e-18)
    err = jnp.sqrt(resid2 / stats["n"])
    n_active = jnp.sum(jnp.abs(coeffs_grid) > 0, axis=-1)
    return coeffs_grid, r2, err, n_active


def _score_grid(coeffs_grid, X_te, y_te):
    preds = jnp.einsum("atp,np->atn", coeffs_grid, X_te)
    resid2 = jnp.sum((preds - y_te[None, None, :]) ** 2, axis=-1)
    sst = jnp.sum((y_te - jnp.mean(y_te)) ** 2)
    r2 = 1.0 - resid2 / (sst + 1e-18)
    err = jnp.sqrt(resid2 / y_te.shape[0])
    n_active = jnp.sum(jnp.abs(coeffs_grid) > 0, axis=-1)
    return coeffs_grid, r2, err, n_active


def _grid_solve_qr_inline(X_tr_s, y_tr, X_te, y_te, scale, alphas, thresholds):
    from pdx.solve.stridge import stridge_qr

    def solve_one(a, t):
        return stridge_qr(X_tr_s, y_tr, alpha=a, threshold=t, max_iter=25)

    f_t = _jax.vmap(solve_one, in_axes=(None, 0))
    coeffs = _jax.vmap(f_t, in_axes=(0, None))(alphas, thresholds) / scale
    return _score_grid(coeffs, X_te, y_te)


@_jax.jit
def _grid_solve_and_score(X_tr_s, y_tr, X_te, y_te, scale, alphas, thresholds):
    """Grid STRidge + per-point test metrics fully on device.

    Returns (coeffs[(A,T,p)], r2[(A,T)], rmse[(A,T)], n_active[(A,T)]).
    """
    stats = gram_stats(X_tr_s, y_tr)
    coeffs_grid, _masks = stridge_grid(stats, alphas, thresholds, max_iter=25)
    coeffs_grid = coeffs_grid / scale
    preds = jnp.einsum("atp,np->atn", coeffs_grid, X_te)
    resid2 = jnp.sum((preds - y_te[None, None, :]) ** 2, axis=-1)
    sst = jnp.sum((y_te - jnp.mean(y_te)) ** 2)
    r2 = 1.0 - resid2 / (sst + 1e-18)
    err = jnp.sqrt(resid2 / y_te.shape[0])
    n_active = jnp.sum(jnp.abs(coeffs_grid) > 0, axis=-1)
    return coeffs_grid, r2, err, n_active


def _maybe_sharded_gram(cfg: Ks2dBenchConfig, X: jnp.ndarray, y: jnp.ndarray):
    """Gram sufficient statistics, sample-sharded across the device mesh when
    more than one device is available (mesh='auto') or forced (mesh='on').

    Rows are zero-weight-padded to a device-count multiple, so the sharded
    statistics are EXACTLY the single-device ones (coefficient-identical)."""
    import jax

    n_dev = jax.device_count()
    use_mesh = cfg.mesh == "on" or (cfg.mesh == "auto" and n_dev > 1)
    if not use_mesh or n_dev < 2:
        return gram_stats(X, y)
    from pdx.shard.mesh import make_mesh, shard_batch, sharded_gram_stats

    n = X.shape[0]
    n_pad = (-n) % n_dev
    w = jnp.concatenate([jnp.ones((n,), X.dtype), jnp.zeros((n_pad,), X.dtype)])
    Xp = jnp.concatenate([X, jnp.zeros((n_pad, X.shape[1]), X.dtype)])
    yp = jnp.concatenate([y, jnp.zeros((n_pad,), y.dtype)])
    mesh = make_mesh(n_dev)
    return sharded_gram_stats(
        shard_batch(Xp, mesh), shard_batch(yp, mesh), mesh, weights=shard_batch(w, mesh)
    )


def _rms_scale(X_tr: jnp.ndarray, names: list[str]) -> jnp.ndarray:
    """Per-column RMS scaling on the train split; constant column unscaled
    (main:1645-1655)."""
    scale = jnp.sqrt(jnp.mean(X_tr**2, axis=0)) + 1e-12
    const = jnp.asarray([1.0 if n == "one" else 0.0 for n in names], dtype=X_tr.dtype)
    return jnp.where(const > 0, 1.0, scale)


def run_regression(cfg: Ks2dBenchConfig, names, X_tr, y_tr, X_te, y_te):
    """Regression dispatch incl. grid search (main:1666-1778)."""
    scale = _rms_scale(X_tr, names)
    X_tr_s = X_tr / scale
    X_te_s = X_te / scale

    signs = list(cfg.sign_constraints) if cfg.sign_constraints else None
    if signs is not None and len(signs) != X_tr.shape[1]:
        signs = None

    robust_info = None

    def do_regression(alpha: float, threshold: float):
        nonlocal robust_info
        if cfg.robust:
            c_s, info = robust_stridge(
                X_tr_s, y_tr, alpha=alpha, threshold=threshold, max_iter=25,
                use_huber=True, huber_delta=cfg.huber_delta, trim_frac=cfg.trim_frac,
                n_bootstrap=cfg.n_bootstrap, signs=signs,
            )
            robust_info = info
            return c_s
        if cfg.regression == "huber":
            return stridge_huber(
                X_tr_s, y_tr, alpha=alpha, threshold=threshold, max_iter=25,
                huber_delta=cfg.huber_delta,
            )
        if cfg.regression == "trimmed":
            return trimmed_stridge(
                X_tr_s, y_tr, alpha=alpha, threshold=threshold, max_iter=25,
                trim_frac=cfg.trim_frac,
            )
        if cfg.regression == "sign_constrained":
            return stridge_sign_constrained(
                X_tr_s, y_tr, alpha=alpha, threshold=threshold, max_iter=25, signs=signs
            )
        if cfg.regression == "ensemble":
            mean_c, std_c = ensemble_stridge(
                X_tr_s, y_tr, alpha=alpha, threshold=threshold, max_iter=25,
                n_bootstrap=cfg.n_bootstrap, use_huber=True, huber_delta=cfg.huber_delta,
            )
            robust_info = {"std": std_c}
            return mean_c
        if use_qr:
            from pdx.solve.stridge import stridge_qr

            return stridge_qr(X_tr_s, y_tr, alpha=alpha, threshold=threshold, max_iter=25)
        # standard STRidge on sufficient statistics (sample axis sharded over
        # the device mesh when available — psum Gram reduction over NCCL)
        stats = _maybe_sharded_gram(cfg, X_tr_s, y_tr)
        return stridge_from_stats(stats, alpha=alpha, threshold=threshold, max_iter=25).coeffs

    if cfg.solver == "qr":
        use_qr = True
    elif cfg.solver == "gram":
        use_qr = False
    else:
        # auto: on f32 backends, pick QR only when the standardized Gram is
        # ill-conditioned enough that normal equations lose accuracy
        # (cond(G) * eps_f32 would exceed ~1e-3 coefficient error). The cond
        # estimate costs one (p, p) eigendecomposition.
        use_qr = False
        if jnp.dtype(cfg.dtype) != jnp.float64:
            from pdx.ops.linalg import standardized_stats

            Gs_probe, _, _, _ = standardized_stats(gram_stats(X_tr_s, y_tr))
            cond = float(jnp.linalg.cond(Gs_probe.astype(jnp.float32)))
            use_qr = cond > 1e4

    if cfg.grid_search and cfg.regression == "standard" and not cfg.robust:
        # batched grid: one device dispatch for all 30 hyperparameter points,
        # metrics computed on device, one host transfer for the tiny selection
        if use_qr:
            from pdx.solve.stridge import _grid_solve_qr

            grid_out = _grid_solve_qr(
                X_tr_s, y_tr, X_te, y_te, scale,
                jnp.asarray(GRID_ALPHAS, X_tr.dtype), jnp.asarray(GRID_THRESHOLDS, X_tr.dtype),
                25,
            )
        else:
            grid_out = _grid_solve_and_score(
                X_tr_s, y_tr, X_te, y_te, scale,
                jnp.asarray(GRID_ALPHAS, X_tr.dtype), jnp.asarray(GRID_THRESHOLDS, X_tr.dtype),
            )
        coeffs_np, r2_np, rmse_np, nact_np = [np.asarray(v) for v in grid_out]
        best = None
        for ai, a in enumerate(GRID_ALPHAS):
            for ti, t in enumerate(GRID_THRESHOLDS):
                key = (float(r2_np[ai, ti]), -int(nact_np[ai, ti]), -float(rmse_np[ai, ti]))
                if best is None or key > best["key"]:
                    best = {
                        "key": key, "alpha": a, "threshold": t,
                        "coeffs": jnp.asarray(coeffs_np[ai, ti]),
                        "r2_test": key[0], "rmse_test": -key[2], "n_active": -key[1],
                    }
        return best["coeffs"], {"grid_best": {k: v for k, v in best.items() if k not in ("coeffs", "key")}}

    if cfg.grid_search:
        best = None
        for a in GRID_ALPHAS:
            for t in GRID_THRESHOLDS:
                c = do_regression(a, t) / scale
                y_pred = X_te @ c
                r2 = float(r2_score(y_te, y_pred))
                err = float(rmse(y_te, y_pred))
                n_active = int(jnp.sum(jnp.abs(c) > 0))
                key = (r2, -n_active, -err)
                if best is None or key > best["key"]:
                    best = {
                        "key": key, "alpha": a, "threshold": t, "coeffs": c,
                        "r2_test": r2, "rmse_test": err, "n_active": n_active,
                    }
        return best["coeffs"], {"grid_best": {k: v for k, v in best.items() if k != "coeffs"}}

    c_s = do_regression(float(cfg.alpha), float(cfg.threshold))
    if isinstance(c_s, tuple):  # robust returns (coeffs, info)
        c_s = c_s[0]
    c = c_s / scale
    return c, {"robust_info": robust_info}


def _run_fast_pointwise_grid(cfg: Ks2dBenchConfig, fr: dict[str, Any], rng: np.random.Generator) -> dict[str, Any]:
    """Fused grid-search benchmark (see _fused_pointwise_grid)."""
    include_adv = cfg.include_advection and not cfg.enforce_no_advection
    if cfg.dictionary == "true":
        names = ["lap", "bih", "gradsq"] + (["ux", "uy"] if include_adv else [])
    else:
        names = ["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"]
        if cfg.enforce_no_advection:
            names = [n for n in names if n not in ("ux", "uy")]

    if cfg.solver == "fullfield":
        if cfg.derivatives != "finite":
            raise ValueError(
                "solver='fullfield' sums finite-difference stencil terms; "
                "set derivatives='finite'"
            )
        blocks = (
            (int(cfg.block_t), int(cfg.block_x), int(cfg.block_y))
            if cfg.method == "blockwise" else None
        )
        dtype = fr["U_for_ut"].dtype
        coeffs_grid, r2g, errg, nactg = _fullfield_grid(
            fr["U_for_ut"], fr["U_for_features"],
            float(fr["DT"]), float(fr["dx"]), float(fr["dy"]),
            jnp.asarray(GRID_ALPHAS, dtype), jnp.asarray(GRID_THRESHOLDS, dtype),
            tuple(names), blocks,
        )
    else:
        Ut_size = (fr["U_for_ut"].shape[0] - 1) * cfg.Nx * cfg.Ny
        n_sample = int(min(cfg.n_sample, Ut_size))
        flat_idx = rng.choice(Ut_size, size=n_sample, replace=False)
        perm = rng.permutation(n_sample)  # all-finite by construction (nan guards)
        split = int(0.7 * n_sample)

        # 'auto' solver without a cond probe: the true dictionary is
        # well-conditioned by construction (Gram path); rich dictionaries get
        # QR on f32 backends
        if cfg.solver == "qr":
            use_qr = True
        elif cfg.solver == "gram":
            use_qr = False
        else:
            use_qr = cfg.dictionary != "true" and jnp.dtype(cfg.dtype) != jnp.float64

        coeffs_grid, r2g, errg, nactg = _fused_pointwise_grid(
            fr["U_for_ut"], fr["U_for_features"],
            jnp.asarray(flat_idx), jnp.asarray(perm[:split]), jnp.asarray(perm[split:]),
            fr["DT"], fr["dx"], fr["dy"],
            jnp.asarray(GRID_ALPHAS, jnp.dtype(cfg.dtype)),
            jnp.asarray(GRID_THRESHOLDS, jnp.dtype(cfg.dtype)),
            tuple(names), cfg.derivatives, use_qr,
        )
    # ONE bundled device->host read: device_get starts every async copy
    # before blocking, so the 4 arrays cost one round-trip instead of four
    coeffs_np, r2_np, rmse_np, nact_np = jax.device_get(
        (coeffs_grid, r2g, errg, nactg)
    )
    best = None
    for ai, a in enumerate(GRID_ALPHAS):
        for ti, t in enumerate(GRID_THRESHOLDS):
            key = (float(r2_np[ai, ti]), -int(nact_np[ai, ti]), -float(rmse_np[ai, ti]))
            if best is None or key > best["key"]:
                best = {
                    "key": key, "alpha": a, "threshold": t,
                    "coeffs": coeffs_np[ai, ti],  # host-side: scalar reads are free
                    "r2_test": key[0], "rmse_test": -key[2], "n_active": -key[1],
                }
    coeffs = best["coeffs"]

    gt_errors = {}
    for key, v in KS_GT.items():
        if key in names:
            est = float(coeffs[names.index(key)])
            gt_errors[key] = {
                "gt": v, "est": est, "rel_err_pct": abs(est - v) / (abs(v) + 1e-12) * 100.0,
            }

    U = fr["U"]
    n_roll = int(min(cfg.rollout_steps, U.shape[0] - 1))
    # one device->host transfer for the whole curve (per-element float() on a
    # device array costs one round-trip each); coefficients enter as a
    # runtime vector so repeated runs reuse one compiled rollout
    errs = np.asarray(
        rollout_rmse_curve_named(U, coeffs, names, n_roll, fr["DT"], fr["dx"], fr["dy"])
    )
    return {
        "config": dataclasses.asdict(cfg),
        "names": names,
        "display_names": display_names(names),
        "coeffs": [float(c) for c in coeffs],
        "gt_errors": gt_errors,
        "fit": {
            "test_r2": best["r2_test"], "test_rmse": best["rmse_test"],
            "n_active": int(best["n_active"]),
        },
        "rollout": {
            "first": float(errs[0]), "last": float(errs[-1]),
            "mean": float(errs.mean()), "n_steps": n_roll,
        },
        "grid_best": {k: v for k, v in best.items() if k not in ("coeffs", "key")},
    }


VALID_METHODS = {"pointwise", "blockwise", "weakform"}
VALID_REGRESSIONS = {"standard", "huber", "trimmed", "sign_constrained", "ensemble"}
VALID_SOLVERS = {"auto", "gram", "qr", "fullfield"}


def run(cfg: Ks2dBenchConfig) -> dict[str, Any]:
    if cfg.method not in VALID_METHODS:
        raise ValueError(f"method must be one of {sorted(VALID_METHODS)}, got '{cfg.method}'")
    if cfg.regression not in VALID_REGRESSIONS:
        raise ValueError(
            f"regression must be one of {sorted(VALID_REGRESSIONS)}, got '{cfg.regression}'"
        )
    if cfg.solver not in VALID_SOLVERS:
        raise ValueError(f"solver must be one of {sorted(VALID_SOLVERS)}, got '{cfg.solver}'")
    if jnp.dtype(cfg.dtype).itemsize == 8 and not jax.config.jax_enable_x64:
        # without x64, jnp silently downcasts float64 to float32 — the run
        # would claim f64 precision while computing in f32
        jax.config.update("jax_enable_x64", True)
    fr = prepare_frames(cfg)
    rng = np.random.default_rng(0)  # reference: main:1470

    # fast path: the grid-search pointwise benchmark fuses dataset build,
    # split, and the whole hyperparameter sweep into one XLA dispatch
    fast = (
        (
            cfg.method == "pointwise"
            or (cfg.method == "blockwise" and cfg.solver == "fullfield")
        )
        and cfg.regression == "standard"
        and not cfg.robust
        and cfg.grid_search
        and not cfg.correct_shift_ut
    )
    if cfg.solver == "fullfield" and not fast:
        raise ValueError(
            "solver='fullfield' is the full-field grid path: requires "
            "method='pointwise' or 'blockwise', regression='standard', "
            "grid_search=True, robust=False, correct_shift_ut=False"
        )
    if fast:
        return _run_fast_pointwise_grid(cfg, fr, rng)

    names, X_all, y_all = build_dataset(cfg, fr, rng)

    # finite filter (matches reference boolean filtering). Fast path: when
    # every row is finite (all clean/noise configs), only a single scalar
    # leaves the device and the split gather stays on-device; otherwise fall
    # back to host filtering (row set must match the reference's exactly).
    n_rows = int(X_all.shape[0])
    all_finite = bool(jnp.isfinite(X_all).all() & jnp.isfinite(y_all).all())
    if all_finite:
        perm = rng.permutation(n_rows)  # same rng draw as the reference path
        split = int(0.7 * n_rows)
        tr = jnp.asarray(perm[:split])
        te = jnp.asarray(perm[split:])
        X_tr, y_tr = X_all[tr], y_all[tr]
        X_te, y_te = X_all[te], y_all[te]
    else:
        Xn = np.asarray(X_all)
        yn = np.asarray(y_all)
        valid = np.isfinite(Xn).all(axis=1) & np.isfinite(yn)
        Xn, yn = Xn[valid], yn[valid]
        perm = rng.permutation(len(yn))
        split = int(0.7 * len(yn))
        X_tr = jnp.asarray(Xn[perm[:split]])
        y_tr = jnp.asarray(yn[perm[:split]])
        X_te = jnp.asarray(Xn[perm[split:]])
        y_te = jnp.asarray(yn[perm[split:]])

    coeffs, reg_info = run_regression(cfg, names, X_tr, y_tr, X_te, y_te)
    coeffs_np = np.asarray(coeffs)  # single transfer; host scalar reads below
    coeffs = jnp.asarray(coeffs_np)

    # ground-truth comparison (main:1786-1791)
    gt_errors = {}
    for key, v in KS_GT.items():
        if key in names:
            est = float(coeffs_np[names.index(key)])
            gt_errors[key] = {
                "gt": v,
                "est": est,
                "rel_err_pct": abs(est - v) / (abs(v) + 1e-12) * 100.0,
            }

    y_pred_tr = X_tr @ coeffs
    y_pred_te = X_te @ coeffs
    fit = {
        "train_r2": float(r2_score(y_tr, y_pred_tr)),
        "train_rmse": float(rmse(y_tr, y_pred_tr)),
        "test_r2": float(r2_score(y_te, y_pred_te)),
        "test_rmse": float(rmse(y_te, y_pred_te)),
        "n_active": int((np.abs(coeffs_np) > 0).sum()),
    }

    # rollout (main:1805-1838); one transfer for the whole curve, shared
    # compiled program across runs (coefficients are a runtime vector)
    U = fr["U"]
    n_roll = int(min(cfg.rollout_steps, U.shape[0] - 1))
    errs = np.asarray(
        rollout_rmse_curve_named(U, coeffs, names, n_roll, fr["DT"], fr["dx"], fr["dy"])
    )
    rollout = {
        "first": float(errs[0]),
        "last": float(errs[-1]),
        "mean": float(errs.mean()),
        "n_steps": n_roll,
    }

    return {
        "config": dataclasses.asdict(cfg),
        "names": names,
        "display_names": display_names(names),
        "coeffs": [float(c) for c in coeffs_np],
        "gt_errors": gt_errors,
        "fit": fit,
        "rollout": rollout,
        **reg_info,
    }
