"""Patch-based PDE discovery (robust local-poly derivatives + stability selection).

End-to-end parity with ``scripts/patch_based_pde_discovery.py``: load ->
downsample/denoise/normalize -> [Farnebäck registration] -> smooth ->
crop/subsample -> overlapping patch grid -> per-patch sampled local-poly
derivative datasets -> per-patch STRidge -> stability aggregation
(median/IQR/frequency/sign, keep freq >= 0.6) -> global held-out-time
evaluation + one-step check -> CSV/report artifacts.

Device structure: the reference loops patches and, per sample point, runs
a fresh lstsq (patch_based_pde_discovery.py:395-429) — here all patches' all
sample points become ONE batched gather + GEMM (pdx.library.localpoly), and
all per-patch STRidge fits are one vmapped masked-solve batch over the patch
axis (shardable across devices). Sample-point RNG draws happen on the host in
the reference's exact order for golden parity.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from pdx.io_host.images import load_images
from pdx.io_host.artifacts import write_patch_csv, write_json
from pdx.ops.interp import resize_area
from pdx.ops.filters import gaussian_filter_reflect
from pdx.ops.metrics import regression_metrics
from pdx.ops.linalg import gram_stats
from pdx.library.localpoly import local_poly_derivatives_batch
from pdx.solve.stridge import stridge_from_stats

FULL_TERMS = ["one", "u", "ux", "uy", "lap", "u2", "u_ux", "u_uy"]
MODEL4_TERMS = ["one", "u", "ux", "uy", "lap", "u2"]
DISPLAY = {"one": "1", "u": "u", "ux": "u_x", "uy": "u_y", "lap": "lap(u)", "u2": "u^2", "u_ux": "u*u_x", "u_uy": "u*u_y"}


@dataclass(frozen=True)
class PatchDiscoveryConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/patch_pde"
    max_images: int = 51
    seed: int = 0
    registration: bool = True
    register_mode: str = "auto"  # auto | compose | chain | to_first (see analyze)
    register_refine: int = 1  # re-warp refinement passes per flow (see analyze)
    rt: int = 2
    rs: int = 3
    deg: int = 3
    patch: int = 21
    overlap: int = 10
    samples_per_patch: int = 120
    train_frac: float = 0.7
    alpha: float = 0.01
    threshold: float = 1e-5
    stability_freq: float = 0.6
    model: str = "full"  # full | model4
    # preprocessing constants (patch_based_pde_discovery.py:332-352)
    downsample: int = 2
    denoise_sigma1: float = 1.0
    denoise_sigma2: float = 1.2
    skip: int = 25
    subsample: int = 12
    dx: float = 0.1
    dy: float = 0.1
    dt: float = 1.0
    reference_compat_warp: bool = False
    dtype: str = "float64"
    write_artifacts: bool = True
    # multi-chip: shard the patch axis over all visible devices ('auto'
    # enables it when >1 device; padding patches are sliced off, so the
    # coefficients are identical to the single-device run)
    mesh: str = "auto"  # auto | off | on


def patch_grid(h: int, w: int, patch: int, overlap: int) -> list[tuple[int, int]]:
    """Parity: patch_based_pde_discovery.py:283-289."""
    stride = max(1, patch - overlap)
    return [(y0, x0) for y0 in range(0, h - patch + 1, stride) for x0 in range(0, w - patch + 1, stride)]


def feature_matrix(derivs: jnp.ndarray, names: list[str]) -> jnp.ndarray:
    """(N, 6) local-poly derivatives -> (N, p) library rows
    (Library.feature_vector, patch_based_pde_discovery.py:156-173)."""
    u, _ut, ux, uy, uxx, uyy = [derivs[:, i] for i in range(6)]
    lap = uxx + uyy
    fields = {
        "one": jnp.ones_like(u),
        "u": u,
        "ux": ux,
        "uy": uy,
        "lap": lap,
        "u2": u**2,
        "u_ux": u * ux,
        "u_uy": u * uy,
    }
    return jnp.stack([fields[n] for n in names], axis=1)


from functools import partial as _partial


@jax.jit
def _heldout_eval(U, Xg, yg, Xs, spts, agg, dt):
    """Global held-out metrics + one-step RMSE (reference :446-465) as one
    device program; feature matrices enter precomputed, the frame-difference
    gather runs on device."""
    pred_g = Xg @ agg
    m = dict(regression_metrics(yg, pred_g))
    m["resid_med_abs"] = jnp.median(jnp.abs(yg - pred_g))
    du = (
        U[spts[:, 0] + 1, spts[:, 1], spts[:, 2]]
        - U[spts[:, 0], spts[:, 1], spts[:, 2]]
    )
    one_step = jnp.sqrt(jnp.mean((du - dt * (Xs @ agg)) ** 2))
    return m, one_step


@_partial(jax.jit, static_argnames=("names", "alpha", "threshold"))
def _all_patch_fits(d_tr, d_te, *, names, alpha, threshold):
    """Vmapped per-patch STRidge fits as one MODULE-LEVEL compiled program
    (a jit built inside run() recompiles on every pipeline call)."""

    def patch_fit(dtr, dte):
        X_tr = feature_matrix(dtr, list(names))
        y_tr = dtr[:, 1]
        X_te = feature_matrix(dte, list(names))
        y_te = dte[:, 1]
        c = stridge_from_stats(
            gram_stats(X_tr, y_tr), alpha=alpha, threshold=threshold, max_iter=25
        ).coeffs
        m_tr = regression_metrics(y_tr, X_tr @ c)
        m_te = regression_metrics(y_te, X_te @ c)
        return c, m_tr, m_te

    return jax.vmap(patch_fit)(d_tr, d_te)


def run(cfg: PatchDiscoveryConfig, U_raw: np.ndarray | None = None) -> dict[str, Any]:
    from pdx.utils.precision import resolve_dtype

    dtype = resolve_dtype(cfg.dtype)
    if U_raw is None:
        # raw u16 to the device (half the host-to-device traffic of f32); the
        # fused preprocess head downsamples at the input dtype and casts
        # on-device (bit-identical, preprocess.py:39-43)
        U_raw = load_images(cfg.data_dir, max_images=cfg.max_images, dtype=np.uint16)

    from pdx.preprocess import resize_denoise_normalize

    from pdx.io_host.images import device_stack

    T0, H0, W0 = U_raw.shape
    U = resize_denoise_normalize(
        device_stack(U_raw),
        out_h=H0 // cfg.downsample, out_w=W0 // cfg.downsample,
        sigma=cfg.denoise_sigma1, eps=1e-12, dtype_name=jnp.dtype(dtype).name,
    )
    if cfg.registration:
        from pdx.register.farneback import register_sequence_dispatch

        U = register_sequence_dispatch(
            U, mode=cfg.register_mode, refine=cfg.register_refine,
            reference_compat_warp=cfg.reference_compat_warp,
        )
    U = gaussian_filter_reflect(U, cfg.denoise_sigma2)
    s, sub = cfg.skip, cfg.subsample
    U = U[:, s:-s:sub, s:-s:sub]

    t_len, h, w = U.shape
    rt, rs = cfg.rt, cfg.rs
    t_min, t_max = rt, t_len - rt - 1
    if t_max <= t_min + 2:
        raise RuntimeError("too few frames for the local-poly time radius")
    t_valid = np.arange(t_min, t_max + 1)
    split = int(np.floor(cfg.train_frac * len(t_valid)))
    t_train, t_test = t_valid[:split], t_valid[split:]
    if len(t_test) < 3:
        raise RuntimeError("Test set too small.")

    names = MODEL4_TERMS if cfg.model == "model4" else FULL_TERMS
    coords = patch_grid(h, w, cfg.patch, cfg.overlap)
    if not coords:
        raise RuntimeError(
            f"Patch grid is empty: working grid {h}x{w} is smaller than patch={cfg.patch}. "
            "Reduce --patch or --subsample/--skip."
        )

    # --- host: per-patch sample points in the reference draw order ---
    rng = np.random.default_rng(cfg.seed)
    n_s = cfg.samples_per_patch
    n_te = max(30, n_s // 3)
    train_pts, test_pts, kept_coords = [], [], []
    for (y0, x0) in coords:
        ys_low, ys_high = max(rs, y0 + rs), min(h - rs, y0 + cfg.patch - rs)
        xs_low, xs_high = max(rs, x0 + rs), min(w - rs, x0 + cfg.patch - rs)
        if ys_high <= ys_low or xs_high <= xs_low:
            continue
        ys = rng.integers(ys_low, ys_high, size=n_s)
        xs = rng.integers(xs_low, xs_high, size=n_s)
        ts = rng.choice(t_train, size=n_s, replace=True)
        train_pts.append(np.stack([ts, ys, xs], axis=1))
        ys2 = rng.integers(ys_low, ys_high, size=n_te)
        xs2 = rng.integers(xs_low, xs_high, size=n_te)
        ts2 = rng.choice(t_test, size=n_te, replace=True)
        test_pts.append(np.stack([ts2, ys2, xs2], axis=1))
        kept_coords.append((y0, x0))

    P = len(train_pts)
    train_pts = np.stack(train_pts)  # (P, n_s, 3)
    test_pts = np.stack(test_pts)

    # --- device: ALL patches' derivatives in one batched gather+GEMM ---
    lp = lambda pts: local_poly_derivatives_batch(
        U, pts.reshape(-1, 3), rt=rt, rs=rs, deg=cfg.deg, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy
    )
    d_tr = lp(train_pts).reshape(P, n_s, 6)
    d_te = lp(test_pts).reshape(P, n_te, 6)

    # patch axis sharded over the device mesh (SURVEY §2.9 axis 1): the same
    # jitted vmap executes with patches split across chips; padding repeats
    # the last patch and is sliced off below, so results are identical
    from pdx.shard.mesh import maybe_shard_leading

    (d_tr, d_te), P = maybe_shard_leading((d_tr, d_te), cfg.mesh)
    coeffs, m_tr_v, m_te_v = _all_patch_fits(
        d_tr, d_te, names=tuple(names), alpha=cfg.alpha, threshold=cfg.threshold
    )
    # achieved placement of the patch-fit result (before any host transfer):
    # lets tests assert the mesh run actually PARTITIONED the patch axis
    # instead of XLA silently gathering to one device
    n_shard_devices = len({s.device for s in coeffs.addressable_shards})
    # ONE bundled device->host read for the whole fit-result pytree (each
    # sequential np.asarray pays its own round-trip)
    C, m_tr_np, m_te_np = jax.device_get((coeffs, m_tr_v, m_te_v))
    C = C[:P]  # (P, p)
    m_tr_np = {k: v[:P] for k, v in m_tr_np.items()}
    m_te_np = {k: v[:P] for k, v in m_te_np.items()}
    patch_train_metrics = [{k: float(v[i]) for k, v in m_tr_np.items()} for i in range(P)]
    patch_test_metrics = [{k: float(v[i]) for k, v in m_te_np.items()} for i in range(P)]

    # --- stability aggregation (reference :434-443 uses plain median, not
    # masked median, for the aggregate) ---
    nonzero = np.abs(C) > cfg.threshold
    freq = nonzero.mean(axis=0)
    median = np.median(C, axis=0)
    q25 = np.percentile(C, 25, axis=0)
    q75 = np.percentile(C, 75, axis=0)
    sign_stability = np.mean(np.sign(C) == np.sign(median + 1e-12), axis=0)
    keep = freq >= cfg.stability_freq
    agg = np.where(keep, median, 0.0)

    # --- global held-out evaluation (reference :446-465) ---
    gpts = _safe_sample_points(rng, t_test, h, w, rs, 800)
    dg = local_poly_derivatives_batch(U, gpts, rt=rt, rs=rs, deg=cfg.deg, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy)
    spts = _safe_sample_points(rng, t_valid[:-1], h, w, rs, 1200)
    ds = local_poly_derivatives_batch(U, spts, rt=rt, rs=rs, deg=cfg.deg, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy)
    # held-out metrics + one-step rmse in ONE jitted program + ONE bundled
    # read (the eager formulation paid a dispatch/read per metric)
    m_test, one_step_rmse = jax.device_get(_heldout_eval(
        U, feature_matrix(dg, names), dg[:, 1], feature_matrix(ds, names),
        jnp.asarray(spts), jnp.asarray(agg, U.dtype),
        jnp.asarray(cfg.dt, U.dtype),
    ))
    m_test = {k: float(v) for k, v in m_test.items()}
    one_step_rmse = float(one_step_rmse)

    eq_parts = []
    for coef, n in zip(agg, names):
        if abs(coef) > cfg.threshold:
            sign = "+" if coef > 0 and eq_parts else ""
            eq_parts.append(f"{sign}{coef:.4g}·{DISPLAY.get(n, n)}")
    equation = "u_t = " + (" ".join(eq_parts) if eq_parts else "0")

    stats = {
        "median": median, "q25": q25, "q75": q75, "freq": freq,
        "sign_stability": sign_stability, "keep": keep, "coeffs": agg,
    }
    out = {
        "config": dataclasses.asdict(cfg),
        "names": [DISPLAY.get(n, n) for n in names],
        "patch_coeffs": C,
        "stats": stats,
        "n_patches": P,
        "n_shard_devices": n_shard_devices,
        "working_shape": (t_len, h, w),
        "patch_train_metrics": patch_train_metrics,
        "patch_test_metrics": patch_test_metrics,
        "global_test_metrics": m_test,
        "one_step_rmse": one_step_rmse,
        "equation": equation,
    }

    if cfg.write_artifacts:
        out_dir = Path(cfg.output_dir)
        write_patch_csv(out_dir / "PATCH_PDE_COEFFS.csv", out["names"], stats)
        _write_report(out_dir / "PATCH_PDE_REPORT.txt", cfg, out)
        write_json(out_dir / "patch_pde_summary.json", {
            "equation": equation, "global_test_metrics": m_test,
            "one_step_rmse": one_step_rmse, "n_patches": P,
            "terms": out["names"], "agg_coeffs": agg,
        })
        # PATCH_PDE_SUMMARY.png (patch_based_pde_discovery.py:564-565)
        try:
            from pdx.report.pipeline_figures import patch_pde_summary
        except ImportError as e:  # matplotlib is optional
            print(f"   (skipped PATCH_PDE_SUMMARY.png: {e})")
        else:
            patch_pde_summary(out_dir, out["names"], stats, m_test,
                              one_step_rmse, cfg.stability_freq)
    return out


def _safe_sample_points(rng, t_indices, h, w, rs, n) -> np.ndarray:
    """Parity: safe_sample_points (patch_based_pde_discovery.py:249-260)."""
    ys = rng.integers(rs, h - rs, size=n)
    xs = rng.integers(rs, w - rs, size=n)
    ts = rng.choice(t_indices, size=n, replace=True)
    return np.stack([ts, ys, xs], axis=1)


def _write_report(path: Path, cfg: PatchDiscoveryConfig, out: dict) -> None:
    from datetime import datetime

    path.parent.mkdir(parents=True, exist_ok=True)

    def summarize(ms):
        return {
            "r2_mean": float(np.mean([m["r2"] for m in ms])),
            "r2_median": float(np.median([m["r2"] for m in ms])),
            "rmse_mean": float(np.mean([m["rmse"] for m in ms])),
            "rmse_median": float(np.median([m["rmse"] for m in ms])),
            "nrmse_mean": float(np.mean([m["nrmse"] for m in ms])),
        }

    tr, te = summarize(out["patch_train_metrics"]), summarize(out["patch_test_metrics"])
    m = out["global_test_metrics"]
    t_len, h, w = out["working_shape"]
    with path.open("w", encoding="utf-8") as f:
        f.write("PATCH-BASED PDE DISCOVERY REPORT (ROBUST)\n")
        f.write(f"Generated: {datetime.now():%Y-%m-%d %H:%M:%S}\n\n")
        f.write(f"Frames used: {cfg.max_images}\n")
        f.write(f"Grid after preprocessing: T={t_len}, H={h}, W={w}\n")
        f.write(f"Registration: {'ON' if cfg.registration else 'OFF'}\n")
        f.write(f"Local derivative neighborhood: rt={cfg.rt}, rs={cfg.rs}, degree={cfg.deg}\n")
        f.write(f"Patch grid: patch={cfg.patch}, overlap={cfg.overlap}, patches_fit={out['n_patches']}\n")
        f.write(f"Model term set: {cfg.model}\n")
        f.write(f"STRidge: alpha={cfg.alpha}, threshold={cfg.threshold}\n")
        f.write(f"Stability keep rule: nonzero_freq >= {cfg.stability_freq}\n\n")
        f.write("Per-patch metrics (train) summary:\n")
        f.write(f"  R2 mean={tr['r2_mean']:.4f}, median={tr['r2_median']:.4f}\n")
        f.write(f"  RMSE mean={tr['rmse_mean']:.6f}, median={tr['rmse_median']:.6f}\n\n")
        f.write("Per-patch metrics (test) summary:\n")
        f.write(f"  R2 mean={te['r2_mean']:.4f}, median={te['r2_median']:.4f}\n")
        f.write(f"  RMSE mean={te['rmse_mean']:.6f}, median={te['rmse_median']:.6f}\n\n")
        f.write("Aggregated model (test samples) metrics:\n")
        f.write(f"  R2={m['r2']:.6f}\n  RMSE={m['rmse']:.6f}\n  nRMSE={m['nrmse']:.3f}\n")
        f.write(f"  one-step RMSE (sampled)={out['one_step_rmse']:.6f}\n\n")
        f.write(f"Aggregated PDE:\n  {out['equation']}\n")


def cmd_patch_discover(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx patch-discover")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/patch_pde")
    parser.add_argument("--max-images", type=int, default=51)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-registration", action="store_true")
    parser.add_argument("--register-mode",
                        choices=["auto", "compose", "chain", "to_first"],
                        default="auto")
    parser.add_argument("--register-refine", type=int, default=1,
                        help="re-warp refinement passes per flow "
                        "(0 = strict cv2-equivalent, 2 = max quality)")
    parser.add_argument("--rt", type=int, default=2)
    parser.add_argument("--rs", type=int, default=3)
    parser.add_argument("--deg", type=int, default=3)
    parser.add_argument("--patch", type=int, default=21)
    parser.add_argument("--overlap", type=int, default=10)
    parser.add_argument("--samples-per-patch", type=int, default=120)
    parser.add_argument("--model", choices=["full", "model4"], default="full")
    parser.add_argument("--skip", type=int, default=25, help="crop margin in working pixels")
    parser.add_argument("--subsample", type=int, default=12, help="spatial subsample stride")
    args = parser.parse_args(argv)
    cfg = PatchDiscoveryConfig(
        data_dir=args.data_dir, output_dir=args.output_dir, max_images=args.max_images,
        seed=args.seed, registration=not args.no_registration,
        register_mode=args.register_mode, register_refine=args.register_refine,
        rt=args.rt, rs=args.rs,
        deg=args.deg, patch=args.patch, overlap=args.overlap,
        samples_per_patch=args.samples_per_patch, model=args.model,
        skip=args.skip, subsample=args.subsample,
    )
    out = run(cfg)
    print(f"Patches fit: {out['n_patches']}")
    print(f"Aggregated PDE: {out['equation']}")
    m = out["global_test_metrics"]
    print(f"Test: R2={m['r2']:.6f} RMSE={m['rmse']:.6f} nRMSE={m['nrmse']:.3f}")
    return 0
