"""Transport-form (continuity-equation) PDE discovery on real images.

End-to-end parity with ``scripts/transport_pde_discovery.py``: load TIFFs ->
max-normalize -> Farnebäck velocity fields for all consecutive pairs (4x
downsampled) -> 13-term transport library with np.gradient(edge_order=2)
derivatives -> light spatial smoothing -> Lasso sweep over alpha in
{0.001, 0.01, 0.1}.

Device structure: all frame-pair flows are one vmapped pyramid flow
(the reference loops 50 cv2 calls); the library is built by batched stencils;
Lasso runs on device (FISTA on the Gram — same convex minimizer as sklearn's
coordinate descent).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from pdx.io_host.images import load_images
from pdx.io_host.artifacts import write_json
from pdx.ops.fd import gradient_edge2
from pdx.ops.filters import gaussian_filter_reflect
from pdx.ops.interp import resize_bilinear
from pdx.register.farneback import farneback_flow_pairs
from pdx.solve.lasso import lasso_ista

TERM_NAMES = [
    "constant", "rho", "drho_dx", "drho_dy", "laplacian", "transport",
    "rho_div", "advection", "rho_u", "rho_v", "rho_squared", "u_drho_dx", "v_drho_dy",
]


@dataclass(frozen=True)
class TransportConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/transport"
    max_images: int = 51
    downsample: int = 4
    dt: float = 1.0
    dx: float = 1.0
    dy: float = 1.0
    spatial_smooth: float = 0.5
    alphas: tuple[float, ...] = (0.001, 0.01, 0.1)
    # flow parameters (transport_pde_discovery.py:68-78)
    flow_levels: int = 3
    flow_winsize: int = 15
    flow_iterations: int = 3
    flow_poly_n: int = 5
    flow_poly_sigma: float = 1.2
    dtype: str = "float64"
    write_artifacts: bool = True


def build_transport_library(
    rho: jnp.ndarray,
    flow_u: jnp.ndarray,
    flow_v: jnp.ndarray,
    dt: float = 1.0,
    dx: float = 1.0,
    dy: float = 1.0,
) -> tuple[dict[str, jnp.ndarray], jnp.ndarray]:
    """13-term library + target (transport_pde_discovery.py:85-147).

    Convention (reference): x = cols (axis 2), y = rows (axis 1); flow_u is
    the col-displacement field, flow_v the row-displacement.
    """
    drho_dt = gradient_edge2(rho, dt, 0)
    drho_dx = gradient_edge2(rho, dx, 2)
    drho_dy = gradient_edge2(rho, dy, 1)
    d2x = gradient_edge2(drho_dx, dx, 2)
    d2y = gradient_edge2(drho_dy, dy, 1)
    laplacian = d2x + d2y
    du_dx = gradient_edge2(flow_u, dx, 2)
    dv_dy = gradient_edge2(flow_v, dy, 1)
    divergence = du_dx + dv_dy
    advection = flow_u * drho_dx[:-1] + flow_v * drho_dy[:-1]
    rho_div = rho[:-1] * divergence
    library = {
        "constant": jnp.ones_like(rho[:-1]),
        "rho": rho[:-1],
        "drho_dx": drho_dx[:-1],
        "drho_dy": drho_dy[:-1],
        "laplacian": laplacian[:-1],
        "transport": rho_div + advection,
        "rho_div": rho_div,
        "advection": advection,
        "rho_u": rho[:-1] * flow_u,
        "rho_v": rho[:-1] * flow_v,
        "rho_squared": rho[:-1] ** 2,
        "u_drho_dx": flow_u * drho_dx[:-1],
        "v_drho_dy": flow_v * drho_dy[:-1],
    }
    return library, drho_dt[:-1]


from functools import partial as _partial

import jax as _jax


@_partial(_jax.jit, static_argnames=("dt", "dx", "dy", "spatial_smooth"))
def _discover(imgs_ds, flow_u, flow_v, alphas_arr, *, dt, dx, dy, spatial_smooth):
    """The whole discovery — library build, finite-row masking, the full
    Lasso alpha sweep, and fit metrics — as ONE module-level compiled
    program; only the (n_alpha, p) coefficients and a handful of scalars
    ever cross the device link (materializing X on the host for the finite
    filter moved a ~200 MB design matrix to the host and back, and a
    jit built inside run() recompiled on every call)."""
    library, target = build_transport_library(imgs_ds, flow_u, flow_v, dt, dx, dy)
    if spatial_smooth > 0:
        library = {k: gaussian_filter_reflect(v, spatial_smooth) for k, v in library.items()}
        target = gaussian_filter_reflect(target, spatial_smooth)
    X = jnp.stack([library[n].reshape(-1) for n in TERM_NAMES], axis=1)
    y = target.reshape(-1)
    finite = jnp.isfinite(X).all(axis=1) & jnp.isfinite(y)
    mask = finite.astype(X.dtype)
    X = jnp.where(finite[:, None], X, 0.0)
    y = jnp.where(finite, y, 0.0)
    n_eff = jnp.sum(mask)
    y_mean = jnp.sum(y * mask) / n_eff
    ss_tot = jnp.sum(((y - y_mean) * mask) ** 2)

    def one(alpha):
        coef, intercept = lasso_ista(X, y, alpha, max_iter=5000, row_mask=mask)
        resid = (y - (X @ coef + intercept)) * mask
        ss_res = jnp.sum(resid**2)
        return coef, intercept, ss_res, jnp.sum(jnp.abs(resid)) / n_eff

    coefs, intercepts, ss_res_v, mae_v = _jax.vmap(one)(alphas_arr)
    return coefs, intercepts, ss_res_v, mae_v, ss_tot, n_eff


def run(
    cfg: TransportConfig,
    U_raw: np.ndarray | None = None,
    timer=None,
) -> dict[str, Any]:
    from pdx.utils.precision import resolve_dtype
    from pdx.utils.profiling import null_stage, sync_point

    st = timer.stage if timer is not None else null_stage
    dtype = resolve_dtype(cfg.dtype)
    with st("load_images"):
        if U_raw is None:
            # raw camera bytes to the device (u16 hint halves the ship
            # vs f32; safe-cast fallback in load_images), cast + /max ON
            # DEVICE — same pattern as patch_discovery (reference loads
            # IMREAD_UNCHANGED u16 and max-normalizes,
            # transport_pde_discovery.py:32-41)
            U_raw = load_images(cfg.data_dir, max_images=cfg.max_images, dtype=np.uint16)
    with st("ship_normalize_resize"):
        from pdx.io_host.images import device_stack

        images = device_stack(U_raw, dtype)
        images = images / images.max()

        T, H, W = images.shape
        h_ds, w_ds = H // cfg.downsample, W // cfg.downsample
        imgs_ds = resize_bilinear(images, h_ds, w_ds)

        # per-pair min-max normalization for flow estimation (reference
        # normalizes each frame to 0-255 before Farnebäck)
        mn = imgs_ds.min(axis=(1, 2), keepdims=True)
        mx = imgs_ds.max(axis=(1, 2), keepdims=True)
        imgs_n = (imgs_ds - mn) / (mx - mn + 1e-12)
        if timer is not None:
            sync_point(imgs_n)
    with st("pair_flows"):
        flow_r, flow_c = farneback_flow_pairs(
            imgs_n,
            pyr_scale=0.5,
            levels=cfg.flow_levels,
            winsize=cfg.flow_winsize,
            iterations=cfg.flow_iterations,
            poly_n=cfg.flow_poly_n,
            poly_sigma=cfg.flow_poly_sigma,
            gaussian_win=False,
        )
        # reference convention: flow_u = col component, flow_v = row component
        flow_u, flow_v = flow_c, flow_r
        if timer is not None:
            sync_point(flow_u)

    with st("discover_lasso_sweep"):
        alphas_arr = jnp.asarray(cfg.alphas, dtype=imgs_ds.dtype)
        coefs, intercepts, ss_res_v, mae_v, ss_tot, n_eff = _discover(
            imgs_ds, flow_u, flow_v, alphas_arr,
            dt=cfg.dt, dx=cfg.dx, dy=cfg.dy, spatial_smooth=cfg.spatial_smooth,
        )
        if timer is not None:
            sync_point(coefs)
    with st("host_readback"):
        # ONE bundled device->host read (sequential np.asarray reads pay a
        # round-trip each); mean flow speed joins the bundle
        coefs, intercepts, ss_res_v, mae_v, ss_tot, n_eff, mean_speed = jax.device_get(
            (coefs, intercepts, ss_res_v, mae_v, ss_tot, n_eff,
             _mean_speed(flow_u, flow_v))
        )
    ss_tot, n_eff, mean_speed = float(ss_tot), float(n_eff), float(mean_speed)

    results = {}
    for ai, alpha in enumerate(cfg.alphas):
        coef = coefs[ai]
        active = [(n, float(c)) for n, c in zip(TERM_NAMES, coef) if abs(float(c)) > 1e-10]
        results[float(alpha)] = {
            "coefficients": coef,
            "intercept": float(intercepts[ai]),
            "active_terms": active,
            "r2": 1.0 - float(ss_res_v[ai]) / ss_tot,
            "mse": float(ss_res_v[ai]) / n_eff,
            "mae": float(mae_v[ai]),
        }

    out = {
        "config": dataclasses.asdict(cfg),
        "term_names": TERM_NAMES,
        "results": results,
        "mean_flow_speed": mean_speed,
        "n_samples": int(n_eff),
    }
    if cfg.write_artifacts:
        from pathlib import Path

        with st("artifacts"):
            write_json(
                Path(cfg.output_dir) / "transport_results.json",
                {
                    "mean_flow_speed": mean_speed,
                    "term_names": TERM_NAMES,
                    "results": {
                        str(a): {k: v for k, v in r.items() if k != "model"}
                        for a, r in results.items()
                    },
                },
            )
    if timer is not None:
        out["stage_seconds"] = dict(timer.stages)
    return out


@jax.jit
def _mean_speed(fu, fv):
    return jnp.mean(jnp.sqrt(fu**2 + fv**2))


@jax.jit
def _frame_sums(U):
    return jnp.sum(U, axis=(1, 2))


def mass_conservation_drift(U) -> float:
    """Relative drift of total intensity over the sequence (the 0.54%
    transport-form premise, transport_pde_discovery.py:10)."""
    if isinstance(U, jnp.ndarray):
        # reduce on device, read only the (T,) sums — np.asarray(U) would
        # transfer the whole stack to the host
        sums = np.asarray(_frame_sums(U))
    else:
        sums = np.asarray(U).sum(axis=(1, 2))
    return float((sums.max() - sums.min()) / (sums.mean() + 1e-12) * 100.0)


def quick_run(cfg: TransportConfig, U_raw: np.ndarray | None = None) -> dict[str, Any]:
    """Smoke version: few frames, heavy downsample, plain least squares, and
    the physics sanity check (parity: transport_quick_test.py — 10 frames,
    8x downsample, lstsq, 'transport coefficient should be ~ -1' printout)."""
    from pdx.solve.lasso import lstsq_solve

    if U_raw is None:
        U_raw = load_images(cfg.data_dir, max_images=cfg.max_images, dtype=np.uint16)
    images = jnp.asarray(U_raw).astype(jnp.result_type(float))
    images = images / images.max()
    T, H, W = images.shape
    imgs_ds = resize_bilinear(images, H // cfg.downsample, W // cfg.downsample)
    mn = imgs_ds.min(axis=(1, 2), keepdims=True)
    mx = imgs_ds.max(axis=(1, 2), keepdims=True)
    flow_r, flow_c = farneback_flow_pairs(
        (imgs_ds - mn) / (mx - mn + 1e-12),
        pyr_scale=0.5, levels=cfg.flow_levels, winsize=cfg.flow_winsize,
        iterations=cfg.flow_iterations, poly_n=cfg.flow_poly_n,
        poly_sigma=cfg.flow_poly_sigma, gaussian_win=False,
    )
    library, target = build_transport_library(imgs_ds, flow_c, flow_r, cfg.dt, cfg.dx, cfg.dy)
    X = jnp.stack([library[n].reshape(-1) for n in TERM_NAMES], axis=1)
    y = target.reshape(-1)
    coef = lstsq_solve(X, y)
    transport_coef = float(coef[TERM_NAMES.index("transport")])
    resid = y - X @ coef
    r2 = 1.0 - float(jnp.sum(resid**2)) / float(jnp.sum((y - jnp.mean(y)) ** 2))
    return {
        "coefficients": np.asarray(coef),
        "term_names": TERM_NAMES,
        "r2": r2,
        "transport_coef": transport_coef,
        "physics_check": (
            "continuity form predicts transport coefficient ~ -1; "
            f"got {transport_coef:+.4f}"
        ),
        "mean_flow_speed": float(jnp.mean(jnp.sqrt(flow_r**2 + flow_c**2))),
    }


def cmd_transport(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx transport")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/transport")
    parser.add_argument("--max-images", type=int, default=51)
    parser.add_argument("--downsample", type=int, default=4)
    parser.add_argument("--quick", action="store_true", help="10-frame 8x-downsample lstsq smoke test")
    args = parser.parse_args(argv)
    cfg = TransportConfig(
        data_dir=args.data_dir, output_dir=args.output_dir,
        max_images=args.max_images, downsample=args.downsample,
    )
    if args.quick:
        cfg = dataclasses.replace(cfg, max_images=min(cfg.max_images, 10), downsample=8)
        q = quick_run(cfg)
        print(f"Mean optical-flow speed: {q['mean_flow_speed']:.3f} px/frame")
        print(f"R2 (lstsq, all terms): {q['r2']:.6f}")
        print(q["physics_check"])
        return 0
    out = run(cfg)
    print(f"Mean optical-flow speed: {out['mean_flow_speed']:.3f} px/frame")
    for alpha, r in out["results"].items():
        print(f"\nalpha={alpha}: R2={r['r2']:.6f}, active={len(r['active_terms'])}/{len(out['term_names'])}")
        for n, c in r["active_terms"]:
            print(f"  {c:+.6e} * {n}")
    return 0
