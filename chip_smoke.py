"""Smoke test of pdx on NVIDIA GPUs: the main path end to end, in one process.

Usage (from the repository root):
    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --gpus 4   # four GPUs: the multi-device phase only

Phases of the one-GPU run, each printing its seconds and its checked numbers:
  device        platform is "gpu"; card name and power limit (nvidia-smi);
                an f32 512x512 matmul agrees with numpy f64 to 1e-5 (no TF32)
  ks2d          reference benchmark config (100x100, 2000 Euler steps, 30-fit
                grid, 50-step rollout): worst ground-truth error < 0.02%
  ks2d-f64      weak-form golden pair in float64 on the card: coefficients
                equal the reference's to 6 digits
  fullfield     full-field Gram statistics at T=2000, 100x100 (3-term, 9-term,
                blockwise 3x8x8) against numpy float64 on the host; then
                ks2d-bench --solver fullfield recovery < 1%
  real-image    analyze, patch-discover, patch-sindy and transport on a
                51x1024x1280 u16 synthetic stack: finite coefficients, the
                artifact files, and the registration residual
  comprehensive the 21 x 8 method matrix: no method may fail

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; it is
printed only when every phase passed. Without a GPU the script exits 1 and
prints no result. It starts no second JAX process: the only child process is
nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT = REPO / "outputs" / "chip_smoke"

# ks2d-f64 golden pair: the reference script's printed estimates for
# --Nx 48 --Ny 48 --n-seconds 0.4 --method weakform --weak-basis gaussian
# --alpha 1e-6 --threshold 1e-10 (also pinned on the CPU in test_ks2d_e2e)
WEAKFORM_GOLDEN = {"lap": -1.078219, "bih": -2.242636, "gradsq": -0.152420}

# Full-field statistics are float32 sums over 2e7 samples, taken in XLA's
# order, of term fields whose stencils round in float32; the host computes
# the same sums in float64 from the same float32 frames. Each statistic's
# error is measured against the sum of the magnitudes of its summands (the
# scale that bounds any summation order's rounding), and must stay under:
FULLFIELD_RTOL = 1e-4

# KS-2D float32 fits recover the truth only to the rounding of their Gram
# statistics: X^T X over 35,000 rows, summed in one GEMM, is off by ~1e-6 in
# correlation units, and the standardized Gram's condition number carries
# that into the coefficients. The grid-selected reference fit reads 0.01055%
# on the H100; summing the Gram in 256-row blocks would bring it to 0.0035%,
# a change of the CPU's coefficients too, left to its own change. The bound
# keeps ~2x headroom over the H100's reading.
KS2D_MAX_ERR_PCT = 0.02

# The mesh phase's KS-2D run is one float32 fit at the default (alpha,
# threshold), with no grid selection. The psum path sums four per-device
# Grams, one device sums one: each recovers the truth only to its own
# rounding, on top of a 0.0036% floor that exact float64 sums of the same
# float32 rows leave. On H100s, tools/ks_gram_error.py read 0.0125-0.0153%
# for one GEMM and 0.0174-0.0178% for four shards (psum, or summed in order
# on one card), though the four-shard Gram is the more accurate of the two:
# the truth error does not rank the psum. The on/off agreement (1e-4, read
# 2.4e-5) tests the psum; the truth bound keeps ~1.7x headroom.
SINGLE_FIT_MAX_ERR_PCT = 0.03

# Registration: the registration phase jitters the half-resolution stack by
# known whole-pixel shifts of up to JITTER_PX per frame (camera jitter, the
# motion the pipelines' registration exists to remove). After registration,
# the mean residual flow between consecutive frames must be under this
# fraction of the jittered stack's: at least the 18.5% improvement the
# reference's own OpenCV registration reports (BASELINE.md).
JITTER_PX = 3
REGISTRATION_MAX_RESIDUAL_FRACTION = 0.815


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def fmt(values: dict) -> str:
    return "  ".join(f"{k}={v}" for k, v in values.items())


# ---------------------------------------------------------------------------
# device


def device_info() -> dict:
    """Platform, kind and count of JAX's devices. Raises PhaseFailed unless
    JAX runs on a GPU."""
    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX found no GPU (platform={dev.platform!r})")
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def phase_device() -> dict:
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.normal(size=(512, 512)).astype(np.float32)
    b = rng.normal(size=(512, 512)).astype(np.float32)
    got = np.asarray(jnp.asarray(a) @ jnp.asarray(b), np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(rel <= 1e-5, f"f32 matmul rel err {rel:.3e} > 1e-5: TF32 or lower precision")
    return {
        "jax": jax.__version__,
        "matmul_precision": jax.config.jax_default_matmul_precision,
        "f32_matmul_rel_err": f"{rel:.3e}",
    }


# ---------------------------------------------------------------------------
# KS-2D


def worst_gt_err(res: dict) -> float:
    return max(v["rel_err_pct"] for v in res["gt_errors"].values())


def phase_ks2d(**size) -> dict:
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    res = run(Ks2dBenchConfig(grid_search=True, dtype="float32", **size))
    worst = worst_gt_err(res)
    check(worst < KS2D_MAX_ERR_PCT,
          f"worst ground-truth error {worst:.5f}% >= {KS2D_MAX_ERR_PCT}%")
    return {"worst_gt_err_pct": f"{worst:.6f}", "coeffs": [round(c, 6) for c in res["coeffs"]]}


def phase_ks2d_f64() -> dict:
    import jax

    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    cfg = Ks2dBenchConfig(
        Nx=48, Ny=48, n_seconds=0.4, method="weakform", weak_basis="gaussian",
        alpha=1e-6, threshold=1e-10, dtype="float64",
    )
    x64 = jax.config.jax_enable_x64
    try:
        res = run(cfg)  # turns on x64 for its float64 config
    finally:
        jax.config.update("jax_enable_x64", x64)
    est = {k: res["gt_errors"][k]["est"] for k in WEAKFORM_GOLDEN}
    for k, g in WEAKFORM_GOLDEN.items():
        check(round(est[k], 6) == g, f"{k}: {est[k]:.7f} != golden {g}")
    return {k: f"{v:.7f}" for k, v in est.items()}


def _np_term_fields(u: np.ndarray, dx: float, dy: float, names) -> list[np.ndarray]:
    def lap_of(f):
        return (
            (np.roll(f, -1, -2) - 2 * f + np.roll(f, 1, -2)) / dx**2
            + (np.roll(f, -1, -1) - 2 * f + np.roll(f, 1, -1)) / dy**2
        )

    ux = (np.roll(u, -1, -2) - np.roll(u, 1, -2)) / (2 * dx)
    uy = (np.roll(u, -1, -1) - np.roll(u, 1, -1)) / (2 * dy)
    lap = lap_of(u)
    table = {
        "one": lambda: np.ones_like(u), "u": lambda: u, "u2": lambda: u * u,
        "ux": lambda: ux, "uy": lambda: uy, "lap": lambda: lap,
        "bih": lambda: lap_of(lap), "gradsq": lambda: ux * ux + uy * uy,
        "u_lap": lambda: u * lap,
    }
    return [table[n]() for n in names]


def _np_block_means(f: np.ndarray, bt: int, bx: int, by: int) -> np.ndarray:
    """Block means over (bt, bx, by) blocks, short tail blocks averaged over
    their own cells (np.add.reduceat handles ragged tails directly)."""
    T, H, W = f.shape
    s = np.add.reduceat(f, np.arange(0, T, bt), axis=0)
    s = np.add.reduceat(s, np.arange(0, H, bx), axis=1)
    s = np.add.reduceat(s, np.arange(0, W, by), axis=2)

    def cnt(n, b):
        return np.minimum(b, n - np.arange(0, n, b))

    return s / np.einsum("t,x,y->txy", cnt(T, bt), cnt(H, bx), cnt(W, by))


def _np_stats(X: np.ndarray, y: np.ndarray) -> tuple[dict, dict]:
    """float64 Gram statistics and the magnitude each one's error is
    measured against (the same sums over absolute values)."""
    aX, ay = np.abs(X), np.abs(y)
    stats = {"G": X.T @ X, "b": X.T @ y, "sx": X.sum(0), "syy": y @ y, "sy": y.sum()}
    mags = {"G": aX.T @ aX, "b": aX.T @ ay, "sx": aX.sum(0), "syy": ay @ ay, "sy": ay.sum()}
    return stats, mags


def fullfield_errors(U, Ut, dx, dy, names, blocks=None) -> float:
    """Worst magnitude-relative error of the device statistics against the
    host float64 ones; also checks the sample count exactly."""
    import jax

    from pdx.library.fullfield import blockwise_gram, fullfield_gram

    if blocks is None:
        got = jax.jit(fullfield_gram, static_argnums=(2, 3, 4))(U, Ut, dx, dy, names)
    else:
        bt, bx, by = blocks
        fn = jax.jit(
            lambda U, Ut: blockwise_gram(U, Ut, dx, dy, names, block_t=bt, block_x=bx, block_y=by)
        )
        got = fn(U, Ut)
    got = jax.device_get(got)
    u = np.asarray(U, np.float64)
    y = np.asarray(Ut, np.float64)
    fields = _np_term_fields(u, dx, dy, names)
    if blocks is not None:
        fields = [_np_block_means(f, *blocks) for f in fields]
        y = _np_block_means(y, *blocks)
    X = np.stack([f.reshape(-1) for f in fields], axis=-1)
    y = y.reshape(-1)
    del fields
    ref, mags = _np_stats(X, y)
    check(float(got["n"]) == X.shape[0], f"n={float(got['n'])} != {X.shape[0]}")
    worst = 0.0
    for k in ref:
        err = np.abs(np.asarray(got[k], np.float64) - ref[k]) / np.maximum(mags[k], 1e-300)
        worst = max(worst, float(err.max()))
    return worst


def phase_fullfield(**size) -> dict:
    import jax.numpy as jnp

    from pdx.library.fullfield import RICH_TERM_NAMES, TRUE_TERM_NAMES
    from pdx.library.pointwise import forward_difference_ut
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, prepare_frames, run

    cfg = Ks2dBenchConfig(grid_search=True, dtype="float32", solver="fullfield", **size)
    fr = prepare_frames(cfg)
    U = fr["U_for_features"][:-1]
    Ut = forward_difference_ut(fr["U_for_ut"], fr["DT"])
    dx, dy = float(fr["dx"]), float(fr["dy"])
    out = {"T,H,W": "x".join(str(s) for s in U.shape)}
    for label, names, blocks in (
        ("true3", TRUE_TERM_NAMES, None),
        ("rich9", RICH_TERM_NAMES, None),
        ("blockwise3x8x8", TRUE_TERM_NAMES, (3, 8, 8)),
    ):
        err = fullfield_errors(U, Ut, dx, dy, names, blocks)
        check(err <= FULLFIELD_RTOL, f"{label}: error {err:.3e} > {FULLFIELD_RTOL}")
        out[f"{label}_err"] = f"{err:.3e}"
    del U, Ut, fr
    res = run(cfg)
    worst = worst_gt_err(res)
    check(worst < 1.0, f"--solver fullfield worst ground-truth error {worst:.4f}% >= 1%")
    out["fullfield_worst_gt_err_pct"] = f"{worst:.5f}"
    out["dtype"] = str(jnp.dtype(cfg.dtype))
    return out


# ---------------------------------------------------------------------------
# real-image pipelines


def synthetic_stack(T: int = 51, H: int = 1024, W: int = 1280) -> np.ndarray:
    """The reference dataset's shape (51 x 1024 x 1280 u16), made in memory."""
    sys.path.insert(0, str(REPO))
    from tools.make_synth_stack import make_stack

    return make_stack(T=T, H=H, W=W)


def _finite(name: str, coeffs) -> None:
    c = np.asarray(coeffs, np.float64)
    check(c.size > 0 and bool(np.all(np.isfinite(c))), f"{name}: non-finite coefficients {c}")


def _artifacts(out_dir: Path, names: tuple[str, ...]) -> None:
    for n in names:
        check((out_dir / n).is_file(), f"missing artifact {out_dir / n}")


def phase_registration(stack: np.ndarray) -> dict:
    """Mean residual flow between consecutive frames of a jittered stack,
    before and after the pipelines' registration (patch-discover's and
    analyze's preprocessing, at their half resolution)."""
    import jax.numpy as jnp

    from pdx.io_host.images import device_stack
    from pdx.preprocess import resize_denoise_normalize
    from pdx.register.farneback import register_sequence_dispatch
    from pdx.register.quality import registration_improvement

    T, H, W = stack.shape
    U = np.asarray(resize_denoise_normalize(
        device_stack(stack), out_h=H // 2, out_w=W // 2, sigma=1.0, eps=1e-12,
        dtype_name="float32",
    ))
    shifts = np.random.default_rng(0).integers(-JITTER_PX, JITTER_PX + 1, size=(T, 2))
    U = jnp.asarray(np.stack([np.roll(f, tuple(s), axis=(0, 1)) for f, s in zip(U, shifts)]))
    U_reg = register_sequence_dispatch(U, mode="auto", refine=1)
    m = {k: float(v) for k, v in registration_improvement(U, U_reg).items()}
    frac = m["avg_flow_after"] / m["avg_flow_before"]
    check(
        np.isfinite(frac) and frac < REGISTRATION_MAX_RESIDUAL_FRACTION,
        f"registration residual {m['avg_flow_after']:.4f} px is {frac:.3f} of the "
        f"jittered {m['avg_flow_before']:.4f} px",
    )
    return {
        "flow_jittered_px": f"{m['avg_flow_before']:.4f}",
        "flow_registered_px": f"{m['avg_flow_after']:.4f}",
        "residual_fraction": f"{frac:.4f}",
    }


def phase_patch_discover(stack: np.ndarray, out_root: Path, **kw) -> dict:
    from pdx.pipelines.patch_discovery import PatchDiscoveryConfig, run

    out_dir = out_root / "patch_pde"
    res = run(PatchDiscoveryConfig(data_dir="unused", output_dir=str(out_dir), **kw), U_raw=stack)
    _finite("patch-discover patch_coeffs", res["patch_coeffs"])
    _finite("patch-discover aggregate", res["stats"]["coeffs"])
    _artifacts(out_dir, ("PATCH_PDE_COEFFS.csv", "PATCH_PDE_REPORT.txt", "patch_pde_summary.json"))
    return {"n_patches": res["n_patches"], "equation": res["equation"]}


def phase_analyze(stack: np.ndarray, out_root: Path, **kw) -> dict:
    from pdx.pipelines.analyze import AnalyzeConfig, run

    out_dir = out_root / "analyze"
    res = run(AnalyzeConfig(data_dir="unused", output_dir=str(out_dir), **kw), U_raw=stack)
    for r in res["results"]:
        _finite(f"analyze {r['name']}", r["coeffs"])
    _artifacts(out_dir, ("best_model.json", "models_comparison.json", "best_model_baseline.json"))
    best = res["best_overall"]
    return {"best": best["name"], "r2": f"{best['r2']:.5f}", "equation": best["equation"]}


def phase_patch_sindy(stack: np.ndarray, out_root: Path, **kw) -> dict:
    from pdx.pipelines.patch_sindy import PatchSindyConfig, run

    out_dir = out_root / "patch_sindy"
    res = run(PatchSindyConfig(data_dir="unused", output_dir=str(out_dir), **kw), U_raw=stack)
    _finite("patch-sindy ensemble", res["coeffs"])
    _finite("patch-sindy patches", res["patch_coeffs"])
    _artifacts(out_dir, ("patch_sindy_results.json",))
    return {"n_patches": res["n_patches"], "avg_quality": f"{res['avg_quality']:.4f}"}


def phase_transport(stack: np.ndarray, out_root: Path, **kw) -> dict:
    from pdx.pipelines.transport import TransportConfig, run

    out_dir = out_root / "transport"
    res = run(TransportConfig(data_dir="unused", output_dir=str(out_dir), **kw), U_raw=stack)
    for alpha, r in res["results"].items():
        _finite(f"transport alpha={alpha}", r["coefficients"])
    _artifacts(out_dir, ("transport_results.json",))
    best = max(res["results"].items(), key=lambda kv: kv[1]["r2"])
    return {"best_alpha": best[0], "r2": f"{best[1]['r2']:.5f}",
            "mean_flow_px": f"{res['mean_flow_speed']:.4f}"}


def phase_comprehensive(out_root: Path, **kw) -> dict:
    from pdx.pipelines.comprehensive import ComprehensiveConfig, run

    out_dir = out_root / "comprehensive"
    res = run(ComprehensiveConfig(output_dir=str(out_dir), **kw))
    failed = [
        f"{regime}/{method}: {r['error_msg']}"
        for regime, per in res["results"].items()
        for method, r in per.items()
        if "error_msg" in r
    ]
    check(not failed, "methods failed: " + "; ".join(failed[:5]))
    n = sum(len(per) for per in res["results"].values())
    _artifacts(out_dir, ("benchmark_results.json",))
    return {"regimes": len(res["results"]), "methods": len(res["methods"]),
            "cells": n, "best": res["best_overall"]}


# ---------------------------------------------------------------------------
# four GPUs


def phase_mesh(n: int, stack: np.ndarray) -> dict:
    """The paths that exist only across devices, each against one device."""
    import jax

    sys.path.insert(0, str(REPO))
    import __graft_entry__
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run as ks_run
    from pdx.pipelines.patch_discovery import PatchDiscoveryConfig, run as pd_run

    check(len(jax.devices()) >= n, f"need {n} GPUs, JAX sees {len(jax.devices())}")
    __graft_entry__.dryrun_multichip(n)

    # the one-GPU phase's run: default config, the reference dataset's shape
    on = pd_run(PatchDiscoveryConfig(data_dir="unused", write_artifacts=False, mesh="on"),
                U_raw=stack)
    off = pd_run(PatchDiscoveryConfig(data_dir="unused", write_artifacts=False, mesh="off"),
                 U_raw=stack)
    check(on["n_shard_devices"] == n, f"patch fits ran on {on['n_shard_devices']} of {n} devices")
    # the same vmapped per-patch solves, partitioned: identical up to
    # float32 reassociation inside XLA's per-device programs
    pd_err = float(np.abs(on["patch_coeffs"] - off["patch_coeffs"]).max()
                   / max(np.abs(off["patch_coeffs"]).max(), 1e-30))
    check(pd_err <= 1e-4, f"patch-discover mesh on/off differ by {pd_err:.3e}")

    ks = dict(dtype="float32", solver="gram", grid_search=False)
    ks_on = ks_run(Ks2dBenchConfig(mesh="on", **ks))
    ks_off = ks_run(Ks2dBenchConfig(mesh="off", **ks))
    c_on, c_off = np.asarray(ks_on["coeffs"]), np.asarray(ks_off["coeffs"])
    # psum of per-device partial Grams vs one Gram: float32 reassociation
    ks_err = float(np.abs(c_on - c_off).max() / np.abs(c_off).max())
    out = {
        "dryrun_multichip": "ok",
        "patch_discover_devices": on["n_shard_devices"],
        "patch_discover_rel_diff": f"{pd_err:.3e}",
        "ks2d_psum_rel_diff": f"{ks_err:.3e}",
        "ks2d_mesh_on_worst_gt_err_pct": f"{worst_gt_err(ks_on):.6f}",
        "ks2d_mesh_off_worst_gt_err_pct": f"{worst_gt_err(ks_off):.6f}",
    }
    check(ks_err <= 1e-4, f"ks2d psum Gram coefficients differ by {ks_err:.3e}: {out}")
    for label, res in (("on", ks_on), ("off", ks_off)):
        err = worst_gt_err(res)
        check(err < SINGLE_FIT_MAX_ERR_PCT, f"ks2d mesh={label} ground truth {err:.5f}%: {out}")
    return out


# ---------------------------------------------------------------------------


def block_optional_host_libraries() -> None:
    """The main path needs none of cv2, PIL or matplotlib, which the card's
    machine need not have. Blocking them makes that so here: image decoding
    is not used (stacks are passed in memory), and the pipelines' figure
    stages see matplotlib as missing and are skipped."""
    for mod in ("cv2", "PIL", "matplotlib"):
        sys.modules[mod] = None  # type: ignore[assignment]


def run_phase(name: str, fn, failures: list[str]):
    t0 = time.perf_counter()
    try:
        vals = fn()
    except Exception as e:  # report every phase, then fail the run
        dt = time.perf_counter() - t0
        print(f"[{name}] FAILED after {dt:.1f} s: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
        failures.append(name)
        return None
    dt = time.perf_counter() - t0
    print(f"[{name}] ok {dt:.1f} s  {fmt(vals)}", flush=True)
    return vals


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device phase, on four GPUs")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    try:
        info = device_info()
    except PhaseFailed as e:
        print(f"[device] FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    import pdx
    from pdx.utils.profiling import gpu_cards

    try:
        smi = gpu_cards()
    except RuntimeError as e:
        print(f"[device] FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    pdx.enable_compilation_cache()
    block_optional_host_libraries()
    for line in smi:  # name, power limit: exactly as nvidia-smi prints them
        print(line, flush=True)
    print(f"devices: {info['count']} x {info['kind']}", flush=True)

    failures: list[str] = []
    run_phase("device", phase_device, failures)
    if args.gpus > 1:
        if info["count"] < args.gpus:
            print(f"[mesh] FAILED: {info['count']} GPU(s) visible, {args.gpus} asked",
                  flush=True)
            return 1
        stack = synthetic_stack()
        run_phase("mesh", lambda: phase_mesh(args.gpus, stack), failures)
    else:
        run_phase("ks2d", phase_ks2d, failures)
        run_phase("ks2d-f64", phase_ks2d_f64, failures)
        run_phase("fullfield", phase_fullfield, failures)
        t0 = time.perf_counter()
        stack = synthetic_stack()
        print(f"[stack] {stack.shape} {stack.dtype} made in {time.perf_counter() - t0:.1f} s",
              flush=True)
        print("[figures] skipped: matplotlib is blocked, figure stages are host rendering",
              flush=True)
        shutil.rmtree(OUT, ignore_errors=True)  # artifacts must come from this run
        run_phase("registration", lambda: phase_registration(stack), failures)
        run_phase("patch-discover", lambda: phase_patch_discover(stack, OUT), failures)
        run_phase("analyze", lambda: phase_analyze(stack, OUT), failures)
        run_phase("patch-sindy", lambda: phase_patch_sindy(stack, OUT), failures)
        run_phase("transport", lambda: phase_transport(stack, OUT), failures)
        run_phase("comprehensive", lambda: phase_comprehensive(OUT), failures)

    print(f"total {time.perf_counter() - t_start:.1f} s (compilation included)", flush=True)
    if failures:
        print(f"FAILED phases: {', '.join(failures)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
