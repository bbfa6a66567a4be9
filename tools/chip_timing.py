"""Device timings behind the full-field statistics decision, in one process.

Prints one JSON line per measurement:
  * the full-field Gram statistics at T=2000, 100x100 f32 (true 3-term, rich
    9-term, blockwise 3x8x8): the plain XLA version (pdx.library.fullfield)
    and the materialise-plus-GEMM reference, with XLA's bytes accessed and
    the share of the HBM bound (reading U and Ut once at 3.35 TB/s);
  * a 1 GiB read+write pass, for the bandwidth the card reaches;
  * the banded separable Gaussian at HIGH and HIGHEST precision against
    scipy's float64 filter (error and time);
  * ``ks2d-bench`` end to end and its stages, timed in the same iterations:
    the frames (simulation + perturbation + denoising), the fused subsampled
    grid or the full-field grid, and the whole run (the rest is the host
    selection and the rollout).

Usage:
    python tools/chip_timing.py            # reference sizes, on the GPU
    python tools/chip_timing.py --small    # tiny shapes: a quick CPU check
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak


def _timeit(fn, *args, iters: int):
    """(median of blocked calls, mean of back-to-back calls), seconds."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return float(np.median(ts)), (time.perf_counter() - t0) / iters


def _emit(name: str, row: dict) -> None:
    print(json.dumps({"name": name, **row}), flush=True)


def gram_statistics(small: bool) -> None:
    import jax
    import jax.numpy as jnp

    from pdx.library.fullfield import (
        RICH_TERM_NAMES, TRUE_TERM_NAMES, blockwise_gram, blockwise_gram_reference,
        fullfield_gram, fullfield_gram_reference,
    )

    T, H, W = (50, 32, 32) if small else (2000, 100, 100)
    rng = np.random.default_rng(0)
    U = jnp.asarray(rng.normal(size=(T, H, W)).astype(np.float32))
    Ut = jnp.asarray(rng.normal(size=(T, H, W)).astype(np.float32))
    dx = dy = 0.5
    min_bytes = 2 * U.size * 4
    blk = dict(block_t=3, block_x=8, block_y=8)
    variants = {
        "true3_plain": lambda U, Ut: fullfield_gram(U, Ut, dx, dy, TRUE_TERM_NAMES),
        "true3_ref": lambda U, Ut: fullfield_gram_reference(U, Ut, dx, dy, TRUE_TERM_NAMES),
        "rich9_plain": lambda U, Ut: fullfield_gram(U, Ut, dx, dy, RICH_TERM_NAMES),
        "rich9_ref": lambda U, Ut: fullfield_gram_reference(U, Ut, dx, dy, RICH_TERM_NAMES),
        "block3x8x8_plain": lambda U, Ut: blockwise_gram(U, Ut, dx, dy, TRUE_TERM_NAMES, **blk),
        "block3x8x8_ref": lambda U, Ut: blockwise_gram_reference(
            U, Ut, dx, dy, TRUE_TERM_NAMES, **blk),
    }
    for name, f in variants.items():
        jf = jax.jit(f)
        ca = jf.lower(U, Ut).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        med, b2b = _timeit(jf, U, Ut, iters=50)
        _emit(name, {"back_to_back_us": b2b * 1e6, "median_blocked_us": med * 1e6,
                     "xla_bytes_accessed_MB": float(ca.get("bytes accessed", np.nan)) / 1e6,
                     "hbm_bound_share": (min_bytes / HBM_BYTES_PER_S) / b2b})

    X = jnp.ones((4, 64, 64) if small else (256, 1024, 1024), jnp.float32)
    _, b2b = _timeit(jax.jit(lambda x: x * 1.0001), X, iters=20)
    _emit("copy_1GiB", {"back_to_back_us": b2b * 1e6, "GBps": 2 * X.size * 4 / b2b / 1e9})


def separable_precision(small: bool) -> None:
    import jax
    import jax.numpy as jnp
    from scipy.ndimage import gaussian_filter

    from pdx.ops.filters import _gaussian_kernel1d
    from pdx.ops.interp import band_matrix

    rng = np.random.default_rng(0)
    img = rng.random((3, 64, 80) if small else (51, 512, 640)).astype(np.float32)
    Ij = jnp.asarray(img)
    for sigma in (1.0, 1.5):
        ref = np.stack([gaussian_filter(f.astype(np.float64), sigma) for f in img])
        kt = tuple(_gaussian_kernel1d(sigma, int(4.0 * sigma + 0.5)))
        Mh = jnp.asarray(band_matrix(kt, img.shape[1]), jnp.float32)
        Mw = jnp.asarray(band_matrix(kt, img.shape[2]), jnp.float32)
        for prec in ("HIGH", "HIGHEST"):
            p = getattr(jax.lax.Precision, prec)
            fn = jax.jit(lambda f, p=p: jnp.einsum(
                "wv,...hv->...hw", Mw, jnp.einsum("hp,...pw->...hw", Mh, f, precision=p),
                precision=p))
            err = float(np.abs(np.asarray(fn(Ij), np.float64) - ref).max() / np.abs(ref).max())
            _, b2b = _timeit(fn, Ij, iters=20)
            _emit(f"gauss_sigma{sigma}_{prec}", {"max_rel_err": err, "back_to_back_us": b2b * 1e6})


def ks2d_breakdown(small: bool, reps: int) -> None:
    import jax
    import jax.numpy as jnp

    from pdx.pipelines.ks2d_bench import (
        GRID_ALPHAS, GRID_THRESHOLDS, Ks2dBenchConfig, _fullfield_grid, prepare_frames, run,
    )

    size = dict(Nx=32, Ny=32, n_seconds=0.2) if small else {}
    for label, kw in (("default", {}), ("fullfield", dict(solver="fullfield")),
                      ("fullfield_rich", dict(solver="fullfield", dictionary="rich")),
                      ("fullfield_blockwise", dict(solver="fullfield", method="blockwise"))):
        cfg = Ks2dBenchConfig(grid_search=True, dtype="float32", **size, **kw)
        names = ("lap", "bih", "gradsq") if cfg.dictionary == "true" else (
            "one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap")
        blocks = (cfg.block_t, cfg.block_x, cfg.block_y) if cfg.method == "blockwise" else None
        res = run(cfg)
        fr = prepare_frames(cfg)
        jax.block_until_ready(fr)
        t = {"frames": [], "whole_run": []}
        if cfg.solver == "fullfield":
            t["fullfield_grid"] = []
            grid_args = (fr["U_for_ut"], fr["U_for_features"], float(fr["DT"]),
                         float(fr["dx"]), float(fr["dy"]),
                         jnp.asarray(GRID_ALPHAS, jnp.float32),
                         jnp.asarray(GRID_THRESHOLDS, jnp.float32), names, blocks)
            jax.block_until_ready(_fullfield_grid(*grid_args))
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(prepare_frames(cfg))
            t["frames"].append(time.perf_counter() - t0)
            if cfg.solver == "fullfield":
                t0 = time.perf_counter()
                jax.block_until_ready(_fullfield_grid(*grid_args))
                t["fullfield_grid"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            res = run(cfg)
            t["whole_run"].append(time.perf_counter() - t0)
        worst = max(v["rel_err_pct"] for v in res["gt_errors"].values())
        _emit(f"ks2d_{label}", {
            "median_ms": {k: float(np.median(v)) * 1e3 for k, v in t.items()},
            "min_ms": {k: float(np.min(v)) * 1e3 for k, v in t.items()},
            "reps": reps, "worst_gt_err_pct": worst,
        })


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="tiny shapes: a quick check")
    ap.add_argument("--reps", type=int, default=15, help="timed ks2d-bench iterations")
    args = ap.parse_args(argv)

    import jax

    import pdx
    from pdx.utils.profiling import gpu_cards

    if shutil.which("nvidia-smi"):
        print("\n".join(gpu_cards()), flush=True)
        pdx.enable_compilation_cache()
    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "jax": jax.__version__}), flush=True)
    gram_statistics(args.small)
    separable_precision(args.small)
    ks2d_breakdown(args.small, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
