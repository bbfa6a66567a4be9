"""Where the float32 error of the KS-2D single default fit comes from.

Rebuilds the regression inputs of ``ks2d-bench`` (pointwise, true
dictionary, the default alpha and threshold, no grid search, the Gram
solver) and fits the same float32 rows from Gram statistics summed in
different orders:

  one-gemm     ``gram_stats``: one X^T X over every row (``mesh="off"``)
  4-shards     four contiguous row shards' Grams, added in order: the
               arithmetic of the psum path (``mesh="on"``) on one device
  blocked-256  the sum of 256-row partial Grams
  psum         the sharded path itself over every visible device
               (only with two or more devices)
  host-f64     numpy float64 sums of the same float32 rows, rounded to float32

For each it prints the statistics' error against the float64 sums, in
correlation units (|dG_ij| / sqrt(G_ii G_jj), |db_i| / sqrt(G_ii syy)), and
the fit's worst ground-truth error in percent, beside the condition number
of the standardized Gram that carries the one into the other.

Usage:
    python tools/ks_gram_error.py            # reference size (100x100, 2000 steps)
    python tools/ks_gram_error.py --small    # 32x32, 0.2 s: a quick CPU check
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _row_blocks(a, n_blocks: int):
    import jax.numpy as jnp

    rows = -(-a.shape[0] // n_blocks) * n_blocks
    a = jnp.pad(a, [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
    return a.reshape((n_blocks, rows // n_blocks) + a.shape[1:])


def _summed(X, y, n_blocks: int) -> dict:
    """Gram statistics as a left-to-right sum of per-block products."""
    import jax.numpy as jnp

    from pdx.ops.linalg import gram_stats

    Xb, yb = _row_blocks(X, n_blocks), _row_blocks(y, n_blocks)
    parts = [gram_stats(Xb[i], yb[i]) for i in range(n_blocks)]
    out = dict(parts[0])
    for p in parts[1:]:
        out = {k: out[k] + p[k] for k in out}
    out["n"] = jnp.asarray(X.shape[0], X.dtype)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="32x32 grid, 0.2 s: a quick check")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import pdx
    from pdx.ops.linalg import gram_stats, standardized_stats
    from pdx.pipelines.ks2d_bench import (
        KS_GT, Ks2dBenchConfig, _maybe_sharded_gram, _rms_scale, build_dataset, prepare_frames,
    )
    from pdx.solve.stridge import stridge_from_stats

    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True
                             ).stdout.strip(), flush=True)
    if jax.default_backend() == "gpu":
        pdx.enable_compilation_cache()
    size = dict(Nx=32, Ny=32, n_seconds=0.2) if args.small else {}
    cfg = Ks2dBenchConfig(dtype="float32", solver="gram", grid_search=False, mesh="on", **size)

    # the regression inputs exactly as ks2d_bench.run builds them
    fr = prepare_frames(cfg)
    rng = np.random.default_rng(0)
    names, X_all, y_all = build_dataset(cfg, fr, rng)
    perm = rng.permutation(int(X_all.shape[0]))
    split = int(0.7 * len(perm))
    tr = jnp.asarray(perm[:split])
    X_tr, y_tr = X_all[tr], y_all[tr]
    scale = _rms_scale(X_tr, names)
    X = X_tr / scale

    Xh, yh = np.asarray(X, np.float64), np.asarray(y_tr, np.float64)
    ref = {"G": Xh.T @ Xh, "b": Xh.T @ yh, "sx": Xh.sum(0), "n": float(len(yh)),
           "syy": float(yh @ yh), "sy": float(yh.sum())}
    d = np.sqrt(np.diag(ref["G"]))
    variants = {
        "one-gemm": gram_stats(X, y_tr),
        "4-shards": _summed(X, y_tr, 4),
        "blocked-256": _summed(X, y_tr, -(-X.shape[0] // 256)),
        "host-f64": {k: jnp.asarray(v, X.dtype) for k, v in ref.items()},
    }
    if jax.device_count() >= 2:
        variants["psum"] = _maybe_sharded_gram(cfg, X, y_tr)

    Gs, _, _, _ = standardized_stats(variants["host-f64"])
    out = {"rows": int(X.shape[0]), "names": names, "devices": jax.device_count(),
           "cond_standardized_gram": float(jnp.linalg.cond(Gs))}
    print(json.dumps(out), flush=True)
    for label, stats in variants.items():
        s = jax.device_get(stats)
        c = np.asarray(
            stridge_from_stats(stats, alpha=cfg.alpha, threshold=cfg.threshold, max_iter=25).coeffs
            / scale, np.float64)
        errs = {k: abs(c[names.index(k)] - v) / abs(v) * 100 for k, v in KS_GT.items()}
        row = {
            "variant": label,
            "G_err": float((np.abs(np.asarray(s["G"], np.float64) - ref["G"]) / np.outer(d, d)).max()),
            "b_err": float((np.abs(np.asarray(s["b"], np.float64) - ref["b"])
                            / (d * np.sqrt(ref["syy"]))).max()),
            "worst_gt_err_pct": max(errs.values()),
            "gt_err_pct": errs,
        }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
