"""A/B of the banded separable-filter precision on the real-image path.

The Gaussian, resize and Farneback filters lower to banded matmuls on
accelerators, at the precision ``pdx.ops.interp._SEP_PREC``. This runs the
real-image phases of ``chip_smoke.py`` once per precision, in one process,
in the order HIGH, HIGHEST, on a synthetic stack of the reference dataset's
shape (51 x 1024 x 1280 u16), then once more in float64 (x64 on, the
pipelines' default dtype honoured) as the reference the two are measured
against. It prints for each: the registration residual and its warm
seconds, patch-discover's equation, analyze's best model and r2, and
analyze's warm seconds per stage (medians of three runs).

Usage:
    python tools/sep_prec_ab.py            # reference size, on the GPU
    PDX_SEP_IMPL=banded JAX_PLATFORMS=cpu python tools/sep_prec_ab.py --small
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="12 x 512 x 640 stack: a quick check")
    args = ap.parse_args(argv)

    import jax

    import chip_smoke
    import pdx
    import pdx.ops.interp as interp
    import pdx.register.farneback as farneback
    from pdx.pipelines.analyze import AnalyzeConfig, run as analyze_run
    from pdx.utils.profiling import StageTimer, gpu_cards

    if shutil.which("nvidia-smi"):
        print("\n".join(gpu_cards()), flush=True)
        pdx.enable_compilation_cache()
    chip_smoke.block_optional_host_libraries()
    shape = dict(T=12, H=512, W=640) if args.small else {}
    pd_kw = dict(subsample=4) if args.small else {}
    stack = chip_smoke.synthetic_stack(**shape)
    out_root = REPO / "outputs" / "sep_prec_ab"
    def warm(fn, reps: int = 3) -> float:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    try:
        for name in ("HIGH", "HIGHEST", "float64"):
            f64 = name == "float64"
            prec = jax.lax.Precision.HIGHEST if f64 else getattr(jax.lax.Precision, name)
            interp._SEP_PREC = prec
            farneback._SEP_PREC = prec
            jax.config.update("jax_enable_x64", f64)
            jax.clear_caches()
            out = out_root / name
            row: dict = {"variant": name}
            if not f64:  # the smoke test's registration check runs in float32
                row["registration"] = chip_smoke.phase_registration(stack)
                row["registration_warm_s"] = warm(lambda: chip_smoke.phase_registration(stack))
            row["patch_discover"] = chip_smoke.phase_patch_discover(stack, out, **pd_kw)
            row["analyze"] = chip_smoke.phase_analyze(stack, out)
            stages = []

            def analyze_warm():
                timer = StageTimer()
                analyze_run(AnalyzeConfig(data_dir="unused", output_dir=str(out / "warm")),
                            U_raw=stack, timer=timer)
                stages.append(timer.stages)

            row["analyze_warm_s"] = warm(analyze_warm)
            row["analyze_warm_stages_s"] = {
                k: round(float(np.median([st[k] for st in stages])), 4) for k in stages[0]}
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
