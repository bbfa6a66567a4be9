"""Fresh-process cold runs with a populated persistent compile cache.

Answers one question: does the persistent compilation cache (`pdx.enable_compilation_cache()`) actually amortize first-run
compile cost ACROSS PROCESSES — i.e. what does the *second first-time
user* on a machine pay? Every pipeline below runs in its own fresh Python
interpreter (nothing shared with this parent but the on-disk caches),
twice: run A populates/refreshes the cache at the current code state, run
B is the number that matters — "cold (cache-hot process)".

In-process warm numbers (tools/real_bench.py) measure steady-state; a
first run ever at a given code revision measures compilation. This records
the third regime, which is what any CLI user
pays from their second invocation on.

Usage:
    python tools/cold_bench.py [STACK_DIR] [--out OUT.json] [--pipelines a,b]

STACK_DIR defaults to outputs/synth51; run outputs go under outputs/cold_bench.
The children run one after another, so one GPU serves them all.

The TIFF-decode stack cache is left warm on purpose: it isolates the
compile-cache question (decode cost is measured separately by real_bench's
fresh-cache-dir cold passes).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT_ROOT = REPO / "outputs" / "cold_bench"

CHILD = r"""
import sys, time
sys.path.insert(0, {repo!r})
t_start = time.time()
import pdx
pdx.enable_compilation_cache()
import jax
t_import = time.time()
name = {name!r}
stack = {stack!r}
if name == "analyze":
    from pdx.pipelines.analyze import AnalyzeConfig, run
    run(AnalyzeConfig(data_dir=stack, output_dir={out!r} + "/analyze"))
elif name == "patch_discover":
    from pdx.pipelines.patch_discovery import PatchDiscoveryConfig, run
    run(PatchDiscoveryConfig(data_dir=stack, output_dir={out!r} + "/pd"))
elif name == "patch_sindy":
    from pdx.pipelines.patch_sindy import PatchSindyConfig, run
    run(PatchSindyConfig(data_dir=stack, output_dir={out!r} + "/ps",
                         registration_method="optical_flow"))
elif name == "transport":
    from pdx.pipelines.transport import TransportConfig, run
    run(TransportConfig(data_dir=stack, output_dir={out!r} + "/tr"))
elif name == "comprehensive":
    from pdx.pipelines.comprehensive import ComprehensiveConfig, run
    run(ComprehensiveConfig(write_artifacts=False))
else:
    raise SystemExit(f"unknown pipeline {{name}}")
t_end = time.time()
print(f"COLD_BENCH {{name}} backend={{jax.default_backend()}} "
      f"import_s={{t_import-t_start:.1f}} "
      f"run_s={{t_end-t_import:.1f}} total_s={{t_end-t_start:.1f}}")
"""

DEFAULT_PIPELINES = ("transport", "analyze", "patch_discover", "patch_sindy", "comprehensive")

# per-pipeline subprocess timeout: generous enough for one full first-ever
# compile
TIMEOUT_S = {"comprehensive": 1500}
DEFAULT_TIMEOUT_S = 900


def run_child(name: str, stack: str) -> dict:
    code = CHILD.format(repo=str(REPO), name=name, stack=stack, out=str(OUT_ROOT))
    tmo = TIMEOUT_S.get(name, DEFAULT_TIMEOUT_S)
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=tmo,
        )
    except subprocess.TimeoutExpired:
        return {"error": f"timeout>{tmo}s"}
    wall = time.time() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("COLD_BENCH"):
            parts = dict(p.split("=") for p in line.split()[2:])
            backend = parts.pop("backend", "?")
            rec: dict = {k.removesuffix("_s"): float(v) for k, v in parts.items()}
            rec["backend"] = backend
            return rec
    tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
    return {"error": f"rc={proc.returncode} wall={wall:.1f}s: " + " | ".join(tail)}


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    stack = args[0] if args else str(REPO / "outputs" / "synth51")
    out_path = None
    pipelines = DEFAULT_PIPELINES
    argv = sys.argv[1:]
    for i, a in enumerate(argv):
        if a == "--out":
            out_path = Path(argv[i + 1])
        if a == "--pipelines":
            pipelines = tuple(argv[i + 1].split(","))

    results: dict[str, dict] = {
        "note": (
            "each cell is a FRESH python process; pass A refreshes the "
            "persistent compile cache at this code revision, pass B "
            "(cold_cachehot) is what a second first-time user pays"
        ),
    }

    def flush() -> None:
        if out_path:
            out_path.write_text(json.dumps(results, indent=2))

    # deliberately NO jax import here: a parent holding the GPU would leave
    # the children too little device memory
    for name in pipelines:
        rec: dict = {}
        a = run_child(name, stack)
        rec["pass_a"] = a
        if "error" not in a:
            b = run_child(name, stack)
            rec["pass_b_cold_cachehot"] = b
        results[name] = rec
        print(f"{name}: {rec}", flush=True)
        flush()
    flush()


if __name__ == "__main__":
    main()
