"""Device-utilization profiling for the headline workloads.

Answers the question every wall-clock record leaves open: what fraction of
a measured second is the device actually computing, vs host work and
dispatch latency? The reference has only coarse per-method
wall-clock (`/root/reference/scripts/comprehensive_benchmark.py:521-524`);
this supersedes it with real `jax.profiler` traces.

Per section, the workload runs once un-traced (warm — compiles land in the
persistent cache) and once under `jax.profiler.trace`; the xplane is then
parsed in-process with `jax.profiler.ProfileData`:

* ``wall_s``            — wall-clock of the traced pass
* ``device_busy_s/pct`` — union of event intervals on the device plane(s)
  (overlapping ops are not double-counted)
* ``device_events``     — dispatch count (events on the device planes)
* ``transfers``         — count / busy seconds / bytes of copy-like events
  (H2D, D2H, memcpy, infeed/outfeed) wherever they appear
* ``top_ops``           — top device ops by summed duration

Traces land under ``outputs/profile_<stamp>/<section>/``, with the parsed
summary beside them (and at ``--out``); raw xplanes are gzipped and kept
only when small. STACK_DIR defaults to outputs/synth51.

Usage:
    python tools/profile_trace.py [STACK_DIR] [--out OUT.json]
        [--sections ks_bench,patch_ensemble,analyze,transport]
"""

from __future__ import annotations

import gzip
import json
import re
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

_TRANSFER_RE = re.compile(
    r"copy|transfer|memcpy|h2d|d2h|infeed|outfeed", re.IGNORECASE
)


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Total covered time of possibly-overlapping (start, end) ns intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    total += cur_e - cur_s
    return total / 1e9


def parse_xspace(path: Path) -> dict:
    import jax

    pd = jax.profiler.ProfileData.from_file(str(path))
    out: dict = {"planes": {}, "transfers": {"count": 0, "busy_s": 0.0, "bytes": 0}}
    for plane in pd.planes:
        pname = plane.name
        intervals: list[tuple[float, float]] = []
        n_events = 0
        op_dur: dict[str, float] = {}
        line_names = []
        for line in plane.lines:
            line_names.append(line.name)
            for ev in line.events:
                n_events += 1
                s = float(ev.start_ns)
                d = float(ev.duration_ns)
                intervals.append((s, s + d))
                op_dur[ev.name] = op_dur.get(ev.name, 0.0) + d
                if _TRANSFER_RE.search(ev.name):
                    out["transfers"]["count"] += 1
                    out["transfers"]["busy_s"] += d / 1e9
                    try:
                        for k, v in dict(ev.stats).items():
                            if "byte" in str(k).lower():
                                out["transfers"]["bytes"] += int(v)
                    except Exception:
                        pass
        if not n_events:
            continue
        top = sorted(op_dur.items(), key=lambda kv: -kv[1])[:10]
        out["planes"][pname] = {
            "lines": line_names,
            "events": n_events,
            "busy_s": round(_union_seconds(intervals), 4),
            "top_ops": [(n, round(d / 1e9, 4)) for n, d in top],
        }
    out["transfers"]["busy_s"] = round(out["transfers"]["busy_s"], 4)
    return out


def _device_summary(parsed: dict, wall_s: float) -> dict:
    """Collapse parsed planes into the headline numbers."""
    dev_busy = 0.0
    dev_events = 0
    dev_planes = []
    host_busy = 0.0
    for name, p in parsed["planes"].items():
        lname = name.lower()
        if "/device:" in lname:
            dev_busy += p["busy_s"]
            dev_events += p["events"]
            dev_planes.append(name)
        elif "/host:" in lname:
            # host plane busy includes the python line (outer frames nest, the
            # union handles it) — a coarse "host was doing something" signal
            host_busy = max(host_busy, p["busy_s"])
    return {
        "wall_s": round(wall_s, 3),
        "device_planes": dev_planes,
        "device_busy_s": round(dev_busy, 4),
        "device_busy_pct": round(100.0 * dev_busy / wall_s, 2) if wall_s else 0.0,
        "device_events": dev_events,
        "host_busy_s": round(host_busy, 4),
        "transfers": parsed["transfers"],
    }


def _run_traced(name: str, fn, trace_root: Path) -> dict:
    import jax

    fn()  # warm: steady-state, compiles cached
    tdir = trace_root / name
    t0 = time.perf_counter()
    with jax.profiler.trace(str(tdir)):
        fn()
    wall = time.perf_counter() - t0
    xplanes = sorted(tdir.glob("**/*.xplane.pb"))
    if not xplanes:
        return {"wall_s": round(wall, 3), "error": "no xplane written"}
    parsed = parse_xspace(xplanes[-1])
    rec = _device_summary(parsed, wall)
    rec["planes"] = parsed["planes"]
    # keep the raw trace only when small (xplanes from long runs reach
    # hundreds of MB — the parsed summary is the durable evidence)
    raw = xplanes[-1]
    size = raw.stat().st_size
    rec["xplane_bytes"] = size
    gz = tdir / (raw.name + ".gz")
    if size <= 8 * 1024 * 1024:
        with open(raw, "rb") as f_in, gzip.open(gz, "wb", compresslevel=6) as f_out:
            shutil.copyfileobj(f_in, f_out)
        rec["xplane_kept"] = str(gz.relative_to(REPO))
    shutil.rmtree(raw.parents[1], ignore_errors=True)  # plugins/profile/<run>
    return rec


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    stack = args[0] if args else str(REPO / "outputs" / "synth51")
    argv = sys.argv[1:]
    out_path = None
    sections = ("ks_bench", "patch_ensemble", "analyze", "transport")
    for i, a in enumerate(argv):
        if a == "--out":
            out_path = Path(argv[i + 1])
        if a == "--sections":
            sections = tuple(argv[i + 1].split(","))

    import pdx

    import jax

    on_accel = jax.default_backend() != "cpu"
    if on_accel:
        pdx.enable_compilation_cache()

    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    trace_root = REPO / "outputs" / f"profile_{stamp}"
    trace_root.mkdir(parents=True, exist_ok=True)

    results: dict = {"backend": jax.default_backend(), "stamp": stamp}

    def flush() -> None:
        (trace_root / "summary.json").write_text(json.dumps(results, indent=2))
        if out_path:
            out_path.write_text(json.dumps(results, indent=2))

    def section(name: str, fn) -> None:
        if name not in sections:
            return
        try:
            results[name] = _run_traced(name, fn, trace_root)
        except Exception as e:  # a failed section must not lose the others
            results[name] = {"error": f"{type(e).__name__}: {e}"}
        dev = results[name].get("device_busy_pct")
        print(f"{name}: wall={results[name].get('wall_s')}s device_busy={dev}%",
              flush=True)
        flush()

    # --- workloads (identical to the benched paths) ---
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run as ks_run

    ks_cfg = Ks2dBenchConfig(
        grid_search=True, dtype="float32" if on_accel else "float64"
    )
    section("ks_bench", lambda: ks_run(ks_cfg))

    import numpy as np

    from tools.make_synth_stack import make_stack
    from pdx.pipelines.patch_discovery import PatchDiscoveryConfig, run as pd_run

    if "patch_ensemble" in sections:
        U = make_stack(T=51, H=512, W=640).astype(np.float64)
        pe_cfg = PatchDiscoveryConfig(
            data_dir="unused", write_artifacts=False, skip=12, subsample=6
        )
        section("patch_ensemble", lambda: pd_run(pe_cfg, U_raw=U))

    from pdx.pipelines.analyze import AnalyzeConfig, run as an_run

    an_cfg = AnalyzeConfig(
        data_dir=stack, output_dir=str(trace_root / "analyze_out")
    )
    section("analyze", lambda: an_run(an_cfg))

    from pdx.pipelines.transport import TransportConfig, run as tr_run

    tr_cfg = TransportConfig(
        data_dir=stack, output_dir=str(trace_root / "transport_out")
    )
    section("transport", lambda: tr_run(tr_cfg))

    flush()
    print(f"summary -> {trace_root / 'summary.json'}")


if __name__ == "__main__":
    main()
