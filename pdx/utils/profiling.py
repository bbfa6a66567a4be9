"""Lightweight profiling: per-stage wall-clock timers + optional XLA traces.

SURVEY §5 observability requirement: the reference has only coarse
time.time() prints; pdx provides a structured stage timer (used via
``with stage_timer.stage("name")``) and a jax.profiler trace context for
deep dives (view with TensorBoard or xprof).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class StageTimer:
    """Accumulates named stage durations; blocks on device results so timings
    reflect actual device work, not dispatch."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}
        self._order: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                import jax

                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            if name not in self.stages:
                self._order.append(name)
            self.stages[name] = self.stages.get(name, 0.0) + dt

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{'stage':<28}{'seconds':>10}{'share':>8}"]
        for name in self._order:
            dt = self.stages[name]
            lines.append(f"{name:<28}{dt:>10.4f}{dt / max(total, 1e-12):>8.1%}")
        lines.append(f"{'total':<28}{total:>10.4f}")
        return "\n".join(lines)

    def dump(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.stages, indent=2))


@contextlib.contextmanager
def xla_trace(log_dir: str | Path = "outputs/profile"):
    """jax.profiler trace context (TensorBoard/xprof-compatible)."""
    import jax

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_NULL_TIMER_CTX = contextlib.nullcontext()


def null_stage(*_args, **_kwargs):
    """Stage no-op for un-profiled runs (keeps call sites branch-free)."""
    return _NULL_TIMER_CTX


def sync_point(x):
    """Wait until the device has computed ``x`` (any pytree), so a stage's
    wall-clock includes its device work. Returns ``x`` unchanged."""
    import jax

    return jax.block_until_ready(x)


def gpu_cards() -> list[str]:
    """``name, power.limit`` of each NVIDIA card, as nvidia-smi reports
    them; every measurement keeps these beside its numbers. Raises
    RuntimeError when nvidia-smi is missing or fails."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return [line.strip() for line in proc.stdout.strip().splitlines()]
