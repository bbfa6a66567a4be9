"""pdx CLI — workload entry points mirroring the reference scripts.

Usage:
  python -m pdx ks2d-bench [--method pointwise|blockwise|weakform] [...]
  python -m pdx analyze --data-dir DIR [...]
  python -m pdx patch-discover --data-dir DIR [...]
  python -m pdx transport --data-dir DIR [...]
  python -m pdx run-all --data-dir DIR [...]

Parity: the reference's per-script CLIs (QUICKSTART.md:22-43); flag names
match ks2d_stridge_benchmark.py:1108-1353 where applicable.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=f.default)
        elif f.type in ("tuple[int, ...]",):
            parser.add_argument(
                name,
                type=lambda s: tuple(int(x) for x in s.split(",") if x.strip()),
                default=f.default,
            )
        else:
            py_type = {
                "int": int, "float": float, "str": str,
                "int | None": int, "float | None": float,
            }.get(str(f.type), str)
            parser.add_argument(name, type=py_type, default=f.default)


def _namespace_to_config(args: argparse.Namespace, cls):
    kwargs = {f.name: getattr(args, f.name) for f in dataclasses.fields(cls)}
    return cls(**kwargs)


def cmd_ks2d_bench(argv: list[str]) -> int:
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    parser = argparse.ArgumentParser(prog="pdx ks2d-bench")
    _add_dataclass_args(parser, Ks2dBenchConfig)
    args = parser.parse_args(argv)
    cfg = _namespace_to_config(args, Ks2dBenchConfig)
    res = run(cfg)

    print("Discovered PDE (|c| > 1e-8):")
    for name, c in sorted(zip(res["display_names"], res["coeffs"]), key=lambda p: -abs(p[1])):
        if abs(c) > 1e-8:
            print(f"  {name:8s}: {c:+.6f}")
    print("\nGround-truth comparison (relative error):")
    for k, v in res["gt_errors"].items():
        print(f"  {k:8s}: gt={v['gt']:+.6f}, est={v['est']:+.6f}, rel_err={v['rel_err_pct']:.3f}%")
    print("\nFit quality:")
    if "train_r2" in res["fit"]:  # fast grid paths report the scored split only
        print(f"  Train R2={res['fit']['train_r2']:.6f}, RMSE={res['fit']['train_rmse']:.6e}")
    print(f"  Test  R2={res['fit']['test_r2']:.6f}, RMSE={res['fit']['test_rmse']:.6e}")
    r = res["rollout"]
    print(
        f"\nRollout RMSE over {r['n_steps']} steps: first={r['first']:.3e}, "
        f"last={r['last']:.3e}, mean={r['mean']:.3e}"
    )
    return 0


def cmd_json(argv: list[str]) -> int:
    """ks2d-bench with machine-readable JSON output."""
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    parser = argparse.ArgumentParser(prog="pdx ks2d-bench-json")
    _add_dataclass_args(parser, Ks2dBenchConfig)
    args = parser.parse_args(argv)
    res = run(_namespace_to_config(args, Ks2dBenchConfig))
    print(json.dumps(res, default=float))
    return 0


def cmd_list_resolutions(argv: list[str]) -> int:
    """Image-resolution audit (reference: scripts/list_image_resolutions.py)."""
    import argparse

    from pdx.io_host.images import list_image_resolutions

    parser = argparse.ArgumentParser(prog="pdx list-resolutions")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--pattern", default="*.tif")
    args = parser.parse_args(argv)
    hist = list_image_resolutions(args.data_dir, args.pattern)
    if not hist:
        print(f"no images matching {args.pattern} in {args.data_dir}")
        return 1
    for (h, w), n in sorted(hist.items()):
        print(f"  {h} x {w}: {n} files")
    return 0


def cmd_doctor(argv: list[str]) -> int:
    """Environment sanity check: backend, precision, cache, native library,
    virtual mesh capability."""
    import jax
    import jax.numpy as jnp

    print(f"jax {jax.__version__}  backend={jax.default_backend()}  devices={jax.device_count()}")
    print(f"devices: {[str(d) for d in jax.devices()][:4]}")
    print(f"x64 enabled: {jax.config.jax_enable_x64}")
    print(f"matmul precision: {jax.config.jax_default_matmul_precision} (pdx pins 'highest')")
    x = jnp.ones((128, 128))
    import time

    (x @ x).block_until_ready()
    t0 = time.perf_counter()
    (x @ x).block_until_ready()
    print(f"dispatch+sync latency: {(time.perf_counter() - t0) * 1000:.1f} ms")
    from pdx import native

    print(f"native C++ hostops: {'available' if native.available() else 'UNAVAILABLE (g++ build failed)'}")
    import os

    import pdx

    cache = pdx.compilation_cache_dir()
    n_entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"compile cache: {cache} ({n_entries} entries; on for GPU runs)")
    return 0


COMMANDS = {
    "ks2d-bench": cmd_ks2d_bench,
    "ks2d-bench-json": cmd_json,
    "list-resolutions": cmd_list_resolutions,
    "doctor": cmd_doctor,
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # subcommands registered lazily by pipeline availability
    try:
        from pdx.pipelines.analyze import cmd_analyze  # noqa: F401

        COMMANDS["analyze"] = cmd_analyze
    except ImportError:
        pass
    try:
        from pdx.pipelines.patch_discovery import cmd_patch_discover  # noqa: F401

        COMMANDS["patch-discover"] = cmd_patch_discover
    except ImportError:
        pass
    try:
        from pdx.pipelines.transport import cmd_transport  # noqa: F401

        COMMANDS["transport"] = cmd_transport
    except ImportError:
        pass
    try:
        from pdx.pipelines.run_all import cmd_run_all  # noqa: F401

        COMMANDS["run-all"] = cmd_run_all
    except ImportError:
        pass
    try:
        from pdx.pipelines.comprehensive import cmd_comprehensive  # noqa: F401

        COMMANDS["comprehensive"] = cmd_comprehensive
    except ImportError:
        pass
    try:
        from pdx.pipelines.improved_registration import cmd_improved_registration  # noqa: F401

        COMMANDS["improved-registration"] = cmd_improved_registration
    except ImportError:
        pass
    try:
        from pdx.pipelines.patch_sindy import cmd_patch_sindy  # noqa: F401

        COMMANDS["patch-sindy"] = cmd_patch_sindy
    except ImportError:
        pass
    try:
        from pdx.pipelines.sindy1d import cmd_sindy1d  # noqa: F401

        COMMANDS["sindy1d"] = cmd_sindy1d
    except ImportError:
        pass

    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"error: unknown command '{cmd}'. available: {', '.join(sorted(COMMANDS))}", file=sys.stderr)
        return 2
    # persistent compile cache on the GPU: pipelines are compile-dominated on
    # a first run; XLA:CPU cache entries can mismatch host features, so the
    # CPU stays uncached
    import jax
    import pdx

    if jax.default_backend() == "gpu":
        pdx.enable_compilation_cache()
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
