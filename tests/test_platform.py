"""Platform plumbing: the compile-cache location, the smoke script's refusal
to run without a GPU, the multi-device dry run's device check, stage sync
points, and the float32 Gram accumulation."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pdx

REPO = Path(__file__).resolve().parent.parent
_CACHE_OPTIONS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_entry_size_bytes",
    "jax_persistent_cache_min_compile_time_secs",
)


def test_compilation_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert pdx.compilation_cache_dir() == str(REPO / ".jax_cache")


def test_compilation_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert pdx.compilation_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("env_set", [False, True], ids=["repo-dir", "env-dir"])
def test_enable_compilation_cache_sets_no_dir_of_its_own_under_env(
    monkeypatch, tmp_path, env_set
):
    """Without the variable the repo directory is configured; with it, the
    directory JAX took from the variable is left alone."""
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
    sentinel = str(tmp_path / "what-jax-read")
    try:
        # nothing compiles between set and restore, so no cache is opened
        jax.config.update("jax_compilation_cache_dir", sentinel)
        got = pdx.enable_compilation_cache()
        configured = jax.config.jax_compilation_cache_dir
        min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    if env_set:
        assert got == str(tmp_path)
        assert configured == sentinel
    else:
        assert got == str(REPO / ".jax_cache")
        assert configured == got
    assert min_secs == 0.0


def test_chip_smoke_refuses_the_cpu(capsys):
    """In this process JAX runs on the CPU: the smoke script exits non-zero
    at its device check and prints no result line."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--gpus", "4"]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied into a directory with nothing else of the repository, the
    script fails and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_dryrun_multichip_raises_with_too_few_devices():
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.remove(str(REPO))
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices"):
        ge.dryrun_multichip(n)


def test_sync_point_drains_every_leaf():
    from pdx.utils.profiling import sync_point

    f = jax.jit(lambda x: (x @ x.T, {"s": jnp.sum(x), "t": [x * 2.0]}))
    tree = f(jnp.ones((64, 32)))
    out = sync_point(tree)
    assert out is tree
    assert all(leaf.is_ready() for leaf in jax.tree_util.tree_leaves(out))
    np.testing.assert_allclose(np.asarray(out[1]["s"]), 64 * 32)


@pytest.mark.parametrize(
    "names,blocks",
    [("true", None), ("rich", None), ("true", (3, 8, 8))],
    ids=["true3", "rich9", "blockwise3x8x8"],
)
def test_chip_smoke_fullfield_check_passes_here(names, blocks):
    """The smoke script's host float64 comparison of the full-field
    statistics, at a small size on the CPU, stays under its tolerance."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from pdx.library.fullfield import RICH_TERM_NAMES, TRUE_TERM_NAMES

    rng = np.random.default_rng(7)
    U = jnp.asarray(rng.normal(size=(10, 20, 24)).astype(np.float32))
    Ut = jnp.asarray(rng.normal(size=(10, 20, 24)).astype(np.float32))
    term_names = TRUE_TERM_NAMES if names == "true" else RICH_TERM_NAMES
    err = chip_smoke.fullfield_errors(U, Ut, 0.5, 0.25, term_names, blocks)
    assert err <= chip_smoke.FULLFIELD_RTOL
