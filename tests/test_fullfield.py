"""Full-field Gram statistics (pdx.library.fullfield) and the
``ks2d-bench --solver fullfield`` path.

Each statistic is checked two ways: against the materialise-plus-GEMM
reference (the design matrix fed to ``gram_stats``) in float32, and against
a numpy float64 oracle that loops over the terms with ``np.roll``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pdx.library.fullfield import (
    RICH_TERM_NAMES,
    TRUE_TERM_NAMES,
    blockwise_gram,
    blockwise_gram_reference,
    fullfield_gram,
    fullfield_gram_reference,
    term_fields,
)

ADVECTION_NAMES = ("lap", "bih", "gradsq", "ux", "uy")
STAT_KEYS = ("G", "b", "sx", "syy", "sy", "n")


def _np_term_fields(u, dx, dy, names):
    def lap_of(f):
        return (
            (np.roll(f, -1, -2) - 2 * f + np.roll(f, 1, -2)) / dx**2
            + (np.roll(f, -1, -1) - 2 * f + np.roll(f, 1, -1)) / dy**2
        )

    ux = (np.roll(u, -1, -2) - np.roll(u, 1, -2)) / (2 * dx)
    uy = (np.roll(u, -1, -1) - np.roll(u, 1, -1)) / (2 * dy)
    lap = lap_of(u)
    table = {
        "one": np.ones_like(u), "u": u, "u2": u * u, "ux": ux, "uy": uy,
        "lap": lap, "bih": lap_of(lap), "gradsq": ux * ux + uy * uy, "u_lap": u * lap,
    }
    return [table[n] for n in names]


def _np_stats(X, y):
    return {
        "G": X.T @ X, "b": X.T @ y, "sx": X.sum(axis=0),
        "n": float(X.shape[0]), "syy": y @ y, "sy": y.sum(),
    }


def _np_blockwise(f, bt, bx, by):
    T, H, W = f.shape
    out = []
    for t0 in range(0, T, bt):
        for x0 in range(0, H, bx):
            for y0 in range(0, W, by):
                out.append(f[t0 : t0 + bt, x0 : x0 + bx, y0 : y0 + by].mean())
    return np.asarray(out)


def _fields(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (
        jnp.asarray(rng.normal(size=shape).astype(dtype)),
        jnp.asarray(rng.normal(size=shape).astype(dtype)),
    )


def _assert_stats_close(got, ref, rtol, atol_frac):
    for k in STAT_KEYS:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        np.testing.assert_allclose(
            g, r, rtol=rtol, atol=atol_frac * max(np.abs(r).max(), 1.0), err_msg=k
        )


# float32 sums of up to ~3e4 products, summed in another order than the
# GEMM: 2e-4 relative (3e-4 for the 9-term list, whose u^4-sized entries
# carry more cancellation) — the tolerances the streaming kernels were held to
@pytest.mark.parametrize(
    "names,shape,dx,dy,rtol,atol_frac",
    [
        (TRUE_TERM_NAMES, (8, 32, 128), 0.5, 0.25, 2e-4, 1e-4),
        (TRUE_TERM_NAMES, (7, 16, 128), 1.0, 1.0, 2e-4, 1e-4),
        (RICH_TERM_NAMES, (8, 32, 128), 0.5, 0.25, 3e-4, 2e-4),
        (RICH_TERM_NAMES, (7, 16, 128), 1.0, 1.0, 3e-4, 2e-4),
        (ADVECTION_NAMES, (6, 16, 128), 0.5, 0.5, 3e-4, 2e-4),
    ],
    ids=["true", "true-odd-T", "rich", "rich-odd-T-one", "advection"],
)
def test_fullfield_matches_materialised_reference(names, shape, dx, dy, rtol, atol_frac):
    U, Ut = _fields(shape, seed=len(names) + shape[0])
    ref = fullfield_gram_reference(U, Ut, dx, dy, names)
    got = fullfield_gram(U, Ut, dx, dy, names)
    _assert_stats_close(got, ref, rtol, atol_frac)


@pytest.mark.parametrize("names", [TRUE_TERM_NAMES, RICH_TERM_NAMES], ids=["true", "rich"])
def test_fullfield_matches_numpy_f64_oracle(names):
    U, Ut = _fields((5, 12, 20), seed=11, dtype=np.float64)
    dx, dy = 0.5, 0.25
    got = fullfield_gram(U, Ut, dx, dy, names)
    X = np.stack([f.reshape(-1) for f in _np_term_fields(np.asarray(U), dx, dy, names)], -1)
    _assert_stats_close(got, _np_stats(X, np.asarray(Ut).reshape(-1)), 1e-10, 1e-12)


# block means are reshape-sums, not GEMMs: same float32 tolerances as above
@pytest.mark.parametrize(
    "names,shape,blocks,rtol,atol_frac",
    [
        (TRUE_TERM_NAMES, (9, 32, 128), (3, 8, 8), 2e-4, 1e-4),
        (TRUE_TERM_NAMES, (8, 30, 126), (3, 8, 8), 2e-4, 1e-4),
        (RICH_TERM_NAMES, (9, 32, 128), (3, 8, 8), 3e-4, 2e-4),
        (RICH_TERM_NAMES, (8, 30, 126), (3, 8, 8), 3e-4, 2e-4),
    ],
    ids=["true", "true-ragged", "rich", "rich-ragged-one"],
)
def test_blockwise_matches_materialised_reference(names, shape, blocks, rtol, atol_frac):
    U, Ut = _fields(shape, seed=shape[0] + shape[1])
    bt, bx, by = blocks
    kw = dict(block_t=bt, block_x=bx, block_y=by)
    ref = blockwise_gram_reference(U, Ut, 0.5, 0.25, names, **kw)
    got = blockwise_gram(U, Ut, 0.5, 0.25, names, **kw)
    _assert_stats_close(got, ref, rtol, atol_frac)


def test_blockwise_matches_numpy_f64_oracle():
    """Ragged on every axis, with the constant term: each block mean is over
    its valid cells only, as in the reference's min(T, t0+bt) slicing."""
    U, Ut = _fields((7, 11, 13), seed=5, dtype=np.float64)
    names = RICH_TERM_NAMES
    got = blockwise_gram(U, Ut, 0.5, 0.25, names, block_t=3, block_x=4, block_y=5)
    fields = _np_term_fields(np.asarray(U), 0.5, 0.25, names)
    X = np.stack([_np_blockwise(f, 3, 4, 5) for f in fields], -1)
    y = _np_blockwise(np.asarray(Ut), 3, 4, 5)
    _assert_stats_close(got, _np_stats(X, y), 1e-10, 1e-12)


@pytest.mark.parametrize("blockwise", [False, True], ids=["fullfield", "blockwise"])
def test_stridge_on_stats_recovers_planted(blockwise):
    """The statistics feed the masked STRidge and recover a planted sparse
    combination (no biharmonic term)."""
    from pdx.solve.stridge import stridge_from_stats

    U, _ = _fields((12, 32, 128), seed=2)
    lap, _bih, gsq = term_fields(U, 0.5, 0.5, TRUE_TERM_NAMES)
    Ut = -1.0 * lap - 0.5 * gsq
    if blockwise:
        stats = blockwise_gram(U, Ut, 0.5, 0.5, block_t=3, block_x=8, block_y=8)
        alpha = 1e-8
    else:
        stats = fullfield_gram(U, Ut, 0.5, 0.5)
        alpha = 1e-6
    res = stridge_from_stats(stats, alpha=alpha, threshold=1e-3)
    np.testing.assert_allclose(np.asarray(res.coeffs), [-1.0, 0.0, -0.5], atol=2e-3)


def test_unknown_term_is_rejected():
    U, _ = _fields((2, 8, 8), seed=0)
    with pytest.raises(ValueError, match="unknown stencil terms"):
        term_fields(U, 1.0, 1.0, ("lap", "uxx"))


@pytest.mark.parametrize(
    "dictionary,method,bound",
    [
        ("true", "pointwise", 1.0),
        ("rich", "pointwise", 2.0),
        ("true", "blockwise", 1.0),
        ("rich", "blockwise", 2.0),
    ],
)
def test_bench_fullfield_solver_recovers_ks(dictionary, method, bound):
    """ks2d-bench --solver fullfield on the clean quick benchmark recovers
    (-1, -1, -0.5) through the same pipeline entry users call."""
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    cfg = Ks2dBenchConfig(
        grid_search=True, dtype="float32", Nx=32, Ny=32, n_seconds=0.2,
        solver="fullfield", dictionary=dictionary, method=method,
    )
    res = run(cfg)
    worst = max(v["rel_err_pct"] for v in res["gt_errors"].values())
    assert worst < bound, res["gt_errors"]


def test_fullfield_solver_requires_finite_derivatives():
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    cfg = Ks2dBenchConfig(
        grid_search=True, derivatives="spectral", Nx=32, Ny=32,
        n_seconds=0.2, solver="fullfield", dtype="float32",
    )
    with pytest.raises(ValueError, match="finite"):
        run(cfg)


def test_unknown_solver_is_rejected():
    """The removed streaming-kernel option is an error, not a silent 'auto'."""
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    with pytest.raises(ValueError, match="solver must be one of"):
        run(Ks2dBenchConfig(grid_search=True, Nx=32, Ny=32, n_seconds=0.2, solver="pallas"))
