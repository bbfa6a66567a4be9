"""Full-field Gram statistics of periodic-stencil KS term libraries.

The regression stack consumes the sufficient statistics
``{G, b, sx, n, syy, sy}`` that :func:`pdx.ops.linalg.gram_stats` forms from
a design matrix. Over a whole (T, H, W) frame stack that matrix would be
``T*H*W`` rows of p term values, p+1 trajectory copies in device memory.
Every statistic is a sum of products of term fields, so this module takes
the sums directly: the term fields are periodic stencils of ``u``, and the
p(p+1)/2 + 2p + 2 sums are one multi-output reduction that XLA fuses with
the stencils. The blockwise variant first reduces every field to its
(block_t x block_x x block_y) block means, exactly as
:func:`pdx.library.blockwise.build_blockwise_dataset` does, and takes the
same sums over the block-mean rows.

``fullfield_gram_reference`` and ``blockwise_gram_reference`` build the
design matrix and call ``gram_stats``; the tests compare against them.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import Array

from pdx.library.blockwise import _block_reduce_sum, block_counts, build_blockwise_dataset
from pdx.ops.linalg import gram_stats

TRUE_TERM_NAMES = ("lap", "bih", "gradsq")
RICH_TERM_NAMES = ("one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap")


def term_fields(u: Array, dx: float, dy: float, names: tuple[str, ...]) -> list[Array]:
    """The named periodic-stencil term fields of ``u`` (trailing axes H, W).

    Shared intermediates (gradients, laplacian) are built once, and only when
    a requested term needs them.
    """
    unknown = set(names) - set(RICH_TERM_NAMES)
    if unknown:
        raise ValueError(f"unknown stencil terms {sorted(unknown)}; valid: {RICH_TERM_NAMES}")
    need = set(names)

    def lap_of(f):
        return (
            (jnp.roll(f, -1, -2) - 2 * f + jnp.roll(f, 1, -2)) / (dx * dx)
            + (jnp.roll(f, -1, -1) - 2 * f + jnp.roll(f, 1, -1)) / (dy * dy)
        )

    ux = uy = lap = bih = None
    if need & {"ux", "uy", "gradsq"}:
        ux = (jnp.roll(u, -1, -2) - jnp.roll(u, 1, -2)) / (2 * dx)
        uy = (jnp.roll(u, -1, -1) - jnp.roll(u, 1, -1)) / (2 * dy)
    if need & {"lap", "bih", "u_lap"}:
        lap = lap_of(u)
    if "bih" in need:
        bih = lap_of(lap)
    built = {
        "one": lambda: jnp.ones_like(u),
        "u": lambda: u,
        "u2": lambda: u * u,
        "ux": lambda: ux,
        "uy": lambda: uy,
        "lap": lambda: lap,
        "bih": lambda: bih,
        "gradsq": lambda: ux * ux + uy * uy,
        "u_lap": lambda: u * lap,
    }
    return [built[n]() for n in names]


def _stats_from_fields(fields: list[Array], y: Array, n: int) -> dict[str, Array]:
    """gram_stats of the design matrix whose columns are the flattened
    ``fields`` and whose target is ``y``, without forming the matrix."""
    p = len(fields)
    pairs = [(i, j) for i in range(p) for j in range(i, p)]
    sums = jnp.stack(
        [jnp.sum(fields[i] * fields[j]) for i, j in pairs]
        + [jnp.sum(f * y) for f in fields]
        + [jnp.sum(f) for f in fields]
        + [jnp.sum(y), jnp.sum(y * y)]
    )
    tri_index = np.zeros((p, p), np.int32)
    for k, (i, j) in enumerate(pairs):
        tri_index[i, j] = tri_index[j, i] = k
    ntri = len(pairs)
    return {
        "G": sums[tri_index],
        "b": sums[ntri : ntri + p],
        "sx": sums[ntri + p : ntri + 2 * p],
        "n": jnp.asarray(n, sums.dtype),
        "syy": sums[-1],
        "sy": sums[-2],
    }


def fullfield_gram(
    U: Array, Ut: Array, dx: float, dy: float, names: tuple[str, ...] = TRUE_TERM_NAMES
) -> dict[str, Array]:
    """Gram statistics of the named terms of ``U`` against ``Ut`` over every
    sample of the aligned (T, H, W) stacks."""
    return _stats_from_fields(term_fields(U, dx, dy, names), Ut, int(np.prod(U.shape)))


def blockwise_gram(
    U: Array,
    Ut: Array,
    dx: float,
    dy: float,
    names: tuple[str, ...] = TRUE_TERM_NAMES,
    *,
    block_t: int,
    block_x: int,
    block_y: int,
) -> dict[str, Array]:
    """Gram statistics of the blockwise dataset: block means of the named
    terms and of ``Ut`` over (block_t, block_x, block_y) blocks, ragged tail
    blocks averaged over their valid cells."""
    bt, bx, by = int(block_t), int(block_x), int(block_y)
    if bt <= 0 or bx <= 0 or by <= 0:
        raise ValueError("block_t/block_x/block_y must all be positive")
    cnt = block_counts(*U.shape, bt, bx, by, U.dtype)
    means = [
        _block_reduce_sum(f, bt, bx, by) / cnt
        for f in term_fields(U, dx, dy, names) + [Ut]
    ]
    return _stats_from_fields(means[:-1], means[-1], cnt.size)


def fullfield_gram_reference(
    U: Array, Ut: Array, dx: float, dy: float, names: tuple[str, ...] = TRUE_TERM_NAMES
) -> dict[str, Array]:
    """Materialise the (T*H*W, p) design matrix and call gram_stats."""
    X = jnp.stack([f.reshape(-1) for f in term_fields(U, dx, dy, names)], axis=-1)
    return gram_stats(X, Ut.reshape(-1))


def blockwise_gram_reference(
    U: Array,
    Ut: Array,
    dx: float,
    dy: float,
    names: tuple[str, ...] = TRUE_TERM_NAMES,
    *,
    block_t: int,
    block_x: int,
    block_y: int,
) -> dict[str, Array]:
    """Materialise the term stack, build the blockwise dataset and call
    gram_stats."""
    terms = jnp.stack(term_fields(U, dx, dy, names), axis=0)
    X, y = build_blockwise_dataset(Ut, terms, block_t=block_t, block_x=block_x, block_y=block_y)
    return gram_stats(X, y)
