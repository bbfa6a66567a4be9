"""Gather-based bilinear sampling, warping, and resizing (device-side).

Device replacements for the OpenCV C++ primitives the reference leans on:
``cv2.warpAffine`` (INTER_LINEAR, BORDER_WRAP) used for subpixel shifts
(``ks2d_stridge_benchmark.py:785-798``), ``cv2.remap`` with reflect border
used for dense-flow warping (``pde_discovery_improved_registration.py:88-97``),
and ``cv2.resize`` INTER_AREA / INTER_LINEAR used for image downscaling
(``analyze_results.py:213``, ``transport_pde_discovery.py:254-256``).

Coordinates are in array-axis convention: ``x`` indexes axis -2 (rows), ``y``
indexes axis -1 (cols) — the same convention the reference uses after
translating OpenCV's (col, row) arguments.
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array


def _gather2d(f: Array, ix: Array, iy: Array) -> Array:
    """f[..., ix, iy] with integer index arrays broadcast over leading axes."""
    return f[..., ix, iy]


# ---------------------------------------------------------------------------
# Banded-matrix lowering of separable kernels
#
# A 1-D correlation with symmetric-reflect padding is a linear map, so it IS
# an (L, L) banded matrix with the reflection folded into the band ends. One
# (L, L) matmul per axis reads the operand ONCE, where the shifted-add
# formulation issues `taps` vector ops per axis; the matmul was the faster
# choice on the accelerator this policy was tuned for (inherited tuning, not
# yet measured on the H100). On a single-core CPU the opposite holds (the
# matmul does L x more FLOPs than the adds), so the choice is made at trace
# time per backend. PDX_SEP_IMPL=banded|shift overrides for A/B and tests.
# ---------------------------------------------------------------------------


# banded-sep einsum precision. The banded lowering must agree with the
# float64 shifted-add filter to float32 rounding (1e-6 relative). On the
# H100, HIGH runs the matmuls at TF32-class precision: a sigma=1 Gaussian
# over 51x512x640 frames was off by 5.6e-4 relative (HIGHEST: 2.3e-7), for
# 0.32 ms instead of 0.99 ms per pass. HIGHEST it is.
_SEP_PREC = jax.lax.Precision.HIGHEST


def use_banded_sep() -> bool:
    """Trace-time policy: lower separable passes as banded matmuls?"""
    impl = os.environ.get("PDX_SEP_IMPL")
    if impl:
        return impl == "banded"
    return jax.default_backend() != "cpu"


def _reflect_sym_np(idx: np.ndarray, L: int) -> np.ndarray:
    """np.pad(mode='symmetric') index folding, multi-fold for taps > L."""
    idx = np.asarray(idx).copy()
    while ((idx < 0) | (idx >= L)).any():
        idx = np.where(idx < 0, -1 - idx, idx)
        idx = np.where(idx >= L, 2 * L - 1 - idx, idx)
    return idx


@lru_cache(maxsize=256)
def band_matrix(kernel: tuple, L: int) -> np.ndarray:
    """(L, L) matrix M with M @ v == correlate(pad(v, symmetric), kernel)."""
    k = np.asarray(kernel, np.float64)
    n = len(k) // 2
    rows = np.arange(L)
    M = np.zeros((L, L))
    for i, kv in enumerate(k):
        src = _reflect_sym_np(rows + i - n, L)
        np.add.at(M, (rows, src), kv)
    return M


@lru_cache(maxsize=256)
def resize_matrix(L: int, out: int) -> np.ndarray:
    """(out, L) bilinear-resize matrix (cv2 INTER_LINEAR half-pixel centers,
    edge clamp) — the separable factor of :func:`resize_bilinear`."""
    s = L / out
    x = np.clip((np.arange(out) + 0.5) * s - 0.5, 0.0, L - 1.0)
    x0 = np.floor(x).astype(int)
    t = x - x0
    x1 = np.minimum(x0 + 1, L - 1)
    M = np.zeros((out, L))
    np.add.at(M, (np.arange(out), x0), 1.0 - t)
    np.add.at(M, (np.arange(out), x1), t)
    return M


def bilinear_sample_periodic(f: Array, x: Array, y: Array) -> Array:
    """Sample f at fractional coordinates with periodic wrapping.

    ``x``/``y`` are float arrays (any shape); output has shape
    ``f.shape[:-2] + x.shape``.
    """
    H, W = f.shape[-2], f.shape[-1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    tx = (x - x0).astype(f.dtype)
    ty = (y - y0).astype(f.dtype)
    x0i = jnp.mod(x0.astype(jnp.int32), H)
    y0i = jnp.mod(y0.astype(jnp.int32), W)
    x1i = jnp.mod(x0i + 1, H)
    y1i = jnp.mod(y0i + 1, W)
    f00 = _gather2d(f, x0i, y0i)
    f01 = _gather2d(f, x0i, y1i)
    f10 = _gather2d(f, x1i, y0i)
    f11 = _gather2d(f, x1i, y1i)
    return (
        f00 * (1 - tx) * (1 - ty)
        + f01 * (1 - tx) * ty
        + f10 * tx * (1 - ty)
        + f11 * tx * ty
    )


def _reflect101_index(i: Array, n: int) -> Array:
    """BORDER_REFLECT_101 index folding: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...

    Period is 2(n-1); valid for any integer input when n >= 2.
    """
    if n == 1:
        return jnp.zeros_like(i)
    period = 2 * (n - 1)
    j = jnp.mod(i, period)
    return jnp.where(j >= n, period - j, j)


def bilinear_sample_reflect(f: Array, x: Array, y: Array) -> Array:
    """Sample f at fractional coordinates with BORDER_REFLECT_101 folding
    (OpenCV's default border for remap in the reference registration code)."""
    H, W = f.shape[-2], f.shape[-1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    tx = (x - x0).astype(f.dtype)
    ty = (y - y0).astype(f.dtype)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    xa = _reflect101_index(x0i, H)
    xb = _reflect101_index(x0i + 1, H)
    ya = _reflect101_index(y0i, W)
    yb = _reflect101_index(y0i + 1, W)
    f00 = _gather2d(f, xa, ya)
    f01 = _gather2d(f, xa, yb)
    f10 = _gather2d(f, xb, ya)
    f11 = _gather2d(f, xb, yb)
    return (
        f00 * (1 - tx) * (1 - ty)
        + f01 * (1 - tx) * ty
        + f10 * tx * (1 - ty)
        + f11 * tx * ty
    )


def _gather2d_rowfold_batch(f: Array, ix: Array, iy: Array) -> Array:
    """Per-batch-element 2-D gather.

    ``f`` is (B, H, W) or (C, B, H, W) — channel axis FIRST in the batched
    form; ``ix``/``iy`` are integer (B, h, w) index arrays that DIFFER per
    batch element. The lowering was chosen by A/B on the accelerator it was
    first tuned for (inherited tuning, not yet measured on the H100):

      * (B, H, W): flat 1-D ``jnp.take`` with precomputed linear indices,
        faster than the row-folded 2-index gather.
      * (C, B, H, W): CHANNEL-LAST row-take — transpose the operand to
        (B, H, W, C), flatten the leading three axes, and ``take`` whole
        C-vectors per pixel index (~10x faster than row-folded or
        channel-first takes there): one index fetching a contiguous
        C-vector beat C scalar-indexed fetches.

    Two older formulations stay documented as known-bad: ``vmap`` of
    ``f[ix, iy]`` lowers to a gather with batching dimensions (100-400x
    slower there), and one giant flat take over (B, C, H, W) operands
    materializes multi-GB s32 index tensors (a 27.5 GB request at the
    default patch grid).
    """
    # shapes are static at trace time: refuse silently-wrapping int32 index
    # arithmetic (flat indices reach B*H*W, or B*H*W*C elements via the
    # take row count, before the 2^31 boundary)
    if f.size >= 2**31:
        raise ValueError(
            f"gather operand has {f.size} elements (>= 2^31): int32 "
            "index arithmetic would overflow — split the batch axis"
        )
    if f.ndim == 3:
        B, H, W = f.shape
        idx = jnp.arange(B, dtype=jnp.int32)[:, None, None] * (H * W) + ix * W + iy
        return jnp.take(f.reshape(-1), idx.reshape(-1)).reshape(ix.shape)
    C, B, H, W = f.shape
    fc = jnp.moveaxis(f, 0, -1).reshape(B * H * W, C)
    idx = (jnp.arange(B, dtype=jnp.int32)[:, None, None] * H + ix) * W + iy
    # (B, h, w, C) -> channel back to the leading axis for the callers
    return jnp.moveaxis(jnp.take(fc, idx, axis=0), -1, 0)


def bilinear_sample_reflect_batch(f: Array, x: Array, y: Array) -> Array:
    """Batched :func:`bilinear_sample_reflect`: per-element fractional
    coordinates over a batch axis, executed as row-folded plain gathers
    (see :func:`_gather2d_rowfold_batch`).

    ``f``: (B, H, W) or (B, C, H, W); ``x``/``y``: (B, h, w) floats.
    Returns (B, h, w) or (B, C, h, w). For the 4-D case prefer
    :func:`bilinear_sample_reflect_cbatch` with a natively channel-first
    (C, B, H, W) operand — this wrapper pays a (B,C)->(C,B) transpose.
    """
    if f.ndim == 4:
        out = bilinear_sample_reflect_cbatch(jnp.moveaxis(f, 1, 0), x, y)
        return jnp.moveaxis(out, 0, 1)
    H, W = f.shape[-2], f.shape[-1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    tx = (x - x0).astype(f.dtype)
    ty = (y - y0).astype(f.dtype)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    xa = _reflect101_index(x0i, H)
    xb = _reflect101_index(x0i + 1, H)
    ya = _reflect101_index(y0i, W)
    yb = _reflect101_index(y0i + 1, W)
    f00 = _gather2d_rowfold_batch(f, xa, ya)
    f01 = _gather2d_rowfold_batch(f, xa, yb)
    f10 = _gather2d_rowfold_batch(f, xb, ya)
    f11 = _gather2d_rowfold_batch(f, xb, yb)
    return (
        f00 * (1 - tx) * (1 - ty)
        + f01 * (1 - tx) * ty
        + f10 * tx * (1 - ty)
        + f11 * tx * ty
    )


def bilinear_sample_reflect_cbatch(f: Array, x: Array, y: Array) -> Array:
    """Channel-first batched bilinear sampling: ``f`` (C, B, H, W),
    ``x``/``y`` (B, h, w) -> (C, B, h, w).

    One index pair fetches all C channels (channel is a gather offset dim,
    exactly like the fast unbatched ``f[..., ix, iy]``) — callers that
    build their channel stacks with ``jnp.stack(..., axis=0)`` avoid any
    transpose.
    """
    H, W = f.shape[-2], f.shape[-1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    tx = (x - x0).astype(f.dtype)
    ty = (y - y0).astype(f.dtype)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    xa = _reflect101_index(x0i, H)
    xb = _reflect101_index(x0i + 1, H)
    ya = _reflect101_index(y0i, W)
    yb = _reflect101_index(y0i + 1, W)
    f00 = _gather2d_rowfold_batch(f, xa, ya)
    f01 = _gather2d_rowfold_batch(f, xa, yb)
    f10 = _gather2d_rowfold_batch(f, xb, ya)
    f11 = _gather2d_rowfold_batch(f, xb, yb)
    return (
        f00 * (1 - tx) * (1 - ty)
        + f01 * (1 - tx) * ty
        + f10 * tx * (1 - ty)
        + f11 * tx * ty
    )


def _reflect101_fold_float(x: Array, n: int) -> Array:
    """Continuous BORDER_REFLECT_101 folding of fractional coordinates into
    [0, n-1]: the reflect-extended image is the periodization (period
    2(n-1)) of a triangle-folded coordinate, so bilinear interpolation at x
    equals bilinear interpolation at fold(x) — the identity that lets the
    packed sampler gather CONTIGUOUS 2x2 blocks instead of 4 independently
    folded taps."""
    if n == 1:
        return jnp.zeros_like(x)
    period = 2 * (n - 1)
    m = jnp.mod(x, period)
    return (n - 1) - jnp.abs(m - (n - 1))


def bilinear_sample_reflect_batch_packed(f: Array, x: Array, y: Array) -> Array:
    """Packed batched bilinear sampling, reflect border: ``f`` (B, H, W),
    ``x``/``y`` (B, h, w) -> (B, h, w).

    Gathers on the accelerator this was tuned for were index-count-bound
    (fetching a 5-vector per index cost less than five scalar indices;
    inherited tuning, not yet measured on the H100). The classic
    formulation folds each of the 4 bilinear taps independently (4 takes). Here the COORDINATES are reflect-folded
    first (:func:`_reflect101_fold_float` — exact, the reflect-extended
    image is piecewise-linear in the folded coordinate), after which the 4
    taps are always the contiguous block (x0:x0+2, y0:y0+2): stack the 4
    shifted views channel-last and fetch each pixel's 2x2 block with ONE
    index. 4x fewer gather indices for 4x operand materialization — a
    win at warp scale where it was first tuned (not yet measured on the
    H100).
    Value-parity with :func:`bilinear_sample_reflect_batch` is pinned to
    ~1e-6 in tests/test_ops.py (floating-point fold vs integer fold)."""
    H, W = f.shape[-2], f.shape[-1]
    if H < 2 or W < 2:
        return bilinear_sample_reflect_batch(f, x, y)
    # the C=1 case of the channel-first packed sampler (16-byte block fetch)
    return bilinear_sample_reflect_cbatch_packed(f[None], x, y)[0]


def _packed_corner_weights(xf, yf, H, W, dtype):
    """Shared packed-sampler index/weight computation on FOLDED coords."""
    x0 = jnp.clip(jnp.floor(xf).astype(jnp.int32), 0, H - 2)
    y0 = jnp.clip(jnp.floor(yf).astype(jnp.int32), 0, W - 2)
    tx = (xf - x0).astype(dtype)
    ty = (yf - y0).astype(dtype)
    wts = jnp.stack(
        [(1 - tx) * (1 - ty), (1 - tx) * ty, tx * (1 - ty), tx * ty], axis=-1
    )  # (..., 4) in corner order [00, 01, 10, 11]
    return x0, y0, wts


def _combine_corners(g: Array, wts: Array) -> Array:
    """(..., 4, C) corner fetches x (..., 4) weights -> (..., C), as explicit
    multiply-adds (a k=4 einsum would ride the global HIGHEST dot precision
    — multi-pass f32 matmul work for a 4-term sum)."""
    w = wts[..., None]
    return (
        g[..., 0, :] * w[..., 0, :]
        + g[..., 1, :] * w[..., 1, :]
        + g[..., 2, :] * w[..., 2, :]
        + g[..., 3, :] * w[..., 3, :]
    )


def use_packed_fetch() -> bool:
    """Trace-time policy for the pyramid EXPANSION fetch: classic 4-tap
    channel-last takes everywhere. The packed 2x2-block variant lost to
    taps at the production flow shape (1500 half-res pairs, refine=1) on the
    accelerator it was first tuned for (not yet measured on the H100): the
    5-channel corner block is an 80-byte fetch per index (4 corners x 5 ch x
    f32), past the gather width where index-count savings paid (the warp's
    blocks are 16 bytes). PDX_FETCH_IMPL=packed re-enables for A/B."""
    return os.environ.get("PDX_FETCH_IMPL") == "packed"


def _corner_blocks_cl(v: Array) -> Array:
    """(..., H, W, C) -> (..., H-1, W-1, 4, C) channel-last corner blocks."""
    return jnp.stack(
        [
            v[..., :-1, :-1, :],
            v[..., :-1, 1:, :],
            v[..., 1:, :-1, :],
            v[..., 1:, 1:, :],
        ],
        axis=-2,
    )


def bilinear_sample_reflect_packed(f: Array, x: Array, y: Array) -> Array:
    """Packed unbatched sampler: ``f`` (..., H, W) (leading axes = channels),
    coords (h, w) shared across channels -> f.shape[:-2] + x.shape.

    Same trick as :func:`bilinear_sample_reflect_batch_packed` — fold the
    coordinates, fetch contiguous 2x2xC blocks with one index per pixel —
    for the UNBATCHED pyramid/warp programs (the lax.scan chain bodies)."""
    H, W = f.shape[-2], f.shape[-1]
    if H < 2 or W < 2:
        return bilinear_sample_reflect(f, x, y)
    lead = f.shape[:-2]
    C = int(np.prod(lead)) if lead else 1
    v = jnp.moveaxis(f.reshape(C, H, W), 0, -1)  # (H, W, C)
    blocks = _corner_blocks_cl(v).reshape((H - 1) * (W - 1), 4 * C)
    xf = _reflect101_fold_float(x, H)
    yf = _reflect101_fold_float(y, W)
    x0, y0, wts = _packed_corner_weights(xf, yf, H, W, f.dtype)
    g = jnp.take(blocks, x0 * (W - 1) + y0, axis=0).reshape(x.shape + (4, C))
    out = _combine_corners(g, wts)  # (h, w, C)
    out = jnp.moveaxis(out, -1, 0).reshape(lead + x.shape)
    return out


def bilinear_sample_reflect_cbatch_packed(f: Array, x: Array, y: Array) -> Array:
    """Packed channel-first batched sampler: ``f`` (C, B, H, W),
    coords (B, h, w) -> (C, B, h, w).

    The packed counterpart of :func:`bilinear_sample_reflect_cbatch`: ONE
    index per output pixel fetches the contiguous (2x2, C) corner block —
    4x fewer gather indices than the 4-tap channel-last take for 4x operand
    materialization (see :func:`bilinear_sample_reflect_batch_packed`)."""
    C, B, H, W = f.shape
    if H < 2 or W < 2:
        return bilinear_sample_reflect_cbatch(f, x, y)
    v = jnp.moveaxis(f, 0, -1)  # (B, H, W, C)
    blocks = _corner_blocks_cl(v).reshape(B * (H - 1) * (W - 1), 4 * C)
    if blocks.size >= 2**31:
        raise ValueError(
            f"packed gather operand has {blocks.size} elements (>= 2^31): "
            "int32 index arithmetic would overflow — split the batch axis"
        )
    xf = _reflect101_fold_float(x, H)
    yf = _reflect101_fold_float(y, W)
    x0, y0, wts = _packed_corner_weights(xf, yf, H, W, f.dtype)
    idx = (jnp.arange(B, dtype=jnp.int32)[:, None, None] * (H - 1) + x0) * (
        W - 1
    ) + y0
    g = jnp.take(blocks, idx, axis=0).reshape(x.shape + (4, C))
    out = _combine_corners(g, wts)  # (B, h, w, C)
    return jnp.moveaxis(out, -1, 0)


def _warp_impl_default() -> str:
    """Batched-warp lowering policy: packed 2x2-block gather on accelerators
    (4x fewer gather indices; inherited tuning from index-count-bound
    gathers, not yet measured on the H100), classic 4-tap on CPU
    (keeps the CPU golden path bit-stable; the packed operand build costs
    real memory traffic on the single-core host). PDX_WARP_IMPL overrides."""
    impl = os.environ.get("PDX_WARP_IMPL")
    if impl:
        return impl
    return "packed" if jax.default_backend() != "cpu" else "taps"


def warp_flow_batch(f: Array, flow_x: Array, flow_y: Array) -> Array:
    """Batched backward-flow warp (reflect border): ``f``/flows (B, H, W)."""
    H, W = f.shape[-2], f.shape[-1]
    dtype = flow_x.dtype
    r = jnp.arange(H, dtype=dtype)[:, None]
    c = jnp.arange(W, dtype=dtype)[None, :]
    if f.ndim == 3 and _warp_impl_default() == "packed":
        return bilinear_sample_reflect_batch_packed(f, r + flow_x, c + flow_y)
    return bilinear_sample_reflect_batch(f, r + flow_x, c + flow_y)


def shift_periodic(f: Array, shift_x: Array | float, shift_y: Array | float) -> Array:
    """Subpixel translation with periodic wrap: out[r, c] = f(r - sx, c - sy).

    Parity: ``_shift_frame_wrap`` (ks2d_stridge_benchmark.py:785-798) —
    cv2.warpAffine with M = [[1,0,sy],[0,1,sx]], INTER_LINEAR, BORDER_WRAP
    moves image content by (+sx rows, +sy cols).

    Implementation: a blend of four circular rolls rather than a coordinate
    gather — bit-equivalent bilinear result, and dynamic rolls vectorize
    cleanly under vmap where batched gathers lower poorly.
    """
    sx = jnp.asarray(shift_x, dtype=f.dtype)
    sy = jnp.asarray(shift_y, dtype=f.dtype)
    i0 = jnp.floor(sx).astype(jnp.int32)
    j0 = jnp.floor(sy).astype(jnp.int32)
    tx = sx - i0
    ty = sy - j0
    f00 = jnp.roll(f, (i0, j0), axis=(-2, -1))
    f10 = jnp.roll(f, (i0 + 1, j0), axis=(-2, -1))
    f01 = jnp.roll(f, (i0, j0 + 1), axis=(-2, -1))
    f11 = jnp.roll(f, (i0 + 1, j0 + 1), axis=(-2, -1))
    return f00 * (1 - tx) * (1 - ty) + f10 * tx * (1 - ty) + f01 * (1 - tx) * ty + f11 * tx * ty


def shift_reflect(f: Array, shift_x: Array | float, shift_y: Array | float) -> Array:
    """Subpixel translation with BORDER_REFLECT_101 (real-image variant,
    ``analyze_results.py:120-127``)."""
    H, W = f.shape[-2], f.shape[-1]
    dtype = jnp.result_type(f.dtype, jnp.float32)
    r = jnp.arange(H, dtype=dtype)[:, None]
    c = jnp.arange(W, dtype=dtype)[None, :]
    return bilinear_sample_reflect(f, r - shift_x, c - shift_y)


def remap_bilinear(f: Array, map_x: Array, map_y: Array, *, border: str = "reflect") -> Array:
    """Backward-map warp: out[r, c] = f(map_x[r, c], map_y[r, c]).

    Parity: ``cv2.remap(frame, map_y, map_x, INTER_LINEAR, BORDER_REFLECT)``
    as used for optical-flow registration warps
    (``pde_discovery_improved_registration.py:88-97``).
    """
    if border == "reflect":
        return bilinear_sample_reflect(f, map_x, map_y)
    if border == "wrap":
        return bilinear_sample_periodic(f, map_x, map_y)
    raise ValueError(f"unknown border mode: {border}")


def warp_flow(f: Array, flow_x: Array, flow_y: Array, *, border: str = "reflect") -> Array:
    """Warp by a dense backward flow: out(p) = f(p + flow(p))."""
    H, W = f.shape[-2], f.shape[-1]
    dtype = flow_x.dtype
    r = jnp.arange(H, dtype=dtype)[:, None]
    c = jnp.arange(W, dtype=dtype)[None, :]
    if (
        border == "reflect"
        and flow_x.ndim == 2
        and _warp_impl_default() == "packed"
    ):
        # packed path needs UNBATCHED coords (shared across any leading
        # channel axes of f) — every warp_flow callsite passes (H, W) flows
        return bilinear_sample_reflect_packed(f, r + flow_x, c + flow_y)
    return remap_bilinear(f, r + flow_x, c + flow_y, border=border)


@partial(jax.jit, static_argnames=("out_h", "out_w"))
def resize_area(f: Array, out_h: int, out_w: int) -> Array:
    """cv2.INTER_AREA-style resize for shrinking (exact for integer factors:
    plain block mean; fractional factors use exact pixel-coverage weights).

    Parity: ``cv2.resize(img, None, fx=0.5, fy=0.5, INTER_AREA)``
    (``analyze_results.py:213``).
    """
    H, W = f.shape[-2], f.shape[-1]
    # integer (u8/u16) frames are supported directly: the block mean below
    # promotes to f32 (exact — block sums of small ints are representable),
    # and the coverage-weight path computes in f32. Callers ship RAW camera
    # bytes to the device and let this first program do the float cast.
    if not jnp.issubdtype(f.dtype, jnp.floating):
        wdtype = jnp.float32
    else:
        wdtype = f.dtype
    if H % out_h == 0 and W % out_w == 0:
        bh, bw = H // out_h, W // out_w
        g = f.reshape(f.shape[:-2] + (out_h, bh, out_w, bw))
        return g.astype(wdtype).mean(axis=(-3, -1))
    # general coverage-weighted average along each axis separately
    def axis_weights(n_in: int, n_out: int) -> jnp.ndarray:
        scale = n_in / n_out
        Wm = jnp.zeros((n_out, n_in))
        import numpy as _np

        Wnp = _np.zeros((n_out, n_in))
        for o in range(n_out):
            a, b = o * scale, (o + 1) * scale
            i0, i1 = int(_np.floor(a)), int(_np.ceil(b))
            for i in range(i0, min(i1, n_in)):
                cov = min(b, i + 1) - max(a, i)
                if cov > 0:
                    Wnp[o, i] = cov / scale
        return jnp.asarray(Wnp, dtype=wdtype)

    Wh = axis_weights(H, out_h)
    Ww = axis_weights(W, out_w)
    out = jnp.einsum("oh,...hw->...ow", Wh, f.astype(wdtype))
    return jnp.einsum("pw,...ow->...op", Ww, out)


@partial(jax.jit, static_argnames=("out_h", "out_w"))
def resize_bilinear(f: Array, out_h: int, out_w: int) -> Array:
    """cv2.INTER_LINEAR resize semantics (half-pixel centers, edge clamp; jitted).

    The sampling grid is separable (row coord depends on row only), so the
    bilinear weights factor exactly into two 1-D interpolation matrices; on
    accelerators the resize runs as two small matmuls instead of four 2-D
    gathers (see use_banded_sep).
    """
    H, W = f.shape[-2], f.shape[-1]
    dtype = jnp.result_type(f.dtype, jnp.float32)
    if use_banded_sep():
        Mh = jnp.asarray(resize_matrix(H, out_h), dtype)
        Mw = jnp.asarray(resize_matrix(W, out_w), dtype)
        out = jnp.einsum("hp,...pw->...hw", Mh, f.astype(dtype), precision=_SEP_PREC)
        return jnp.einsum("wv,...hv->...hw", Mw, out, precision=_SEP_PREC)
    sx = H / out_h
    sy = W / out_w
    x = (jnp.arange(out_h, dtype=dtype) + 0.5) * sx - 0.5
    y = (jnp.arange(out_w, dtype=dtype) + 0.5) * sy - 0.5
    x = jnp.clip(x, 0.0, H - 1.0)[:, None] * jnp.ones((1, out_w), dtype=dtype)
    y = jnp.clip(y, 0.0, W - 1.0)[None, :] * jnp.ones((out_h, 1), dtype=dtype)
    return bilinear_sample_reflect(f, x, y)
