"""ECC (Enhanced Correlation Coefficient) parametric registration — pure JAX.

Device replacement for cv2.findTransformECC with MOTION_EUCLIDEAN /
MOTION_TRANSLATION as used by the per-patch registration in
``patch_based_sindy.py:171-196``.

Algorithm (Evangelidis & Psarakis, "Parametric image alignment using enhanced
correlation coefficient maximization", TPAMI 2008 — the scheme OpenCV
implements): iteratively maximize the correlation coefficient between the
zero-mean template and the warped image. Each iteration builds the steepest
descent images G = grad(Iw) * dW/dp, projects, and applies the ECC update

  lambda = (||iw||^2 - iw^T PG iw) / (ir^T iw - ir^T PG iw)
  e      = lambda * ir - iw
  dp     = (G^T G)^{-1} G^T e

with ir/iw the zero-mean template/warped images and PG the projector onto the
span of G. Runs as a bounded lax.while_loop (max_iter, eps) — one fused XLA
program, vmappable over a batch of patch sequences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.interp import bilinear_sample_reflect


def _euclidean_warp_coords(params: Array, H: int, W: int, dtype):
    """params = (theta, t_row, t_col): x' = R x + t (row/col convention)."""
    th, tr, tc = params[0], params[1], params[2]
    r = jnp.arange(H, dtype=dtype)[:, None] * jnp.ones((1, W), dtype)
    c = jnp.arange(W, dtype=dtype)[None, :] * jnp.ones((H, 1), dtype)
    cos, sin = jnp.cos(th), jnp.sin(th)
    xr = cos * r - sin * c + tr
    xc = sin * r + cos * c + tc
    return r, c, xr, xc, cos, sin


def ecc_align(
    template: Array,
    image: Array,
    *,
    motion: str = "euclidean",  # euclidean | translation
    max_iter: int = 200,
    eps: float = 1e-6,
    gauss_sigma: float = 0.0,
) -> tuple[Array, Array]:
    """Estimate warp params aligning ``image`` to ``template``.

    Returns (params, cc): for euclidean, params = (theta, t_row, t_col) such
    that template(x) ~ image(R x + t); cc is the final correlation
    coefficient. Apply the warp with :func:`ecc_warp`.
    """
    H, W = template.shape
    dtype = template.dtype
    if gauss_sigma > 0:
        from pdx.ops.filters import gaussian_filter_reflect

        template = gaussian_filter_reflect(template, gauss_sigma)
        image = gaussian_filter_reflect(image, gauss_sigma)

    ir = template - jnp.mean(template)
    ir_norm2 = jnp.sum(ir * ir)
    n_params = 3 if motion == "euclidean" else 2

    gy_full, gx_full = jnp.gradient(image)  # row grad, col grad

    def body(state):
        params, _cc, it, _done = state
        if motion == "euclidean":
            p3 = params
        else:
            p3 = jnp.concatenate([jnp.zeros((1,), dtype), params])
        r, c, xr, xc, cos, sin = _euclidean_warp_coords(p3, H, W, dtype)
        Iw = bilinear_sample_reflect(image, xr, xc)
        Gr = bilinear_sample_reflect(gy_full, xr, xc)
        Gc = bilinear_sample_reflect(gx_full, xr, xc)

        # steepest-descent images for each parameter
        if motion == "euclidean":
            # d(xr)/dth = -sin*r - cos*c ; d(xc)/dth = cos*r - sin*c
            g_th = Gr * (-sin * r - cos * c) + Gc * (cos * r - sin * c)
            Gs = jnp.stack([g_th, Gr, Gc], axis=0)  # (3, H, W)
        else:
            Gs = jnp.stack([Gr, Gc], axis=0)

        iw = Iw - jnp.mean(Iw)
        Gf = Gs.reshape(n_params, -1)
        GtG = Gf @ Gf.T
        Gt_iw = Gf @ iw.reshape(-1)
        Gt_ir = Gf @ ir.reshape(-1)
        GtG_inv = jnp.linalg.inv(GtG + 1e-10 * jnp.eye(n_params, dtype=dtype))

        iw_norm2 = jnp.sum(iw * iw)
        num = iw_norm2 - Gt_iw @ GtG_inv @ Gt_iw
        den = jnp.sum(ir * iw) - Gt_ir @ GtG_inv @ Gt_iw
        lam = num / jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)
        e = lam * ir - iw
        dp = GtG_inv @ (Gf @ e.reshape(-1))
        new_params = params + dp

        cc = jnp.sum(ir * iw) / (jnp.sqrt(ir_norm2 * iw_norm2) + 1e-12)
        done = jnp.max(jnp.abs(dp)) < eps
        return new_params, cc, it + 1, done

    def cond(state):
        _p, _cc, it, done = state
        return (it < max_iter) & (~done)

    p0 = jnp.zeros((n_params,), dtype)
    params, cc, _, _ = jax.lax.while_loop(cond, body, (p0, jnp.asarray(0.0, dtype), 0, jnp.asarray(False)))
    return params, cc


def ecc_warp(image: Array, params: Array, motion: str = "euclidean") -> Array:
    """Warp ``image`` by the estimated params so it aligns to the template:
    out(x) = image(R x + t)."""
    H, W = image.shape[-2], image.shape[-1]
    dtype = image.dtype
    if motion != "euclidean":
        params = jnp.concatenate([jnp.zeros((1,), dtype), params])
    _r, _c, xr, xc, _cos, _sin = _euclidean_warp_coords(params, H, W, dtype)
    return bilinear_sample_reflect(image, xr, xc)


def ecc_register_sequence(
    U: Array,
    *,
    motion: str = "euclidean",
    max_iter: int = 200,
    eps: float = 1e-6,
    gauss_sigma: float = 0.0,
    cc_threshold: float = 0.1,
) -> tuple[Array, Array]:
    """Sequential warp-to-previous ECC registration of a patch sequence.

    Parity: patch_based_sindy.py:171-196 (warp-to-previous-registered,
    quality = mean correlation coefficient). Returns (registered, qualities).

    Divergence guard: the reference keeps the unregistered patch when
    ``cv2.findTransformECC`` raises (patch_based_sindy.py:193-196). The LM
    iteration here cannot raise, so the equivalent fallback is explicit: when
    the final correlation coefficient is below ``cc_threshold`` or the
    estimated params are non-finite, the frame passes through unwarped
    (identity) and its cc is reported as-is (low cc already down-weights the
    patch in quality-weighted aggregation).
    """

    def step(ref, mov):
        params, cc = ecc_align(ref, mov, motion=motion, max_iter=max_iter, eps=eps, gauss_sigma=gauss_sigma)
        ok = (cc >= cc_threshold) & jnp.all(jnp.isfinite(params))
        out = jnp.where(ok, ecc_warp(mov, params, motion=motion), mov)
        return out, (out, cc)

    _, (out, ccs) = jax.lax.scan(step, U[0], U[1:])
    return jnp.concatenate([U[:1], out], axis=0), ccs
