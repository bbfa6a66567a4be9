"""Dense Inverse Search (DIS) optical flow — pure JAX.

Device replacement for cv2.DISOpticalFlow (PRESET_MEDIUM) as used by
``register_dis_improved`` (pde_discovery_improved_registration.py:107-145).

Algorithm (Kroeger et al., "Fast Optical Flow using Dense Inverse Search",
ECCV 2016, simplified):

  1. Coarse-to-fine pyramid (factor 2).
  2. At each level, a regular grid of patches; each patch estimates a
     translation by inverse-compositional Lucas-Kanade: the ref patch's
     gradient Hessian is fixed, so every iteration is one gather + one 2-vec
     solve. All patches run as one vmapped batch.
  3. Densification: each pixel averages the displacements of the patches
     covering it, weighted by inverse patch residual.

The per-patch LK and densification are batched tensor ops — no Python loop
over patches.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.interp import bilinear_sample_reflect, resize_bilinear


def _patch_grid_coords(H: int, W: int, psize: int, stride: int) -> np.ndarray:
    ys = np.arange(0, max(H - psize, 0) + 1, stride)
    xs = np.arange(0, max(W - psize, 0) + 1, stride)
    YY, XX = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([YY.ravel(), XX.ravel()], axis=1)  # (P, 2) top-left


def _level_flow(ref: Array, mov: Array, init_fx: Array, init_fy: Array, psize: int, stride: int, iters: int):
    H, W = ref.shape
    dtype = ref.dtype
    coords = jnp.asarray(_patch_grid_coords(H, W, psize, stride))  # (P, 2)
    P = coords.shape[0]

    dy, dx_ = jnp.gradient(ref)  # row grad, col grad

    offs = jnp.arange(psize)
    pr = coords[:, 0:1] + offs[None, :]  # (P, psize)
    pc = coords[:, 1:2] + offs[None, :]

    def gather_patches(img):
        return img[pr[:, :, None], pc[:, None, :]]  # (P, psize, psize)

    T = gather_patches(ref)
    Gr = gather_patches(dy)
    Gc = gather_patches(dx_)
    # inverse-compositional Hessian per patch (fixed), Tikhonov-damped: flat
    # (low-gradient) patches otherwise amplify noise into spurious flow —
    # observed as negative "registration improvement" on near-static frames
    h11 = jnp.sum(Gr * Gr, axis=(1, 2))
    h12 = jnp.sum(Gr * Gc, axis=(1, 2))
    h22 = jnp.sum(Gc * Gc, axis=(1, 2))
    damp = 0.05 * jnp.mean(h11 + h22) + 1e-8
    h11 = h11 + damp
    h22 = h22 + damp
    det = h11 * h22 - h12 * h12 + 1e-8

    # init per-patch displacement from the upscaled flow at patch centers
    cy = coords[:, 0] + psize // 2
    cx = coords[:, 1] + psize // 2
    u0 = init_fx[cy, cx]
    v0 = init_fy[cy, cx]

    base_r = pr[:, :, None].astype(dtype) * jnp.ones((1, 1, psize), dtype)
    base_c = pc[:, None, :].astype(dtype) * jnp.ones((1, psize, 1), dtype)

    def lk_iter(state, _):
        u, v = state
        Iw = bilinear_sample_reflect(mov, base_r + u[:, None, None], base_c + v[:, None, None])
        r = Iw - T
        g1 = jnp.sum(Gr * r, axis=(1, 2))
        g2 = jnp.sum(Gc * r, axis=(1, 2))
        du = (h22 * g1 - h12 * g2) / det
        dv = (h11 * g2 - h12 * g1) / det
        return (u - du, v - dv), None

    (u, v), _ = jax.lax.scan(lk_iter, (u0, v0), None, length=iters)

    # residual-based weights for densification
    Iw = bilinear_sample_reflect(mov, base_r + u[:, None, None], base_c + v[:, None, None])
    resid = jnp.mean(jnp.abs(Iw - T), axis=(1, 2))
    wgt = 1.0 / (resid + 1e-3)

    # densify: scatter-add patch displacement into per-pixel accumulators
    acc_u = jnp.zeros((H, W), dtype)
    acc_v = jnp.zeros((H, W), dtype)
    acc_w = jnp.zeros((H, W), dtype)
    wu = (wgt * u)[:, None, None] * jnp.ones((1, psize, psize), dtype)
    wv = (wgt * v)[:, None, None] * jnp.ones((1, psize, psize), dtype)
    ww = wgt[:, None, None] * jnp.ones((1, psize, psize), dtype)
    idx_r = pr[:, :, None] * jnp.ones((1, 1, psize), jnp.int32)
    idx_c = pc[:, None, :] * jnp.ones((1, psize, 1), jnp.int32)
    acc_u = acc_u.at[idx_r, idx_c].add(wu)
    acc_v = acc_v.at[idx_r, idx_c].add(wv)
    acc_w = acc_w.at[idx_r, idx_c].add(ww)
    fx = acc_u / (acc_w + 1e-12)
    fy = acc_v / (acc_w + 1e-12)
    # pixels not covered by any patch (right/bottom margin) fall back to init
    covered = acc_w > 0
    fx = jnp.where(covered, fx, init_fx)
    fy = jnp.where(covered, fy, init_fy)
    return fx, fy


def dis_flow(
    img1: Array,
    img2: Array,
    *,
    levels: int = 4,
    patch_size: int = 8,
    stride: int = 4,
    iterations: int = 8,
    min_size: int = 16,
) -> tuple[Array, Array]:
    """Dense flow (flow_r, flow_c): img1(x) ~ img2(x + flow(x)).

    Parameter defaults approximate cv2.DISOpticalFlow PRESET_MEDIUM (8x8
    patches, stride 4 at finest scale).
    """
    H, W = img1.shape[-2], img1.shape[-1]
    dtype = img1.dtype
    shapes = [(H, W)]
    for _ in range(1, levels):
        h2, w2 = shapes[-1][0] // 2, shapes[-1][1] // 2
        if min(h2, w2) < min_size:
            break
        shapes.append((h2, w2))

    fx = jnp.zeros(shapes[-1], dtype)
    fy = jnp.zeros(shapes[-1], dtype)
    for li, shp in enumerate(reversed(shapes)):
        i1 = resize_bilinear(img1, shp[0], shp[1]) if shp != (H, W) else img1
        i2 = resize_bilinear(img2, shp[0], shp[1]) if shp != (H, W) else img2
        if (fx.shape[-2], fx.shape[-1]) != shp:
            sr = shp[0] / fx.shape[-2]
            sc = shp[1] / fx.shape[-1]
            fx = resize_bilinear(fx, shp[0], shp[1]) * sr
            fy = resize_bilinear(fy, shp[0], shp[1]) * sc
        ps = min(patch_size, min(shp) // 2)
        st = max(1, min(stride, ps // 2))
        fx, fy = _level_flow(i1, i2, fx, fy, ps, st, iterations)
    return fx, fy
