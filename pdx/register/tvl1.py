"""TV-L1 optical flow (Zach, Pock & Bischof 2007) — pure JAX.

Device equivalent of cv2.optflow.DualTVL1OpticalFlow, the notebook-only
third flow backend of the reference (notebook 02 cell 10,
``compute_optical_flow(method='tvl1')``).

Primal-dual scheme per pyramid level: repeated warps linearize the data term
rho(u) = I1(x + u0) + (u - u0)·grad I1 - I0; a pointwise thresholding step
solves the L1 data term; a Chambolle dual ascent handles the TV
regularization. All updates are elementwise on (H, W) fields — pure VPU work
under fixed trip-count loops.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.interp import bilinear_sample_reflect, resize_bilinear


def _grad(f: Array) -> tuple[Array, Array]:
    """Forward differences with zero at the far edge (standard TV grid)."""
    gx = jnp.concatenate([f[1:] - f[:-1], jnp.zeros_like(f[:1])], axis=0)
    gy = jnp.concatenate([f[:, 1:] - f[:, :-1], jnp.zeros_like(f[:, :1])], axis=1)
    return gx, gy


def _div(px: Array, py: Array) -> Array:
    """Adjoint of _grad (backward differences)."""
    dx = jnp.concatenate([px[:1], px[1:-1] - px[:-2], -px[-2:-1]], axis=0)
    dy = jnp.concatenate([py[:, :1], py[:, 1:-1] - py[:, :-2], -py[:, -2:-1]], axis=1)
    return dx + dy


def _tvl1_level(
    I0: Array,
    I1: Array,
    u: Array,
    v: Array,
    *,
    lam: float,
    theta: float,
    tau: float,
    warps: int,
    inner_iters: int,
):
    H, W = I0.shape
    dtype = I0.dtype
    r = jnp.arange(H, dtype=dtype)[:, None] * jnp.ones((1, W), dtype)
    c = jnp.arange(W, dtype=dtype)[None, :] * jnp.ones((H, 1), dtype)
    I1r, I1c = jnp.gradient(I1)

    def warp_step(state, _):
        u, v, p11, p12, p21, p22 = state
        u0, v0 = u, v
        xr = r + u0
        xc = c + v0
        I1w = bilinear_sample_reflect(I1, xr, xc)
        Ix = bilinear_sample_reflect(I1r, xr, xc)  # d/d(row)
        Iy = bilinear_sample_reflect(I1c, xr, xc)  # d/d(col)
        grad2 = Ix * Ix + Iy * Iy + 1e-8
        rho_c = I1w - Ix * u0 - Iy * v0 - I0

        def inner(state, _):
            u, v, p11, p12, p21, p22 = state
            rho = rho_c + Ix * u + Iy * v
            lt = lam * theta * grad2
            du = jnp.where(
                rho < -lt, lam * theta * Ix,
                jnp.where(rho > lt, -lam * theta * Ix, -rho * Ix / grad2),
            )
            dv = jnp.where(
                rho < -lt, lam * theta * Iy,
                jnp.where(rho > lt, -lam * theta * Iy, -rho * Iy / grad2),
            )
            u_data = u + du
            v_data = v + dv
            # Chambolle dual ascent on TV(u), TV(v)
            u_reg = u_data + theta * _div(p11, p12)
            gx, gy = _grad(u_reg)
            denom = 1.0 + (tau / theta) * jnp.sqrt(gx * gx + gy * gy)
            p11 = (p11 + (tau / theta) * gx) / denom
            p12 = (p12 + (tau / theta) * gy) / denom
            v_reg = v_data + theta * _div(p21, p22)
            gx, gy = _grad(v_reg)
            denom = 1.0 + (tau / theta) * jnp.sqrt(gx * gx + gy * gy)
            p21 = (p21 + (tau / theta) * gx) / denom
            p22 = (p22 + (tau / theta) * gy) / denom
            u = u_data + theta * _div(p11, p12)
            v = v_data + theta * _div(p21, p22)
            return (u, v, p11, p12, p21, p22), None

        state, _ = jax.lax.scan(inner, (u, v, p11, p12, p21, p22), None, length=inner_iters)
        return state, None

    zeros = jnp.zeros_like(I0)
    state = (u, v, zeros, zeros, zeros, zeros)
    state, _ = jax.lax.scan(warp_step, state, None, length=warps)
    return state[0], state[1]


@partial(jax.jit, static_argnames=("levels", "lam", "theta", "tau", "warps", "inner_iters", "min_size"))
def tvl1_flow(
    img1: Array,
    img2: Array,
    *,
    levels: int = 5,
    lam: float = 0.15,
    theta: float = 0.3,
    tau: float = 0.25,
    warps: int = 5,
    inner_iters: int = 30,
    min_size: int = 16,
) -> tuple[Array, Array]:
    """Dense flow (flow_r, flow_c): img1(x) ~ img2(x + flow(x)).

    Defaults mirror cv2.DualTVL1OpticalFlow_create.
    """
    H, W = img1.shape[-2], img1.shape[-1]
    shapes = [(H, W)]
    for _ in range(1, levels):
        h2, w2 = shapes[-1][0] // 2, shapes[-1][1] // 2
        if min(h2, w2) < min_size:
            break
        shapes.append((h2, w2))

    u = jnp.zeros(shapes[-1], img1.dtype)
    v = jnp.zeros(shapes[-1], img1.dtype)
    for shp in reversed(shapes):
        i1 = resize_bilinear(img1, shp[0], shp[1]) if shp != (H, W) else img1
        i2 = resize_bilinear(img2, shp[0], shp[1]) if shp != (H, W) else img2
        if (u.shape[-2], u.shape[-1]) != shp:
            u = resize_bilinear(u, shp[0], shp[1]) * (shp[0] / u.shape[-2])
            v = resize_bilinear(v, shp[0], shp[1]) * (shp[1] / v.shape[-1])
        u, v = _tvl1_level(
            i1, i2, u, v, lam=lam, theta=theta, tau=tau, warps=warps, inner_iters=inner_iters
        )
    return u, v
