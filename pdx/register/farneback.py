"""Dense optical flow via polynomial expansion (Farnebäck 2003) — pure JAX.

Device replacement for cv2.calcOpticalFlowFarneback as used by the
reference registration stack (analyze_results.py:234,
patch_based_pde_discovery.py:133-144, transport_pde_discovery.py:68-78,
pde_discovery_improved_registration.py:60-104).

Algorithm (Farnebäck, "Two-frame motion estimation based on polynomial
expansion", SCIA 2003 — the same scheme OpenCV implements):

  1. Each image is locally approximated by a quadratic polynomial
     f(x + d) ~ c + b^T d + d^T A d via Gaussian-weighted least squares over a
     (2n+1)^2 window — "polynomial expansion". The normal matrix G is
     constant across pixels, so the expansion is 6 separable correlations +
     one constant 6x6 solve folded into the kernels.
  2. Given expansions (A1, b1) of frame 1 at x and (A2, b2) of frame 2 at
     x + d(x) (current flow), the displacement satisfies
         A d = db,   A = (A1 + A2)/2,   db = -0.5 (b2 - b1) + A d
     The 2x2 systems are aggregated over a window (Gaussian or box blur of
     the 5 unique entries of [A^T A | A^T db]) and solved per pixel.
  3. Coarse-to-fine pyramid (factor pyr_scale) with flow upscaling, a fixed
     number of refinement iterations per level.

All stages are batched convolutions/gathers — one fused XLA program per
(level, iteration) pair; frames can additionally be vmapped for sequences.

Exact bit-parity with OpenCV is not possible (OpenCV uses fixed-point
interpolation internals); tests validate against cv2 on synthetic
translations (sub-0.1 px agreement) and on registration-quality metrics.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.interp import (
    _SEP_PREC,
    band_matrix,
    bilinear_sample_reflect,
    bilinear_sample_reflect_cbatch,
    bilinear_sample_reflect_cbatch_packed,
    bilinear_sample_reflect_packed,
    resize_bilinear,
    use_banded_sep,
    use_packed_fetch,
    warp_flow,
    warp_flow_batch,
)


def _poly_exp_kernels(n: int, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Precompute the separable correlation kernels for polynomial expansion.

    Returns (kernels_x[(6, 2n+1)], kernels_y[(6, 2n+1)]) such that
    coefs_k = sum_o K_x[k](ox) K_y[k](oy) ... folded with invG — see below.
    We instead return the raw monomial-weighted kernels and invG separately.
    """
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g /= g.sum()
    # basis monomials: 1, x, y, x^2, y^2, xy  evaluated on the window
    # separable: each monomial = mx(ox) * my(oy)
    # weighted correlations v_k = sum W f B_k, W = g(ox) g(oy)
    return g, x


def _poly_exp(f: Array, g: Array, x: Array, invG: Array, n: int) -> tuple[Array, Array, Array, Array, Array]:
    """Polynomial expansion of f (..., H, W) -> (c, bx, by, axx, ayy, axy).

    b is the gradient vector, A the quadratic form: f ~ c + b.d + d^T A d with
    d = (dx, dy) in (row, col) order.
    """
    gx = g * x
    gxx = g * x * x
    taps = 2 * n + 1
    H, W = f.shape[-2], f.shape[-1]

    if use_banded_sep():
        # banded path: each axis pass is ONE banded matmul (kernel + symmetric
        # padding folded into an (L, L) matrix — interp.band_matrix). The
        # row pass never materializes the 3x-stacked operand; reads f once.
        gn = np.asarray(g, np.float64)
        xn = np.asarray(x, np.float64)
        row_k = [gn, gn * xn, gn * xn * xn]
        Mr = np.stack([band_matrix(tuple(k), H) for k in row_k])  # (3, H, H)
        R = jnp.einsum("chp,...pw->...chw", jnp.asarray(Mr, f.dtype), f, precision=_SEP_PREC)
        sel = jnp.asarray([0, 1, 0, 2, 0, 1])
        col_k = [gn, gn, gn * xn, gn, gn * xn * xn, gn * xn]
        Mc = np.stack([band_matrix(tuple(k), W) for k in col_k])  # (6, W, W)
        S = jnp.take(R, sel, axis=-3)  # (..., 6, H, W)
        v = jnp.einsum("kwv,...khv->...khw", jnp.asarray(Mc, f.dtype), S, precision=_SEP_PREC)
    else:
        # CPU path: batched shifted-add separable passes — one 3-channel row
        # pass {g, gx, gxx} feeding one 6-channel col pass, 2 sweeps total
        # instead of 12 per-moment sweeps.
        Kr = jnp.stack([g, gx, gxx], axis=0)  # (3, taps)
        fr = jnp.stack([f, f, f], axis=-3)  # (..., 3, H, W)
        pad = [(0, 0)] * (fr.ndim - 2) + [(n, n), (0, 0)]
        p = jnp.pad(fr, pad, mode="symmetric")
        R = jnp.zeros_like(fr)
        for i in range(taps):
            R = R + Kr[:, i][:, None, None] * p[..., i : i + H, :]

        # moments in basis order [1, dr, dc, dr^2, dc^2, dr*dc]:
        # (row kernel, col kernel) = (g,g) (gx,g) (g,gx) (gxx,g) (g,gxx) (gx,gx)
        sel = jnp.asarray([0, 1, 0, 2, 0, 1])
        Kc = jnp.stack([g, g, gx, g, gxx, gx], axis=0)  # (6, taps)
        S = jnp.take(R, sel, axis=-3)  # (..., 6, H, W)
        pad = [(0, 0)] * (S.ndim - 2) + [(0, 0), (n, n)]
        p = jnp.pad(S, pad, mode="symmetric")
        v = jnp.zeros_like(S)
        for i in range(taps):
            v = v + Kc[:, i][:, None, None] * p[..., :, i : i + W]

    coef = jnp.einsum("kj,...jhw->...khw", invG, v)
    c = coef[..., 0, :, :]
    bx = coef[..., 1, :, :]  # d/d(row)
    by = coef[..., 2, :, :]  # d/d(col)
    axx = coef[..., 3, :, :]
    ayy = coef[..., 4, :, :]
    axy = coef[..., 5, :, :]
    return c, bx, by, axx, ayy, axy


def _make_invG(n: int, sigma: float, dtype) -> tuple[np.ndarray, np.ndarray, jnp.ndarray]:
    """g/x stay HOST-side numpy: _poly_exp folds them into banded matrices
    at trace time, with no device round-trip."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g1 = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g1 /= g1.sum()
    OX, OY = np.meshgrid(x, x, indexing="ij")
    W = np.outer(g1, g1)
    B = np.stack(
        [np.ones_like(OX), OX, OY, OX**2, OY**2, OX * OY], axis=-1
    ).reshape(-1, 6)
    Wf = W.reshape(-1)
    G = (B * Wf[:, None]).T @ B
    invG = np.linalg.inv(G)
    return (
        np.asarray(g1, dtype=dtype),
        np.asarray(x, dtype=dtype),
        jnp.asarray(invG, dtype=dtype),
    )


def _blur(f: Array, ksize: int, sigma: float, gaussian: bool) -> Array:
    """winsize aggregation blur: Gaussian (OPTFLOW_FARNEBACK_GAUSSIAN) or box."""
    n = ksize // 2
    if gaussian:
        x = np.arange(-n, n + 1, dtype=np.float64)
        k = np.exp(-(x**2) / (2.0 * sigma * sigma))
        k /= k.sum()
    else:
        k = np.full(2 * n + 1, 1.0 / (2 * n + 1))
    if use_banded_sep():
        H, W = f.shape[-2], f.shape[-1]
        kt = tuple(np.asarray(k, np.float64))
        Mh = jnp.asarray(band_matrix(kt, H), f.dtype)
        Mw = jnp.asarray(band_matrix(kt, W), f.dtype)
        out = jnp.einsum("hp,...pw->...hw", Mh, f, precision=_SEP_PREC)
        return jnp.einsum("wv,...hv->...hw", Mw, out, precision=_SEP_PREC)

    k = jnp.asarray(k, dtype=f.dtype)

    def conv_axis(img, axis):
        pads = [(0, 0)] * img.ndim
        pads[axis] = (n, n)
        p = jnp.pad(img, pads, mode="symmetric")
        p = jnp.moveaxis(p, axis, -1)
        L = p.shape[-1] - 2 * n
        out = jnp.zeros(p.shape[:-1] + (L,), dtype=img.dtype)
        for i in range(2 * n + 1):
            out = out + k[i] * p[..., i : i + L]
        return jnp.moveaxis(out, -1, axis)

    return conv_axis(conv_axis(f, f.ndim - 2), f.ndim - 1)


def _flow_iteration(exp1, exp2, flow, winsize, gaussian_win, batched=False):
    """One Farnebäck displacement-update iteration at a fixed level.

    ``batched=True``: all fields carry a leading batch axis (independent
    frame pairs, e.g. a patch grid) and the expansion fetch runs as a
    channel-last row-take gather (``bilinear_sample_reflect_cbatch``) — the
    vmap-style gather with batching dimensions lowered 100-400x slower on
    the accelerator this was first tuned for (inherited tuning, not yet
    measured on the H100).
    """
    _c1, b1x, b1y, a1xx, a1yy, a1xy = exp1
    _c2, b2x, b2y, a2xx, a2yy, a2xy = exp2
    H, W = b1x.shape[-2], b1x.shape[-1]
    dtype = b1x.dtype
    r = jnp.arange(H, dtype=dtype)[:, None] * jnp.ones((1, W), dtype)
    c = jnp.arange(W, dtype=dtype)[None, :] * jnp.ones((H, 1), dtype)
    fx, fy = flow
    xr = r + fx
    xc = c + fy

    # ONE batched gather for the five expansion-fetch fields: where this was
    # tuned, gather cost was index-arithmetic-bound and one (5, H, W) fetch
    # cost about a fifth of five separate ones (inherited tuning, not yet
    # measured on the H100). The packed variant goes further: fold the
    # COORDINATES (exact reflect-101 identity) so one index per pixel
    # fetches the whole contiguous (2x2, 5) corner block — 4x fewer indices
    # again (interp.use_packed_fetch policy).
    if batched:
        # channel-FIRST stack (5, B, H, W): the sampler transposes it
        # channel-LAST internally so each pixel index fetches one contiguous
        # block — the fastest batched formulation where it was first tuned
        # (interp.py notes; not yet measured on the H100)
        stack5 = jnp.stack([a2xx, a2yy, a2xy, b2x, b2y], axis=0)
        sampler = (
            bilinear_sample_reflect_cbatch_packed
            if use_packed_fetch()
            else bilinear_sample_reflect_cbatch
        )
        f_axx, f_ayy, f_axy, f_b2x, f_b2y = sampler(stack5, xr, xc)
    elif use_packed_fetch() and b1x.ndim == 2:
        stack5 = jnp.stack([a2xx, a2yy, a2xy, b2x, b2y], axis=0)
        f_axx, f_ayy, f_axy, f_b2x, f_b2y = bilinear_sample_reflect_packed(
            stack5, xr, xc
        )
    else:
        stack5 = jnp.stack([a2xx, a2yy, a2xy, b2x, b2y], axis=-3)
        f_axx, f_ayy, f_axy, f_b2x, f_b2y = bilinear_sample_reflect(stack5, xr, xc)
    A_xx = 0.5 * (a1xx + f_axx)
    A_yy = 0.5 * (a1yy + f_ayy)
    A_xy = 0.5 * (a1xy + f_axy)
    # A as 2x2: [[A_xx, A_xy/2], [A_xy/2, A_yy]]
    db_x = -0.5 * (f_b2x - b1x) + (A_xx * fx + 0.5 * A_xy * fy)
    db_y = -0.5 * (f_b2y - b1y) + (0.5 * A_xy * fx + A_yy * fy)

    # aggregate the normal equations over the window
    a11 = A_xx * A_xx + 0.25 * A_xy * A_xy
    a12 = 0.5 * A_xy * (A_xx + A_yy)
    a22 = A_yy * A_yy + 0.25 * A_xy * A_xy
    h1 = A_xx * db_x + 0.5 * A_xy * db_y
    h2 = 0.5 * A_xy * db_x + A_yy * db_y

    sigma_win = winsize * 0.3
    stack = jnp.stack([a11, a12, a22, h1, h2], axis=0)
    a11, a12, a22, h1, h2 = _blur(stack, winsize, sigma_win, gaussian_win)

    det = a11 * a22 - a12 * a12 + 1e-12
    new_fx = (a22 * h1 - a12 * h2) / det
    new_fy = (a11 * h2 - a12 * h1) / det
    return new_fx, new_fy


@partial(
    jax.jit,
    static_argnames=(
        "pyr_scale",
        "levels",
        "winsize",
        "iterations",
        "poly_n",
        "poly_sigma",
        "gaussian_win",
        "refine",
        "batched",
    ),
)
def farneback_flow(
    img1: Array,
    img2: Array,
    *,
    pyr_scale: float = 0.5,
    levels: int = 5,
    winsize: int = 25,
    iterations: int = 5,
    poly_n: int = 7,
    poly_sigma: float = 1.5,
    gaussian_win: bool = True,
    refine: int = 2,
    batched: bool = False,
) -> tuple[Array, Array]:
    """Dense flow (flow_r, flow_c) such that img2(x + flow(x)) ~ img1(x).

    Defaults mirror the reference's "improved" parameters
    (pde_discovery_improved_registration.py:66-79 / analyze_results.py:234).
    Sign convention matches cv2.calcOpticalFlowFarneback(prev=img1, next=img2):
    the flow maps points of img1 to img2.

    ``refine``: extra re-warp refinement passes after the pyramid. The
    classical expansion-fetch update converges to a biased fixed point
    (~0.8x magnitude on translations; cv2 shows the same behavior at
    ~0.9x). Re-expanding the *warped* second image resets the
    linearization around a small residual displacement, where the quadratic
    model is accurate — measured to lift translation recovery to ~0.98x.
    Set refine=0 for strict cv2-equivalent behavior.
    """
    H, W = img1.shape[-2], img1.shape[-1]
    dtype = img1.dtype
    n = poly_n // 2
    g1, x1, invG = _make_invG(n, poly_sigma, dtype)

    # pyramid shapes (coarsest last)
    shapes = [(H, W)]
    for _ in range(1, levels):
        h2, w2 = shapes[-1]
        h2, w2 = max(int(round(h2 * pyr_scale)), 8), max(int(round(w2 * pyr_scale)), 8)
        if (h2, w2) == shapes[-1]:
            break
        shapes.append((h2, w2))

    def to_shape(img, shp):
        if (img.shape[-2], img.shape[-1]) == shp:
            return img
        return resize_bilinear(img, shp[0], shp[1])

    flow = None
    lead = img1.shape[:-2]  # () unbatched, (B,) batched
    for shp in reversed(shapes):
        i1 = to_shape(img1, shp)
        i2 = to_shape(img2, shp)
        # light presmoothing stabilizes the expansion at coarse levels
        exp1 = _poly_exp(i1, g1, x1, invG, n)
        exp2 = _poly_exp(i2, g1, x1, invG, n)
        if flow is None:
            fx = jnp.zeros(lead + shp, dtype=dtype)
            fy = jnp.zeros(lead + shp, dtype=dtype)
        else:
            scale_r = shp[0] / flow[0].shape[-2]
            scale_c = shp[1] / flow[0].shape[-1]
            fx = resize_bilinear(flow[0], shp[0], shp[1]) * scale_r
            fy = resize_bilinear(flow[1], shp[0], shp[1]) * scale_c
        for _ in range(iterations):
            fx, fy = _flow_iteration(exp1, exp2, (fx, fy), winsize, gaussian_win, batched)
        flow = (fx, fy)

    # re-warp refinement at full resolution; exp1 is reused from the
    # pyramid's finest level (i1 there IS img1 — same expansion)
    fx, fy = flow
    for _ in range(int(refine)):
        if batched:
            warped2 = warp_flow_batch(img2, fx, fy)
        else:
            warped2 = warp_flow(img2, fx, fy, border="reflect")
        expw = _poly_exp(warped2, g1, x1, invG, n)
        zx = jnp.zeros_like(fx)
        dfx, dfy = zx, zx
        for _ in range(2):
            dfx, dfy = _flow_iteration(exp1, expw, (dfx, dfy), winsize, gaussian_win, batched)
        fx = fx + dfx
        fy = fy + dfy

    return fx, fy


def farneback_register_sequence(
    U: Array,
    *,
    flow_smooth_ksize: int = 11,
    flow_smooth_sigma: float = 2.0,
    warp_sign: float = 1.0,
    **flow_kwargs,
) -> Array:
    """Sequential warp-to-previous registration.

    The chain defaults to ``refine=1`` (one re-warp refinement pass instead
    of farneback_flow's default 2): measured on a 512x640 jittered sequence,
    refine=1 keeps 57% residual-motion improvement (vs 69% for refine=2 and
    38% for the strict cv2-equivalent refine=0 — the reference's own cv2
    run reports 18.5%, docs/RESULTS.md:80-84) at 1.07 s/flow instead of
    1.45 s on this host's CPU — the chain is the dominant stage of the
    analyze/patch pipelines on every backend. Pass ``refine=`` explicitly to
    override.

    Parity: analyze_results.py:229-242 / patch_based_pde_discovery.py:125-153 —
    flow from previous *registered* frame to current frame, smoothed with an
    11x11 Gaussian (sigma 2), backward-map warp with reflect border.
    Inherently sequential (ref depends on previous output) -> lax.scan.

    warp direction: with the cv2 convention ref(x) ~ mov(x + flow(x)), the
    aligning warp is warped(x) = mov(x + flow(x)) — warp_sign=+1 (default).
    NOTE the reference scripts build the map as ``x - flow``
    (analyze_results.py:238-239, pde_discovery_improved_registration.py:90-93)
    which measurably *doubles* residual misalignment on synthetic shifted
    pairs (verified against cv2: rmse 0.042 -> 0.077 with '-', -> 0.004 with
    '+'). warp_sign=-1.0 reproduces the reference behavior for parity
    studies; the default fixes it (SURVEY §7.5: fix, don't copy).

    Execution note: the chain runs either as host-driven per-frame jitted
    programs or as one lax.scan whose body is a SINGLE-example pyramid
    (:func:`_chain_impl_default`); a vmap over frames would batch the
    pyramid's gathers, which lowered ~100-400x slower where this was first
    tuned.
    """

    sign = jnp.asarray(warp_sign, U.dtype)
    flow_kwargs.setdefault("refine", 1)
    chain_impl = flow_kwargs.pop("chain_impl", None) or _chain_impl_default()
    flow_ds = flow_kwargs.pop("flow_ds", None)
    flow_ds = _chain_flow_ds(flow_ds, U.shape[-2], U.shape[-1])
    flow_static = tuple(sorted(flow_kwargs.items()))
    if chain_impl == "scan":
        # identical per-step math folded into ONE device program via
        # lax.scan: the body is a single-example pyramid (plain gathers,
        # not vmap batching-dim gathers), so this trades T-1 dispatches for
        # one. Parity with the per-step chain is pinned in
        # tests/test_register.py.
        return _register_chain_scan(
            U, sign,
            ksize=flow_smooth_ksize, sigma=flow_smooth_sigma,
            flow_static=flow_static, flow_ds=flow_ds,
        )
    ref = _first_frame(U)
    out = [ref]
    for i in range(1, U.shape[0]):
        # frame selection happens INSIDE the jitted step (dynamic index):
        # an eager U[i] per frame is a separate device op — ~50 dispatches,
        # ~80 ms each through a slow host's eager CPU path (measured 16 s
        # of a 21 s patch-discovery run)
        ref = _register_step(
            U, ref, i, sign,
            ksize=flow_smooth_ksize, sigma=flow_smooth_sigma,
            flow_static=flow_static, flow_ds=flow_ds,
        )
        out.append(ref)
    return stack_frames(*out)


def _chain_flow_ds(flow_ds: int | None, H: int, W: int) -> int:
    """Chain flow-resolution policy (the trick that took patch-sindy's
    compose path 4x down, applied to the warp-to-previous chain): compute
    each step's flow on 2x-downsampled frames and upsample it (values
    scaled) before the smooth+warp. None -> 2 on accelerators (inherited
    tuning, not yet measured on the H100), 1 on CPU (CPU goldens
    bit-stable); clamped so the flow grid stays >= 64 px.
    PDX_REG_FLOW_DS overrides for A/B. Residual-motion quality at ds=2 is
    pinned within a few % of full-res in tests/test_register.py."""
    env = os.environ.get("PDX_REG_FLOW_DS")
    if env is not None:
        ds = int(env)
    elif flow_ds is not None:
        ds = int(flow_ds)
    else:
        ds = 2 if jax.default_backend() != "cpu" else 1
    while ds > 1 and min(H, W) // ds < 64:
        ds //= 2
    return max(1, ds)


def _chain_impl_default() -> str:
    """Chain execution schedule: ONE lax.scan program on accelerators (one
    dispatch instead of T-1; inherited tuning, not yet measured on the
    H100), per-frame jitted steps on CPU (a single-core host keeps the
    working set cache-resident frame-at-a-time).
    PDX_CHAIN_IMPL=scan|steps overrides."""
    impl = os.environ.get("PDX_CHAIN_IMPL")
    if impl:
        return impl
    return "scan" if jax.default_backend() != "cpu" else "steps"


def _chain_step_flow(ref, cur, *, f32, flow_ds: int, kw: dict):
    """One chain step's (possibly reduced-resolution) flow, at full-res
    scale/shape: the shared body of the scan and per-step schedules."""
    H, W = ref.shape[-2], ref.shape[-1]
    a, b = ref.astype(f32), cur.astype(f32)
    if flow_ds > 1:
        a = resize_bilinear(a, H // flow_ds, W // flow_ds)
        b = resize_bilinear(b, H // flow_ds, W // flow_ds)
    fx, fy = farneback_flow(a, b, **kw)
    if flow_ds > 1:
        fx = resize_bilinear(fx, H, W) * (H / fx.shape[-2])
        fy = resize_bilinear(fy, H, W) * (W / fy.shape[-1])
    return fx, fy


@partial(jax.jit, static_argnames=("ksize", "sigma", "flow_static", "flow_ds"))
def _register_chain_scan(U, sign, *, ksize: int, sigma: float, flow_static, flow_ds: int = 1):
    """Whole warp-to-previous chain as one lax.scan program.

    Same math as the _register_step loop (flow in f32, smoothed, warped in
    the pipeline dtype); the sequential dependency rides the scan carry
    (previous REGISTERED frame) instead of the host loop."""
    f32 = jnp.float32 if U.dtype == jnp.float64 else U.dtype
    kw = dict(flow_static)

    def step(ref, cur):
        fx, fy = _chain_step_flow(ref, cur, f32=f32, flow_ds=flow_ds, kw=kw)
        fs = _blur(jnp.stack([fx, fy]), ksize, sigma, True).astype(U.dtype)
        warped = warp_flow(cur, sign * fs[0], sign * fs[1], border="reflect")
        return warped, warped

    _, out = jax.lax.scan(step, U[0], U[1:])
    return jnp.concatenate([U[:1], out], axis=0)


@jax.jit
def _first_frame(U):
    return U[0]


@jax.jit
def stack_frames(*frames):
    """jnp.stack as one compiled program: the eager stack lowers to ~150
    broadcast/concat primitives, each a separate dispatch (measured 5.3 s
    for 51 frames through this host's eager path)."""
    return jnp.stack(frames, axis=0)


@partial(jax.jit, static_argnames=("ksize", "sigma", "flow_static", "flow_ds"))
def _register_step(U, ref, i, sign, *, ksize: int, sigma: float, flow_static, flow_ds: int = 1):
    cur = jax.lax.dynamic_index_in_dim(U, i, 0, keepdims=False)
    # flow is COMPUTED in f32, the warp applied in the pipeline dtype:
    # cv2's Farneback runs float32 internally (the reference even casts the
    # frames to uint8 first, analyze_results.py:232-233), so f32 flow is
    # reference-faithful — and it halves the pyramid's memory traffic on the
    # f64 CPU path (~0.8 s/flow saved of 1.6 s at 512x640)
    f32 = jnp.float32 if U.dtype == jnp.float64 else U.dtype
    fx, fy = _chain_step_flow(ref, cur, f32=f32, flow_ds=flow_ds, kw=dict(flow_static))
    fs = _blur(jnp.stack([fx, fy]), ksize, sigma, True).astype(U.dtype)
    return warp_flow(cur, sign * fs[0], sign * fs[1], border="reflect")


@partial(jax.jit, static_argnames=("ksize", "sigma"))
def _smooth_warp(mov, fx, fy, sign, ksize: int, sigma: float):
    """Module-level (not a per-call closure): a fresh jitted closure per
    sequence call forces a re-lowering of the full-resolution warp every
    pipeline run."""
    fs = _blur(jnp.stack([fx, fy]), ksize, sigma, True)
    return warp_flow(mov, sign * fs[0], sign * fs[1], border="reflect")


def auto_register_mode() -> str:
    """Resolve register_mode='auto' (analyze / patch-discovery pipelines).

    Chain on every backend. Where this was first tuned (inherited tuning,
    not yet measured on the H100) the batched compose pyramid was at best
    ~1.3x faster per flow than the chain — still chain here, because that
    win does not cover compose's different registration semantics (to-first composed flows accumulate interpolation blur over
    the chain; see register/quality tests), while the PATCH pipelines' pair
    flows — where compose wins 3x — have no such semantic change and take
    the compose path via their own flow_compose auto policy.
    PDX_REGISTER_AUTO=compose flips this policy for re-measurement.
    """
    return os.environ.get("PDX_REGISTER_AUTO", "chain")


def register_sequence_dispatch(
    U: Array, *, mode: str, refine: int, reference_compat_warp: bool = False
) -> Array:
    """Resolve + run the register-mode policy shared by the real-image
    pipelines (analyze / patch discovery) — ONE place so a policy change
    (e.g. flipping ``auto``) cannot drift between them.

    ``reference_compat_warp`` forces the chain schedule with the reference's
    inverted warp sign (the reference bug preserved behind the flag);
    ``mode='auto'`` resolves via :func:`auto_register_mode`; anything but
    ``'chain'`` dispatches the batched compose pyramid
    (``to_first`` anchors every flow to frame 0).
    """
    if reference_compat_warp:
        return farneback_register_sequence(U, warp_sign=-1.0, refine=refine)
    if mode == "auto":
        mode = auto_register_mode()
    if mode == "chain":
        return farneback_register_sequence(U, refine=refine)
    return farneback_register_sequence_compose(
        U, to_first=(mode == "to_first"), refine=refine
    )


def _flow_chunk_elems() -> int:
    """Max B*H*W pixel-pairs per batched pyramid program.

    The flat-gather pyramid needs ~70 f32 of HLO temp per pixel per pair
    (a 1500-pair 256^2 program asked for 27.5 GB of device temps). Chunking
    the independent pair axis bounds the working set. Default 2^21
    px-pairs (~0.6 GB of temps), sized for a 16 GB device: the per-pair
    cost was lowest at this size where it was tuned, with a cliff just
    above 2^21 where gather-index temps pushed programs onto
    spill/transpose-copy paths (inherited tuning, not yet measured on the
    80 GB H100). Override with PDX_FLOW_CHUNK_ELEMS.
    """
    return int(os.environ.get("PDX_FLOW_CHUNK_ELEMS", str(1 << 21)))


@partial(jax.jit, static_argnames=("chunk", "flow_static"))
def _pairs_flow_chunk(a_all, b_all, start, *, chunk: int, flow_static):
    a = jax.lax.dynamic_slice_in_dim(a_all, start, chunk, axis=0)
    b = jax.lax.dynamic_slice_in_dim(b_all, start, chunk, axis=0)
    return farneback_flow(a, b, batched=True, **dict(flow_static))


@partial(jax.jit, static_argnames=("keep",))
def _assemble_chunks(keep: int, *xs):
    """Concatenate chunk outputs, taking only the last ``keep`` rows of the
    final (overlapping) chunk — one compiled program, static slice."""
    if len(xs) == 1:
        return xs[0][xs[0].shape[0] - keep :]
    return jnp.concatenate(xs[:-1] + (xs[-1][xs[-1].shape[0] - keep :],), axis=0)


def batched_pair_flows(
    a_all: Array, b_all: Array, *, flow_static, chunk_elems: int | None = None
) -> tuple[Array, Array]:
    """Flows for B independent pairs (a_all[i] -> b_all[i]), chunked.

    Every chunk is the SAME compiled (chunk, H, W) program — the tail chunk
    re-reads overlapping rows (frame selection by lax.dynamic_slice inside
    the program) instead of forcing a second compile at a ragged shape.
    """
    B, H, W = a_all.shape[-3], a_all.shape[-2], a_all.shape[-1]
    if B == 0:  # e.g. a single-frame stack: no pairs, no flows
        dt = a_all.dtype if jnp.issubdtype(a_all.dtype, jnp.floating) else jnp.float32
        z = jnp.zeros((0, H, W), dt)
        return z, z
    if chunk_elems is None:
        chunk_elems = _flow_chunk_elems()
    chunk = max(1, min(B, chunk_elems // (H * W)))
    starts = list(range(0, B, chunk))
    if starts[-1] + chunk > B:
        starts[-1] = B - chunk
    outs = [
        _pairs_flow_chunk(a_all, b_all, s, chunk=chunk, flow_static=flow_static)
        for s in starts
    ]
    keep = B - (len(starts) - 1) * chunk
    return (
        _assemble_chunks(keep, *[o[0] for o in outs]),
        _assemble_chunks(keep, *[o[1] for o in outs]),
    )


def farneback_flow_pairs(U: Array, *, pair_batch: bool = True, **flow_kwargs) -> tuple[Array, Array]:
    """Flow for every consecutive frame pair (transport pipeline,
    transport_pde_discovery.py:46-83).

    Pairs are independent: the default runs them as flat-gather-batched
    pyramid programs (``batched=True`` — the vmap-style gather with batching
    dimensions that made the original vmapped pyramid ~400x slower is
    replaced by a plain row-folded gather, see ops/interp.py::_gather2d_rowfold_batch),
    chunked to bound device temps (:func:`batched_pair_flows`).
    ``pair_batch=False`` keeps the legacy per-pair jitted dispatch chain for
    A/B timing."""
    if pair_batch:
        return _pair_flows_batched(U, flow_static=tuple(sorted(flow_kwargs.items())))
    flow_static = tuple(sorted(flow_kwargs.items()))
    outs = [
        _pair_flow(U, i, flow_static=flow_static) for i in range(U.shape[0] - 1)
    ]
    fx = stack_frames(*[o[0] for o in outs])
    fy = stack_frames(*[o[1] for o in outs])
    return fx, fy


@jax.jit
def _seq_pairs(U):
    return U[:-1], U[1:]


def _pair_flows_batched(U, *, flow_static):
    a, b = _seq_pairs(U)
    return batched_pair_flows(a, b, flow_static=flow_static)


@partial(jax.jit, static_argnames=("flow_static",))
def _pair_flow(U, i, *, flow_static):
    a = jax.lax.dynamic_index_in_dim(U, i, 0, keepdims=False)
    b = jax.lax.dynamic_index_in_dim(U, i + 1, 0, keepdims=False)
    return farneback_flow(a, b, **dict(flow_static))


@partial(jax.jit, static_argnames=("batched",))
def compose_flow_chain(fx: Array, fy: Array, *, batched: bool = False) -> tuple[Array, Array]:
    """Cumulatively compose consecutive backward flows into to-first flows.

    ``fx``/``fy``: (T-1, H, W) pairwise flows (``batched=True``: (P, T-1, H, W)
    independent chains), where flow t maps frame-t points to frame t+1:
    U[t](x) ~ U[t+1](x + f_t(x)). Returns flows of the same shape with
    U[0](x) ~ U[t+1](x + F_t(x)), via the backward-map composition

        F_t = F_{t-1} + f_t(id + F_{t-1}),   F_0 = f_0.

    The per-step work is one bilinear gather of a 2-channel field — a
    lax.scan of cheap ops, NOT a scan over full pyramid programs. Combined
    with the batched pairwise pyramid (``_pair_flows_batched``) this turns a
    chained T-1-dispatch registration into ~3 device programs.
    """
    ta = 1 if batched else 0
    fxs = jnp.moveaxis(fx, ta, 0)  # (T-1, [P,] H, W)
    fys = jnp.moveaxis(fy, ta, 0)
    H, W = fx.shape[-2], fx.shape[-1]
    dtype = fx.dtype
    r = jnp.arange(H, dtype=dtype)[:, None]
    c = jnp.arange(W, dtype=dtype)[None, :]

    def step(F, f):
        Fx, Fy = F
        fxi, fyi = f
        if batched:
            s = bilinear_sample_reflect_cbatch(
                jnp.stack([fxi, fyi], axis=0), r + Fx, c + Fy
            )  # (2, P, H, W)
            Fx2, Fy2 = Fx + s[0], Fy + s[1]
        else:
            s = bilinear_sample_reflect(jnp.stack([fxi, fyi]), r + Fx, c + Fy)
            Fx2, Fy2 = Fx + s[0], Fy + s[1]
        return (Fx2, Fy2), (Fx2, Fy2)

    z = jnp.zeros(fxs.shape[1:], dtype)
    _, (Fx_all, Fy_all) = jax.lax.scan(step, (z, z), (fxs, fys))
    return jnp.moveaxis(Fx_all, 0, ta), jnp.moveaxis(Fy_all, 0, ta)


def farneback_register_sequence_compose(
    U: Array,
    *,
    flow_smooth_ksize: int = 11,
    flow_smooth_sigma: float = 2.0,
    to_first: bool = False,
    **flow_kwargs,
) -> Array:
    """Batched registration to the first frame: pairwise-flow + compose.

    Batched replacement for :func:`farneback_register_sequence`'s
    sequential warp-to-previous chain (analyze_results.py:229-242). The
    chain's data dependency (each flow reads the previous *registered*
    frame) forces T-1 chained pyramid steps, the dominant stage of the
    analyze pipeline. This mode removes the dependency:

      1. ALL T-1 consecutive-pair flows in ONE flat-gather-batched pyramid
         program (same math as ``_pair_flows_batched``),
      2. 11x11/sigma-2 smoothing of every pairwise flow (one batched blur),
      3. cumulative composition into to-first flows (:func:`compose_flow_chain`
         — a scan of cheap gathers), and
      4. ONE batched warp of frames 1..T-1.

    ``to_first=True`` skips steps 1/3's chaining entirely and estimates each
    frame's flow directly against frame 0 (the reference's own
    ``stabilize_translation_sequence`` has to_first precedent,
    ks2d_stridge_benchmark.py:940-973) — cheaper still, but only appropriate
    when content change across the whole sequence stays within the pyramid's
    capture range; the compose default matches the chain's locality.

    Only the FIXED warp direction is supported (warp_sign=+1): composition
    of backward maps is meaningless under the reference's ``x - flow`` bug —
    use the sequential chain with ``warp_sign=-1`` for parity studies.
    """
    flow_kwargs.setdefault("refine", 1)
    return _register_compose_impl(
        U,
        ksize=flow_smooth_ksize,
        sigma=flow_smooth_sigma,
        flow_static=tuple(sorted(flow_kwargs.items())),
        to_first=to_first,
    )


@partial(jax.jit, static_argnames=("to_first",))
def _compose_pairs(U, *, to_first: bool):
    f32 = jnp.float32 if U.dtype == jnp.float64 else U.dtype
    Uf = U.astype(f32)
    if to_first:
        return jnp.broadcast_to(Uf[0], Uf[1:].shape), Uf[1:]
    return Uf[:-1], Uf[1:]


@partial(jax.jit, static_argnames=("ksize", "sigma", "to_first"))
def _compose_finish(U, fx, fy, *, ksize: int, sigma: float, to_first: bool):
    sm = _blur(jnp.stack([fx, fy], axis=1), ksize, sigma, True)  # (T-1, 2, H, W)
    fx, fy = sm[:, 0], sm[:, 1]
    if not to_first:
        fx, fy = compose_flow_chain(fx, fy)
    warped = warp_flow_batch(U[1:], fx.astype(U.dtype), fy.astype(U.dtype))
    return jnp.concatenate([U[:1], warped], axis=0)


def _register_compose_impl(U, *, ksize: int, sigma: float, flow_static, to_first: bool):
    # pairwise flows run CHUNKED (batched_pair_flows): the single giant
    # program OOMed at patch scale and was measurably slower than the
    # dispatch chain at analyze scale — see _flow_chunk_elems
    a, b = _compose_pairs(U, to_first=to_first)
    fx, fy = batched_pair_flows(a, b, flow_static=flow_static)
    return _compose_finish(U, fx, fy, ksize=ksize, sigma=sigma, to_first=to_first)
