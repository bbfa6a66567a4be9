"""Patch-based SINDy with optional per-patch local registration.

End-to-end parity with ``scripts/patch_based_sindy.py`` (class
PatchBasedSINDy): pre-denoise (spatial Gaussian + temporal Savitzky-Golay) ->
overlapping patch grid -> optional per-patch ECC / optical-flow registration
-> per-patch 11-term library ridge fit (fit_intercept=False) over
boundary-masked subsampled grid points -> quality = max(0, R^2) x
registration quality -> quality-weighted ensemble aggregation with
high-variance-term suppression.

Batched: patches are extracted as one reshape/gather; the per-patch
central-difference libraries and ridge solves are vmapped over the patch
axis (the reference loops patches sequentially, ~minutes); ECC alignment is
a bounded while_loop vmapped over patch sequences.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from pdx.io_host.images import load_images
from pdx.io_host.artifacts import write_json
from pdx.ops.filters import gaussian_filter_reflect, savgol_time
from pdx.ops.metrics import r2_score
from pdx.ops.linalg import gram_stats, standardized_stats, masked_ridge_solve
from pdx.register.ecc import ecc_register_sequence

TERM_NAMES = ["1", "u", "u_x", "u_y", "u_xx", "u_yy", "∇²u", "u²", "u·u_x", "u·u_y", "u·∇²u"]


@dataclass(frozen=True)
class PatchSindyConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/patch_sindy"
    max_images: int | None = None
    dt: float = 1.0
    dx: float = 0.1
    dy: float = 0.1
    patch_size: int = 256
    overlap: int = 64
    spatial_sigma: float = 0.3
    temporal_window: int = 3
    skip_boundary: int = 5
    subsample: int = 4
    alpha: float = 0.01
    min_patches: int = 5
    registration_method: str = "none"  # none | ecc | optical_flow
    # optical_flow scope: 'patch' = per-patch flows (reference parity,
    # patch_based_sindy.py:198-221 — P*(T-1) small flows); 'frame' =
    # register the full frame sequence once before patch extraction
    # (T-1 large flows, ~4x less flow work and no patch-edge artifacts)
    flow_scope: str = "patch"  # patch | frame
    # batch the patch axis of the per-patch flows: one program per time step
    # covering every patch (T-1 dispatches) instead of P*(T-1) chained
    # single-patch flows; identical math per patch (flat-gather formulation,
    # see ops/interp.py::_gather2d_rowfold_batch)
    flow_batch: bool = True
    # batch the TIME axis too: all P*(T-1) pairwise flows as chunked
    # flat-gather pyramid programs, per-patch cumulative composition to
    # to-first flows (farneback.compose_flow_chain), one batched warp —
    # a handful of device programs instead of T-1 chained dispatches.
    # None = auto: COMPOSE on accelerators, CHAIN on CPU. The accelerator
    # choice is inherited tuning (compose about 3x faster per pair where it
    # was tuned), not yet measured on the H100. CPU stays chain (single-core cache
    # locality; compose's big gathers thrash). Quality of the two paths is
    # pinned close by
    # tests/test_more_pipelines.py::test_flow_compose_close_to_chain.
    flow_compose: bool | None = None
    # compose-path flow resolution: compute + compose the per-patch flows at
    # patch_size/flow_downsample and upsample the composed to-first flows
    # before the full-res warp. None = auto: reduced on accelerators
    # (half-res quarters the gather-bound pyramid; inherited tuning, not yet
    # measured on the H100), 1 on CPU (keeps the CPU golden path
    # bit-stable). PDX_FLOW_DS overrides for A/B.
    flow_downsample: int | None = None
    max_patches: int | None = None
    var_suppress_factor: float = 2.0
    dtype: str = "float64"
    write_artifacts: bool = True
    # multi-chip: shard the patch axis of the vmapped fit over all devices
    mesh: str = "auto"  # auto | off | on


def _grid_coords(H: int, W: int, patch_size: int, stride: int) -> list[tuple[int, int]]:
    return [
        (y, x)
        for y in range(0, H - patch_size + 1, stride)
        for x in range(0, W - patch_size + 1, stride)
    ]


@partial(jax.jit, static_argnames=("patch_size", "stride"))
def _extract_impl(U, *, patch_size: int, stride: int):
    T, H, W = U.shape
    return jnp.stack(
        [U[:, y : y + patch_size, x : x + patch_size] for y, x in _grid_coords(H, W, patch_size, stride)]
    )


def extract_patch_sequences(U: jnp.ndarray, patch_size: int, stride: int) -> tuple[jnp.ndarray, list[tuple[int, int]]]:
    """(n_patches, T, ps, ps) patch sequences + top-left coords.

    One compiled program: the eager formulation dispatched a slice per patch
    plus a ~3P-primitive stack."""
    T, H, W = U.shape
    coords = _grid_coords(H, W, patch_size, stride)
    if not coords:
        return jnp.zeros((0, T, patch_size, patch_size), U.dtype), coords
    return _extract_impl(U, patch_size=patch_size, stride=stride), coords


def _patch_library(u: jnp.ndarray, dx: float, dy: float) -> jnp.ndarray:
    """11-term library on a (ps, ps) frame with periodic central differences
    (patch_based_sindy.py:229-268; note their 'x' is axis=1 = cols)."""
    ux = (jnp.roll(u, -1, 1) - jnp.roll(u, 1, 1)) / (2 * dx)
    uy = (jnp.roll(u, -1, 0) - jnp.roll(u, 1, 0)) / (2 * dy)
    uxx = (jnp.roll(u, -1, 1) - 2 * u + jnp.roll(u, 1, 1)) / dx**2
    uyy = (jnp.roll(u, -1, 0) - 2 * u + jnp.roll(u, 1, 0)) / dy**2
    lap = uxx + uyy
    return jnp.stack(
        [jnp.ones_like(u), u, ux, uy, uxx, uyy, lap, u**2, u * ux, u * uy, u * lap], axis=-1
    )


def discover_patch(
    seq: jnp.ndarray, cfg: PatchSindyConfig, reg_quality: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-patch central-difference dataset + ridge (fit_intercept=False)
    standardized fit (patch_based_sindy.py:265-364). Returns (coeffs, quality)."""
    return _discover_patch_impl(
        seq, reg_quality,
        dt=cfg.dt, dx=cfg.dx, dy=cfg.dy, alpha=cfg.alpha,
        sb=cfg.skip_boundary, sub=cfg.subsample,
    )


def _discover_patch_impl(seq, reg_quality, *, dt, dx, dy, alpha, sb, sub):
    T, ps, _ = seq.shape
    mask2 = np.zeros((ps, ps), dtype=bool)
    mask2[sb:-sb:1, sb:-sb:1] = True
    submask = np.zeros_like(mask2)
    submask[::sub, ::sub] = True
    mask2 &= submask
    idx = np.where(mask2.reshape(-1))[0]

    def frame_data(i):
        u = seq[i]
        ut = (seq[i + 1] - seq[i - 1]) / (2 * dt)
        lib = _patch_library(u, dx, dy).reshape(-1, len(TERM_NAMES))[idx]
        return lib, ut.reshape(-1)[idx]

    libs, uts = [], []
    for i in range(1, T - 1):
        l, t = frame_data(i)
        libs.append(l)
        uts.append(t)
    X = jnp.concatenate(libs, axis=0)
    y = jnp.concatenate(uts, axis=0)

    # sklearn: StandardScaler -> Ridge(fit_intercept=False) -> /scale_
    stats = gram_stats(X, y)
    Gs, bs, mean, scale = standardized_stats(stats)
    # fit_intercept=False on *scaled* (not centered-target) data: sklearn's
    # StandardScaler centers X columns; Ridge(int=False) then has no
    # intercept; X_scaled^T y uses the raw y — identical to our bs
    full = jnp.ones((X.shape[1],), dtype=X.dtype)
    c_std = masked_ridge_solve(Gs, bs, full, alpha)
    coeffs = c_std / scale
    y_pred = X @ coeffs
    r2 = r2_score(y, y_pred)
    quality = jnp.maximum(0.0, r2) * reg_quality
    return coeffs, quality


@partial(jax.jit, static_argnames=("dt", "dx", "dy", "alpha", "sb", "sub"))
def _discover_all(seqs, quals, *, dt, dx, dy, alpha, sb, sub):
    """Vmapped per-patch discovery as a MODULE-LEVEL jitted program: a
    jit(...) object built inside run() retraces and recompiles on every
    pipeline call (the full-scale program costs minutes of XLA compile)."""
    return jax.vmap(
        lambda s, q: _discover_patch_impl(s, q, dt=dt, dx=dx, dy=dy, alpha=alpha, sb=sb, sub=sub)
    )(seqs, quals)


@jax.jit
def _ecc_one(seqs, i):
    seq = jax.lax.dynamic_index_in_dim(seqs, i, 0, keepdims=False)
    out, ccs = ecc_register_sequence(seq, motion="euclidean", gauss_sigma=1.0)
    return out, jnp.mean(ccs)


@jax.jit
def _patch_frame(seqs, pi, t):
    return jax.lax.dynamic_index_in_dim(
        jax.lax.dynamic_index_in_dim(seqs, pi, 0, keepdims=False), t, 0, keepdims=False
    )


@jax.jit
def _mean_stack(*xs):
    return jnp.mean(jnp.stack(xs))


@jax.jit
def _first_frames(seqs):
    return seqs[:, 0]


@partial(jax.jit, static_argnames=("idxs", "ds"))
def _select_frames_f32(U, idxs: tuple[int, ...], ds: int = 1):
    """Gather display frames on device, f32, downsampled to display
    resolution before the host read: the figure panel is ~600x750 px at
    150 dpi, so full-res frames would be read only to be thrown away."""
    from pdx.ops.interp import resize_bilinear

    F = U[jnp.asarray(idxs)].astype(jnp.float32)
    if ds > 1:
        F = resize_bilinear(F, U.shape[-2] // ds, U.shape[-1] // ds)
    return F


@jax.jit
def _flow_warp_step(seqs, prev, pi, t):
    from pdx.register.farneback import farneback_flow
    from pdx.ops.interp import warp_flow

    cur = _patch_frame(seqs, pi, t)
    # f32 flow compute, pipeline-dtype warp (see farneback._register_step)
    f32 = jnp.float32 if seqs.dtype == jnp.float64 else seqs.dtype
    fx, fy = farneback_flow(
        prev.astype(f32), cur.astype(f32), levels=3, winsize=15, iterations=5,
        poly_n=7, poly_sigma=1.5, gaussian_win=False, refine=1,
    )
    fx, fy = fx.astype(seqs.dtype), fy.astype(seqs.dtype)
    warped = warp_flow(cur, fx, fy, border="reflect")
    return warped, 1.0 / (jnp.mean(jnp.sqrt(fx**2 + fy**2)) + 1.0)


@jax.jit
def _flow_warp_step_all_patches(seqs, prev, t):
    """One time step of the per-patch registration chain for EVERY patch:
    (P, ps, ps) batched Farnebäck via the flat-gather formulation. Same math
    per patch as _flow_warp_step — only the dispatch structure changes."""
    from pdx.register.farneback import farneback_flow
    from pdx.ops.interp import warp_flow_batch

    cur = jax.lax.dynamic_index_in_dim(seqs, t, 1, keepdims=False)  # (P, ps, ps)
    f32 = jnp.float32 if seqs.dtype == jnp.float64 else seqs.dtype
    fx, fy = farneback_flow(
        prev.astype(f32), cur.astype(f32), levels=3, winsize=15, iterations=5,
        poly_n=7, poly_sigma=1.5, gaussian_win=False, batched=True, refine=1,
    )
    fx, fy = fx.astype(seqs.dtype), fy.astype(seqs.dtype)
    warped = warp_flow_batch(cur, fx, fy)
    q = 1.0 / (jnp.mean(jnp.sqrt(fx**2 + fy**2), axis=(-2, -1)) + 1.0)
    return warped, q


@jax.jit
def _flow_register_chain_scan_all(seqs):
    """Per-patch warp-to-previous chain: patch axis batched (row-fold
    gathers), time axis folded into lax.scan — the whole P*(T-1) chain as
    ONE device program. Same per-step math as _flow_warp_step_all_patches
    (the scan body is that step; only the dispatch structure changes)."""
    from pdx.register.farneback import farneback_flow
    from pdx.ops.interp import warp_flow_batch

    f32 = jnp.float32 if seqs.dtype == jnp.float64 else seqs.dtype
    xs = jnp.moveaxis(seqs[:, 1:], 1, 0)  # (T-1, P, ph, pw)

    def step(prev, cur):
        fx, fy = farneback_flow(
            prev.astype(f32), cur.astype(f32), levels=3, winsize=15,
            iterations=5, poly_n=7, poly_sigma=1.5, gaussian_win=False,
            batched=True, refine=1,
        )
        fx, fy = fx.astype(seqs.dtype), fy.astype(seqs.dtype)
        warped = warp_flow_batch(cur, fx, fy)
        q = 1.0 / (jnp.mean(jnp.sqrt(fx**2 + fy**2), axis=(-2, -1)) + 1.0)
        return warped, (warped, q)

    _, (frames, qs) = jax.lax.scan(step, seqs[:, 0], xs)
    seq = jnp.concatenate([seqs[:, :1], jnp.moveaxis(frames, 0, 1)], axis=1)
    return seq, jnp.mean(qs, axis=0)


@partial(jax.jit, static_argnames=("ds",))
def _compose_all_prep(seqs, ds: int = 1):
    """Flatten (P, T, ph, pw) into the P*(T-1) consecutive-pair operands.

    ``ds`` > 1 additionally downsamples the pair operands (bilinear) so the
    gather-bound pyramid runs at reduced resolution — the flow field is
    smooth at the patch scale, so computing it at ph/ds and upsampling the
    composed result (see _compose_all_finish) trades sub-pixel flow detail
    for ~ds^2 less flow work. The full-resolution warp is unchanged."""
    from pdx.ops.interp import resize_bilinear

    P, T, ph, pw = seqs.shape
    f32 = jnp.float32 if seqs.dtype == jnp.float64 else seqs.dtype
    Sf = seqs.astype(f32)
    prev = Sf[:, :-1].reshape(P * (T - 1), ph, pw)
    cur = Sf[:, 1:].reshape(P * (T - 1), ph, pw)
    if ds > 1:
        prev = resize_bilinear(prev, ph // ds, pw // ds)
        cur = resize_bilinear(cur, ph // ds, pw // ds)
    return prev, cur


@jax.jit
def _compose_all_finish(seqs, fx, fy):
    """Compose pairwise flows to to-first flows (at the flow's own
    resolution — half-res when _compose_all_prep downsampled), upsample the
    composed flows once if needed, and warp every frame at full resolution.

    Flow values are in flow-resolution pixel units throughout the
    composition (self-consistent); magnitudes for the quality metric and the
    final warp offsets are rescaled to full-res units by (ph/hs, pw/ws)."""
    from pdx.register.farneback import compose_flow_chain
    from pdx.ops.interp import resize_bilinear, warp_flow_batch

    P, T, ph, pw = seqs.shape
    hs, ws = int(fx.shape[-2]), int(fx.shape[-1])
    sr, sc = ph / hs, pw / ws
    mag = jnp.sqrt((sr * fx) ** 2 + (sc * fy) ** 2).reshape(P, T - 1, hs, ws)
    q = jnp.mean(
        1.0 / (jnp.mean(mag, axis=(-2, -1)) + 1.0), axis=1
    ).astype(seqs.dtype)
    Fx, Fy = compose_flow_chain(
        fx.reshape(P, T - 1, hs, ws), fy.reshape(P, T - 1, hs, ws), batched=True
    )
    Fx = Fx.reshape(P * (T - 1), hs, ws)
    Fy = Fy.reshape(P * (T - 1), hs, ws)
    if (hs, ws) != (ph, pw):
        Fx = resize_bilinear(Fx, ph, pw) * jnp.asarray(sr, Fx.dtype)
        Fy = resize_bilinear(Fy, ph, pw) * jnp.asarray(sc, Fy.dtype)
    warped = warp_flow_batch(
        seqs[:, 1:].reshape(P * (T - 1), ph, pw),
        Fx.astype(seqs.dtype),
        Fy.astype(seqs.dtype),
    ).reshape(P, T - 1, ph, pw)
    return jnp.concatenate([seqs[:, :1], warped], axis=1), q


def _resolve_flow_compose(flow_compose: bool | None) -> bool:
    """Resolve the flow_compose auto policy (None -> backend-dependent).

    Compose on accelerators (inherited tuning, not yet measured on the H100 —
    see PatchSindyConfig.flow_compose), chain on CPU. PDX_FLOW_COMPOSE=0/1
    overrides for A/B.
    """
    env = os.environ.get("PDX_FLOW_COMPOSE")
    if env is not None:
        return env not in ("0", "false", "chain")
    if flow_compose is not None:
        return flow_compose
    return jax.default_backend() != "cpu"


def _resolve_flow_ds(flow_downsample: int | None, patch_size: int) -> int:
    """Resolve the compose-path flow resolution policy (None -> backend-
    dependent: reduced-res on accelerators, full-res on CPU). The auto
    policy picks the largest ds in {4, 2} keeping the flow grid >= 64 px:
    at the production 256 px patches, ds=4 matches ds=2's registration
    residual on textured drift (0.00277 vs 0.00263 — both ~3x better than
    full-res) at about a third of ds=2's flow time (inherited tuning, not
    yet measured on the H100). An explicit value is honored down to a 32 px
    grid. PDX_FLOW_DS overrides."""
    env = os.environ.get("PDX_FLOW_DS")
    if env is not None:
        ds = int(env)
    elif flow_downsample is not None:
        ds = int(flow_downsample)
    elif jax.default_backend() == "cpu":
        ds = 1
    else:
        return 4 if patch_size // 4 >= 64 else (2 if patch_size // 2 >= 64 else 1)
    while ds > 1 and patch_size // ds < 32:
        ds //= 2
    return max(1, ds)


def _flow_register_compose_all(seqs, flow_ds: int = 1):
    """Per-patch registration with BOTH the patch and time axes batched.

    All P*(T-1) consecutive-pair flows run as CHUNKED flat-gather pyramid
    programs (farneback.batched_pair_flows — the one-giant-program version
    asked for 27.5 GB of device temps at the default patch grid), per-patch
    composition turns them
    into to-first flows (farneback.compose_flow_chain), and one batched warp
    registers every frame — a handful of device programs vs the T-1 chained
    dispatches of _flow_warp_step_all_patches (which itself replaced the
    reference's P*(T-1) chained cv2 calls, patch_based_sindy.py:171-221).

    Quality per patch: mean_t 1/(1 + mean|flow_t|) over the raw pairwise
    flows (the chain uses the warped-prev incremental flow — same scale,
    same meaning: residual inter-frame motion).

    ``flow_ds`` > 1 computes (and composes) the flows at 1/flow_ds patch
    resolution and upsamples the composed to-first flows once before the
    full-resolution warp — ~flow_ds^2 less of the gather-bound pyramid +
    composition work for sub-pixel flow detail the smooth laser-matter
    motion doesn't contain (quality pinned against the full-res path in
    tests/test_more_pipelines.py::test_flow_downsample_close_to_fullres).
    """
    from pdx.register.farneback import batched_pair_flows

    prev, cur = _compose_all_prep(seqs, ds=flow_ds)
    # refine=1 (not farneback_flow's default 2): through the to-first
    # composition the second re-warp pass buys nothing — residual within 1%
    # of refine=2 on textured translation, slightly BETTER on smooth drift
    # (refine=0 is 24-42% worse — keep one pass), ~25% less flow time.
    # Same policy the chain schedule adopted (farneback_register_sequence).
    flow_static = (
        ("gaussian_win", False), ("iterations", 5), ("levels", 3),
        ("poly_n", 7), ("poly_sigma", 1.5), ("refine", 1), ("winsize", 15),
    )
    fx, fy = batched_pair_flows(prev, cur, flow_static=flow_static)
    return _compose_all_finish(seqs, fx, fy)


@jax.jit
def _assemble_time(first, frames, quals):
    """(P, ps, ps) first frame + (T-1)-lists -> registered (P, T, ps, ps)
    sequences and per-patch mean qualities, as ONE compiled program."""
    seq = jnp.stack([first, *frames], axis=1)
    return seq, jnp.mean(jnp.stack(quals, axis=0), axis=0)


def run(cfg: PatchSindyConfig, U_raw: np.ndarray | None = None) -> dict[str, Any]:
    from pdx.utils.precision import resolve_dtype

    dtype = resolve_dtype(cfg.dtype)
    if U_raw is None:
        # raw u8 to the device (4x less host-to-device traffic), cast + /255 ON
        # DEVICE: the host `U_raw / 255.0` was a full-stack numpy f64 pass
        # (2x 267 MB of fresh-page writes); the device form is bit-equal for
        # all 256 u8 values (verified)
        U_raw = load_images(
            cfg.data_dir, max_images=cfg.max_images or 10**9,
            mode="grayscale_u8", dtype=np.uint8,
        )
        from pdx.io_host.images import device_stack

        U = device_stack(U_raw).astype(dtype) / jnp.asarray(255.0, dtype=dtype)
    else:
        U = jnp.asarray(U_raw, dtype=dtype)

    # pre-denoise (patch_based_sindy.py:88-119)
    U = gaussian_filter_reflect(U, cfg.spatial_sigma)
    if U.shape[0] >= cfg.temporal_window:
        U = savgol_time(U, cfg.temporal_window, 2)

    # auto-clamp: the reference default (256 px patches) assumes ~1024 px
    # frames; smaller inputs would otherwise yield an empty patch grid
    T_, H_, W_ = U.shape
    patch_size = min(cfg.patch_size, H_, W_)
    overlap = min(cfg.overlap, patch_size - 1) if patch_size < cfg.patch_size else cfg.overlap
    if patch_size != cfg.patch_size:
        import warnings

        warnings.warn(
            f"patch_size {cfg.patch_size} exceeds frame size {H_}x{W_}; clamped to {patch_size}"
        )
    stride = patch_size - overlap
    frame_registered = (
        cfg.registration_method == "optical_flow" and cfg.flow_scope == "frame"
    )
    if frame_registered:
        # frame-scope fast path: one warp-to-previous registration of the
        # whole sequence (T-1 large flows) instead of P*(T-1) per-patch
        # flows; quality reverts to fit-R2-only (flow magnitude is global)
        from pdx.register.farneback import farneback_register_sequence

        U = farneback_register_sequence(
            U, levels=3, winsize=15, iterations=5,
            poly_n=7, poly_sigma=1.5, gaussian_win=False,
        )
    seqs, coords = extract_patch_sequences(U, patch_size, stride)
    if seqs.shape[0] == 0:
        raise RuntimeError(
            f"patch grid is empty for patch_size={patch_size}, frames {H_}x{W_}"
        )
    if cfg.max_patches is not None and seqs.shape[0] > cfg.max_patches:
        import random

        random.seed(0)
        keep = sorted(random.sample(range(seqs.shape[0]), cfg.max_patches))
        seqs = seqs[jnp.asarray(keep)]
        coords = [coords[i] for i in keep]

    P = seqs.shape[0]
    if frame_registered:
        qualities = jnp.ones((P,), dtype=dtype)
    elif cfg.registration_method == "ecc":
        # host loop over patches: the ECC warp gathers + while_loops degrade
        # badly under vmap where they were tuned (not yet measured on the
        # H100); patch selection is a dynamic index inside the jitted step
        # (an eager seqs[i] per patch is a separate device dispatch)
        from pdx.register.farneback import stack_frames

        pairs = [_ecc_one(seqs, i) for i in range(P)]
        seqs = stack_frames(*[p[0] for p in pairs])
        qualities = stack_frames(*[p[1] for p in pairs])
    elif (
        cfg.registration_method == "optical_flow"
        and cfg.flow_batch
        and _resolve_flow_compose(cfg.flow_compose)
    ):
        # patch AND time axes batched: ~3 device programs for the whole
        # registration stage (see _flow_register_compose_all)
        seqs, qualities = _flow_register_compose_all(
            seqs, flow_ds=_resolve_flow_ds(cfg.flow_downsample, patch_size)
        )
    elif cfg.registration_method == "optical_flow" and cfg.flow_batch:
        # per-patch warp-to-previous Farnebäck, quality = 1/(1 + mean |flow|)
        # (patch_based_sindy.py:198-221). The patch axis is batched: each
        # time step runs ONE (P, ps, ps) row-fold-gather Farnebäck program
        # for every patch — T-1 dispatches total instead of the P*(T-1)
        # chained single-patch flows of the reference structure; only the
        # temporal warp-to-previous dependency stays sequential. On
        # accelerators the T-1 steps fold into ONE lax.scan program
        # (identical math, pinned in tests/test_more_pipelines.py;
        # PDX_CHAIN_IMPL overrides — see farneback._chain_impl_default).
        from pdx.register.farneback import _chain_impl_default

        if _chain_impl_default() == "scan":
            seqs, qualities = _flow_register_chain_scan_all(seqs)
        else:
            T_seq = int(seqs.shape[1])
            prev = _first_frames(seqs)
            frames, qs = [], []
            for t in range(1, T_seq):
                prev, q = _flow_warp_step_all_patches(seqs, prev, t)
                frames.append(prev)
                qs.append(q)
            seqs, qualities = _assemble_time(_first_frames(seqs), frames, qs)
    elif cfg.registration_method == "optical_flow":
        # legacy dispatch structure (flow_batch=False): host-chained jitted
        # single-patch flows — kept for A/B measurement
        from pdx.register.farneback import stack_frames

        new_seqs, qualities = [], []
        T_seq = int(seqs.shape[1])
        for pi in range(P):
            prev = _patch_frame(seqs, pi, 0)
            frames = [prev]
            qs = []
            for t in range(1, T_seq):
                prev, q = _flow_warp_step(seqs, prev, pi, t)
                frames.append(prev)
                qs.append(q)
            new_seqs.append(stack_frames(*frames))
            qualities.append(_mean_stack(*qs))
        seqs = stack_frames(*new_seqs)
        qualities = stack_frames(*qualities)
    else:
        qualities = jnp.ones((P,), dtype=dtype)

    # patch axis sharded over the device mesh (results sliced back to the
    # true patch count, so sharded == single-device coefficients)
    from pdx.shard.mesh import maybe_shard_leading

    (seqs_s, qual_s), P_orig = maybe_shard_leading(
        (seqs, qualities.astype(seqs.dtype)), cfg.mesh
    )
    coeffs, qual = _discover_all(
        seqs_s, qual_s,
        dt=cfg.dt, dx=cfg.dx, dy=cfg.dy, alpha=cfg.alpha,
        sb=cfg.skip_boundary, sub=cfg.subsample,
    )
    # achieved placement (pre-transfer): tests assert the mesh run actually
    # partitioned the patch axis rather than gathering to one device
    n_shard_devices = len({s.device for s in coeffs.addressable_shards})
    C, Q = jax.device_get((coeffs, qual))  # one bundled host read
    C = C[:P_orig]
    Q = np.maximum(Q[:P_orig], 0.0)

    valid = Q > -0.5
    C, Q = C[valid], Q[valid]
    if C.shape[0] < cfg.min_patches:
        raise RuntimeError(f"Too few valid patches ({C.shape[0]} < {cfg.min_patches})")

    # quality-weighted aggregation + variance suppression (patch_based_sindy.py:450-467)
    w = Q / (Q.sum() + 1e-12)
    ens = np.average(C, axis=0, weights=w) if Q.sum() > 0 else C.mean(axis=0)
    std = np.sqrt(np.average((C - ens) ** 2, axis=0, weights=w)) if Q.sum() > 0 else C.std(axis=0)
    thr = np.median(std) * cfg.var_suppress_factor
    ens = np.where(std > thr, 0.0, ens)

    out = {
        "config": dataclasses.asdict(cfg),
        "term_names": TERM_NAMES,
        "coeffs": ens,
        "coeffs_std": std,
        "patch_coeffs": C,
        "n_patches": int(C.shape[0]),
        "n_shard_devices": n_shard_devices,
        "avg_quality": float(Q.mean()),
        "quality_std": float(Q.std()),
    }
    if cfg.write_artifacts:
        out_dir = Path(cfg.output_dir)
        write_json(
            out_dir / "patch_sindy_results.json",
            {k: v for k, v in out.items() if k not in ("config", "patch_coeffs")},
        )
        # per-run results PNG (patch_based_sindy.py:641-642 via :525-572).
        # The figure shows 4 frames: gather them ON DEVICE and read ~20 MB
        # instead of the full f64 stack (~535 MB)
        try:
            from pdx.report.pipeline_figures import (
                patch_sindy_figure_frame_indices,
                patch_sindy_results,
            )
        except ImportError as e:  # matplotlib is optional
            print(f"   (skipped patch_based_sindy_results.png: {e})")
        else:
            fig_idx = patch_sindy_figure_frame_indices(int(U.shape[0]))
            fig_ds = 1
            while (H_ // (2 * fig_ds)) >= 512:
                fig_ds *= 2
            fig_frames = np.asarray(_select_frames_f32(U, tuple(fig_idx), ds=fig_ds))
            patch_sindy_results(
                out_dir, fig_frames, coords, patch_size, ens, std,
                TERM_NAMES, int(C.shape[0]), frame_indices=fig_idx,
                full_shape=(H_, W_),
            )
    return out


def cmd_patch_sindy(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx patch-sindy")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/patch_sindy")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--patch-size", type=int, default=256)
    parser.add_argument("--overlap", type=int, default=64)
    parser.add_argument("--registration", choices=["none", "ecc", "optical_flow"], default="none")
    parser.add_argument("--flow-scope", choices=["patch", "frame"], default="patch",
                        help="optical_flow granularity: per-patch (reference parity) or whole-frame")
    parser.add_argument("--max-patches", type=int, default=None)
    parser.add_argument("--flow-impl", choices=["auto", "compose", "chain"],
                        default="auto",
                        help="per-patch flow execution: chunked compose "
                        "pyramid vs per-time-step chain (auto = compose on "
                        "accelerators, chain on CPU; see "
                        "PatchSindyConfig.flow_compose)")
    args = parser.parse_args(argv)
    out = run(
        PatchSindyConfig(
            data_dir=args.data_dir, output_dir=args.output_dir, max_images=args.max_images,
            patch_size=args.patch_size, overlap=args.overlap,
            registration_method=args.registration, max_patches=args.max_patches,
            flow_scope=args.flow_scope,
            flow_compose={"auto": None, "compose": True, "chain": False}[args.flow_impl],
        )
    )
    print(f"Valid patches: {out['n_patches']}  avg quality: {out['avg_quality']:.4f}")
    print("u_t = ", end="")
    terms = [
        f"{c:+.6e}·{n}"
        for c, n in zip(out["coeffs"], out["term_names"])
        if abs(c) > 1e-7
    ]
    print("  ".join(terms) if terms else "0")
    return 0
