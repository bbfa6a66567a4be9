"""Weak-form dataset builder (integrated identity against test functions).

Parity: build_weakform_dataset + _fourier_test_functions +
_gaussian_test_functions (ks2d_stridge_benchmark.py:164-355):

  y[t, j]   = (<phi_j, u_{t+1}> - <phi_j, u_t>) / DT
  X_lap     = -k^2 <phi, u>     (Fourier, integration by parts)  or <lap phi, u>
  X_bih     = +k^4 <phi, u>                                     or <bih phi, u>
  X_gsq     = <phi, |grad u|^2>  with spectral low-pass gradients
  optional motion correction: y -= vx <u, phi_x> + vy <u, phi_y>

Batched: the inner products are exactly one GEMM S = area * U_flat @ Phi^T
(the reference already vectorizes this at :285-291); the nonlinear feature's
per-frame FFT loop (:346-350) becomes one batched FFT + one GEMM.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.spectral import gradients_spectral, laplacian_spectral
from pdx.ops.filters import smooth_1d
from pdx.register.phasecorr import estimate_interframe_shifts


def fourier_test_functions(
    nx: int, ny: int, lx: float, ly: float, *, max_k: int, dtype=np.float64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(phis[(P, nx, ny)], k2[(P,)], k4[(P,)]) — cos/sin pairs for all
    (m, n) in [0, max_k]^2 \\ {(0,0)} (ks2d_stridge_benchmark.py:164-202)."""
    x = np.linspace(0.0, lx, nx, endpoint=False)
    y = np.linspace(0.0, ly, ny, endpoint=False)
    X, Y = np.meshgrid(x, y, indexing="ij")
    phis, k2s, k4s = [], [], []
    for m in range(0, int(max_k) + 1):
        for n in range(0, int(max_k) + 1):
            if m == 0 and n == 0:
                continue
            kx = 2.0 * np.pi * m / float(lx)
            ky = 2.0 * np.pi * n / float(ly)
            k2 = float(kx**2 + ky**2)
            phase = kx * X + ky * Y
            phis.append(np.cos(phase))
            phis.append(np.sin(phase))
            k2s += [k2, k2]
            k4s += [k2 * k2, k2 * k2]
    return (
        np.stack(phis).astype(dtype),
        np.asarray(k2s, dtype=dtype),
        np.asarray(k4s, dtype=dtype),
    )


def gaussian_test_functions(
    nx: int, ny: int, *, n_phi: int, sigma_px: float, seed: int = 123, dtype=np.float64
) -> np.ndarray:
    """L2-normalized periodic Gaussian bumps at uniform random centers
    (ks2d_stridge_benchmark.py:205-235; rng = default_rng(123) per reference
    main's call site :275-276)."""
    sigma_px = float(sigma_px)
    if sigma_px <= 0:
        raise ValueError("gaussian test functions need a positive sigma_px")
    rng = np.random.default_rng(seed)
    x = np.arange(nx, dtype=np.float64)
    y = np.arange(ny, dtype=np.float64)
    X, Y = np.meshgrid(x, y, indexing="ij")
    phis = []
    for _ in range(int(n_phi)):
        cx = float(rng.uniform(0, nx))
        cy = float(rng.uniform(0, ny))
        dxp = np.minimum(np.abs(X - cx), nx - np.abs(X - cx))
        dyp = np.minimum(np.abs(Y - cy), ny - np.abs(Y - cy))
        phi = np.exp(-0.5 * (dxp**2 + dyp**2) / (sigma_px**2))
        norm = float(np.sqrt(np.sum(phi**2)))
        if norm > 0:
            phi = phi / norm
        phis.append(phi)
    return np.stack(phis).astype(dtype)


def build_weakform_dataset(
    U: Array,
    *,
    dx: float,
    dy: float,
    dt_frame: float,
    lx: float,
    ly: float,
    max_k: int = 3,
    basis: str = "gaussian",
    n_phi: int = 64,
    sigma_px: float = 6.0,
    grad_cutoff: float | None = None,
    motion_correct: bool = False,
    motion_est_sigma_px: float = 0.0,
    motion_smooth_window: int = 1,
    motion_clip_px: float | None = None,
    dictionary: str = "true",
    operator: str = "spectral",
) -> tuple[list[str], Array, Array]:
    """Returns (names, X[(T-1)*P, p], y[(T-1)*P]).

    dictionary='true' reproduces the reference exactly (terms
    [lap, bih, gradsq]). dictionary='rich' LIFTS the reference's documented
    limitation (ks2d_stridge_benchmark.py:1473-1474 restricts weakform to the
    true dictionary): every rich decoy is expressed with derivatives moved
    onto the test functions by integration by parts —

        <phi, 1>        constant per phi
        <phi, u>        = S (the base projection)
        <phi, u^2>      one extra GEMM
        <phi, u_x>      = -<phi_x, u>
        <phi, u_y>      = -<phi_y, u>
        <phi, u lap u>  = 1/2 <lap phi, u^2> - <phi, |grad u|^2>

    so only the |grad u|^2 feature ever differentiates the (noisy) data.

    operator='spectral' (default) reproduces the reference's quadrature
    (FFT derivatives, k-space low-pass on the gradient); grad_cutoff sets
    that low-pass and applies to spectral mode ONLY — combining a
    non-default grad_cutoff with operator='fd' raises. operator='fd'
    builds DISCRETE-ADJOINT columns instead: the same periodic 5-point/
    central stencils the FD simulators integrate with, applied to the test
    functions (the stencils are self-adjoint, gradients anti-self-adjoint
    on the periodic grid). When the data came from an FD discretization the
    weak identity then holds exactly per Euler substep — on clean
    save_every=1 data the rich dictionary recovers the KS support to
    machine precision, and under 3% noise it still recovers the exact
    support (see docs/RESULTS.md), which the reference's weak form cannot
    attempt (true-dictionary-only, ks2d_stridge_benchmark.py:1473-1474)."""
    if U.ndim != 3:
        raise ValueError("expected a (T, Nx, Ny) frame stack")
    t_len, nx, ny = U.shape
    if t_len < 2:
        raise ValueError("weak-form targets need >= 2 frames")
    dtype = U.dtype

    if basis == "fourier":
        phi_np, k2_np, k4_np = fourier_test_functions(nx, ny, lx, ly, max_k=max_k)
        phi = jnp.asarray(phi_np, dtype=dtype)
        k2 = jnp.asarray(k2_np, dtype=dtype)
        k4 = jnp.asarray(k4_np, dtype=dtype)
    elif basis == "gaussian":
        phi = jnp.asarray(gaussian_test_functions(nx, ny, n_phi=n_phi, sigma_px=sigma_px), dtype=dtype)
    else:
        raise ValueError("unknown weak-form basis: use 'fourier' or 'gaussian'")

    if operator == "fd":
        # FD stencils have no spectral-cutoff concept: grad_cutoff cannot
        # apply in fd mode. None = "caller left the default"; any explicit
        # value is rejected loudly instead of silently ignored.
        if grad_cutoff is not None:
            raise ValueError(
                "grad_cutoff only applies to operator='spectral'; "
                "fd-mode gradients are plain central stencils (leave "
                "grad_cutoff=None with operator='fd')"
            )
    elif operator != "spectral":
        raise ValueError("weakform operator must be 'spectral' or 'fd'")
    if dictionary not in ("true", "rich"):
        raise ValueError("weakform dictionary must be 'true' or 'rich'")

    if basis != "fourier":
        k2 = k4 = jnp.zeros((phi.shape[0],), dtype=dtype)
    X, y = _build_device(
        U, phi, k2, k4,
        dx=float(dx), dy=float(dy), dt_frame=float(dt_frame),
        basis=basis, operator=operator, dictionary=dictionary,
        cutoff=float(0.65 if grad_cutoff is None else grad_cutoff),
        motion_correct=bool(motion_correct),
        motion_est_sigma_px=float(motion_est_sigma_px),
        motion_smooth_window=int(motion_smooth_window),
        motion_clip_px=None if motion_clip_px is None else float(motion_clip_px),
    )
    if dictionary == "true":
        names = ["lap", "bih", "gradsq"]
    else:
        names = ["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"]
    return names, X, y


@partial(
    jax.jit,
    static_argnames=(
        "dx", "dy", "dt_frame", "basis", "operator", "dictionary", "cutoff",
        "motion_correct", "motion_est_sigma_px", "motion_smooth_window",
        "motion_clip_px",
    ),
)
def _build_device(
    U, phi, k2, k4, *, dx, dy, dt_frame, basis, operator, dictionary,
    cutoff, motion_correct, motion_est_sigma_px, motion_smooth_window,
    motion_clip_px,
):
    """The whole weak-form dataset build as ONE device program.

    The eager formulation dispatched each GEMM / FFT / elementwise step
    separately (~25 dispatches). All branches are static, so each
    (basis, operator, dictionary) combination compiles once."""
    t_len = U.shape[0]

    if operator == "fd":
        from pdx.ops.fd import gradients_periodic, laplacian_periodic

        def d_grad(f, cutoff_frac=1.0):
            return gradients_periodic(f, dx, dy)

        def d_lap(f):
            return laplacian_periodic(f, dx, dy)

    else:

        def d_grad(f, cutoff_frac=1.0):
            return gradients_spectral(f, dx, dy, cutoff_frac=float(cutoff_frac))

        def d_lap(f):
            return laplacian_spectral(f, dx, dy, cutoff_frac=1.0)

    P = phi.shape[0]
    area = float(dx * dy)
    phi_flat = phi.reshape(P, -1)  # (P, N)
    U_flat = U.reshape(t_len, -1)  # (T, N)
    S = area * (U_flat @ phi_flat.T)  # (T, P)
    y = (S[1:] - S[:-1]) / float(dt_frame)  # (T-1, P)

    if motion_correct:
        sx_px, sy_px = estimate_interframe_shifts(U, estimate_sigma_px=float(motion_est_sigma_px))
        sx_px = smooth_1d(sx_px, window=int(motion_smooth_window))
        sy_px = smooth_1d(sy_px, window=int(motion_smooth_window))
        if motion_clip_px is not None and float(motion_clip_px) > 0:
            c = float(motion_clip_px)
            sx_px = jnp.clip(sx_px, -c, c)
            sy_px = jnp.clip(sy_px, -c, c)
        vx = (-sx_px * float(dx)) / float(dt_frame)
        vy = (-sy_px * float(dy)) / float(dt_frame)
        phi_x, phi_y = d_grad(phi)
        U_phi_x = area * (U_flat[:-1] @ phi_x.reshape(P, -1).T)
        U_phi_y = area * (U_flat[:-1] @ phi_y.reshape(P, -1).T)
        y = y - (vx[:, None] * U_phi_x + vy[:, None] * U_phi_y)

    if basis == "fourier" and operator == "spectral":
        X_lap = -S[:-1] * k2[None, :]
        X_bih = S[:-1] * k4[None, :]
    else:
        lap_phi = d_lap(phi)
        bih_phi = d_lap(lap_phi)
        X_lap = area * (U_flat[:-1] @ lap_phi.reshape(P, -1).T)
        X_bih = area * (U_flat[:-1] @ bih_phi.reshape(P, -1).T)

    # nonlinear feature: <phi, |grad u|^2> — batched FFT (spectral) or one
    # stencil pass (fd) over the frame axis
    ux, uy = d_grad(U[:-1], cutoff_frac=cutoff)
    gs = (ux**2 + uy**2).reshape(t_len - 1, -1)
    X_gsq = area * (gs @ phi_flat.T)

    if dictionary == "true":
        X = jnp.stack([X_lap.reshape(-1), X_bih.reshape(-1), X_gsq.reshape(-1)], axis=1)
        return X, y.reshape(-1)

    Tm1 = t_len - 1
    ones_col = jnp.broadcast_to(area * jnp.sum(phi_flat, axis=1)[None, :], (Tm1, P))
    S_u = S[:-1]
    U2_flat = (U[:-1] ** 2).reshape(Tm1, -1)
    S_u2 = area * (U2_flat @ phi_flat.T)
    phi_x, phi_y = d_grad(phi)
    X_ux = -area * (U_flat[:-1] @ phi_x.reshape(P, -1).T)
    X_uy = -area * (U_flat[:-1] @ phi_y.reshape(P, -1).T)
    if operator == "fd":
        # direct quadrature with the same stencil the FD simulators use —
        # keeps the decoy column consistent with the data's discretization
        # (the IBP identity below mixes quadratures and lets the solver
        # exploit their mismatch; see docs/RESULTS.md)
        ulap = (U[:-1] * d_lap(U[:-1])).reshape(Tm1, -1)
        X_ulap = area * (ulap @ phi_flat.T)
    else:
        if basis == "fourier":
            lap_phi = laplacian_spectral(phi, dx, dy, cutoff_frac=1.0)
        S_lap_u2 = area * (U2_flat @ lap_phi.reshape(P, -1).T)
        X_ulap = 0.5 * S_lap_u2 - X_gsq

    cols = [ones_col, S_u, S_u2, X_ux, X_uy, X_lap, X_bih, X_gsq, X_ulap]
    X = jnp.stack([c.reshape(-1) for c in cols], axis=1)
    return X, y.reshape(-1)
