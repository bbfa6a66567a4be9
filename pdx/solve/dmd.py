"""Dynamic Mode Decomposition denoisers/preconditioners.

Parity: standard_dmd / multiscale_dmd / sparse_dmd
(comprehensive_benchmark.py:245-321) — DMD reconstruction used as a denoiser
before SINDy (methods M12-M17, M20-M21).

Host/device split: complex dtypes never touch the device (the accelerator
this was first built for had no complex transfers or complex eig). The (pixels x frames) SVD
and every large GEMM run on device as REAL ops — a complex product
``M @ W`` becomes the real pair ``(M @ Re W, M @ Im W)``, the complex
least-squares for the amplitudes becomes the standard real 2Nx2r stacking
``[[Pr, -Pi], [Pi, Pr]] [br; bi] = [x0; 0]`` (same minimum-norm solution),
and the reconstruction ``Re(Phi C)`` becomes ``Pr @ Re C - Pi @ Im C``. Only
the r x r eigendecomposition and the r x T Vandermonde run on the host in
complex arithmetic (rank <= 50: microscopic). All device stages are jitted
(one program per stage instead of an eager dispatch per op).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array


@partial(jax.jit, static_argnames=("r",))
def _dmd_project(X1: Array, X2: Array, r: int):
    """SVD-projected operator: returns M = X2 Vh^T diag(1/s) (N, r) and
    Atilde = U^T M (r, r), both real."""
    U, s, Vh = jnp.linalg.svd(X1, full_matrices=False)
    U, s, Vh = U[:, :r], s[:r], Vh[:r, :]
    if jnp.dtype(X1.dtype).itemsize >= 8:
        floor = 1e-10  # reference semantics (comprehensive_benchmark.py:252)
    else:
        # f32: singular values below ~eps*s_max are pure rounding noise; the
        # reference's absolute 1e-10 floor would amplify them by ~1e10 and
        # NaN the reconstruction on clean (numerically low-rank) data
        floor = s[0] * jnp.finfo(X1.dtype).eps * 100.0
    s_reg = jnp.where(s > floor, s, floor)
    M = X2 @ Vh.T @ jnp.diag(1.0 / s_reg)
    return M, U.T @ M


@jax.jit
def _dmd_modes_and_amplitudes(M: Array, W_re: Array, W_im: Array, x0: Array):
    """Phi = M @ W (as a real pair) and the complex amplitudes b solving
    min ||Phi b - x0||^2 via the real 2N x 2r stacking."""
    Phi_re = M @ W_re
    Phi_im = M @ W_im
    A = jnp.concatenate(
        [
            jnp.concatenate([Phi_re, -Phi_im], axis=1),
            jnp.concatenate([Phi_im, Phi_re], axis=1),
        ],
        axis=0,
    )
    rhs = jnp.concatenate([x0, jnp.zeros_like(x0)])
    sol, *_ = jnp.linalg.lstsq(A, rhs)
    r = W_re.shape[1]
    return Phi_re, Phi_im, sol[:r], sol[r:]


@jax.jit
def _dmd_reconstruct(Phi_re: Array, Phi_im: Array, C_re: Array, C_im: Array):
    """recon[:, t] = Re(Phi @ C[:, t]) with C the complex Vandermonde rollup."""
    return Phi_re @ C_re - Phi_im @ C_im


@partial(jax.jit, static_argnames=("r",))
def _dmd_prep(data: Array, r: int):
    """Snapshot split + SVD projection as ONE program: the eager
    reshape/transpose/slice chain was ~4 dispatches per DMD call."""
    T = data.shape[0]
    X = data.reshape(T, -1).T
    M, Atilde = _dmd_project(X[:, :-1], X[:, 1:], r)
    return M, Atilde, X[:, 0]


@partial(jax.jit, static_argnames=("H", "W"))
def _dmd_stack(Phi_re: Array, Phi_im: Array, C_re: Array, C_im: Array, H: int, W: int):
    """Reconstruct and reshape back to the (T, H, W) stack in one program."""
    recon = Phi_re @ C_re - Phi_im @ C_im  # (N, T)
    return recon.T.reshape(-1, H, W)


def _vandermonde(eigvals: np.ndarray, b: np.ndarray, T: int) -> np.ndarray:
    """Host: C[:, t] = b * eigvals**t, complex (r, T)."""
    t_pow = eigvals[None, :] ** np.arange(T)[:, None]  # (T, r)
    return (b[None, :] * t_pow).T  # (r, T)


def standard_dmd(data: Array, rank: int | None = None) -> Array:
    """Exact-DMD reconstruction of a (T, H, W) stack.

    Parity: comprehensive_benchmark.py:245-270 — SVD of X1, projected
    operator Atilde, eigen-modes Phi, initial amplitudes b from lstsq, and a
    Vandermonde rollup over frames.
    """
    T, H, W = data.shape
    r = min(rank or (T - 1), T - 1, T - 2)
    M, Atilde, x0 = _dmd_prep(data, r)

    eigvals, Wm = np.linalg.eig(np.asarray(Atilde))  # host: tiny complex eig
    W_re = jnp.asarray(np.ascontiguousarray(Wm.real), dtype=data.dtype)
    W_im = jnp.asarray(np.ascontiguousarray(Wm.imag), dtype=data.dtype)

    Phi_re, Phi_im, b_re, b_im = _dmd_modes_and_amplitudes(M, W_re, W_im, x0)
    b = np.asarray(b_re) + 1j * np.asarray(b_im)

    C = _vandermonde(eigvals, b, T)
    C_re = jnp.asarray(np.ascontiguousarray(C.real), dtype=data.dtype)
    C_im = jnp.asarray(np.ascontiguousarray(C.imag), dtype=data.dtype)
    return _dmd_stack(Phi_re, Phi_im, C_re, C_im, H, W)


@partial(jax.jit, static_argnames=("cutoff",))
def _frequency_split(data: Array, cutoff: float):
    H, W = data.shape[-2], data.shape[-1]
    kx = jnp.fft.fftfreq(H)
    ky = jnp.fft.fftfreq(W)
    KX, KY = jnp.meshgrid(kx, ky, indexing="ij")
    K = jnp.sqrt(KX**2 + KY**2)
    low_mask = (K < cutoff).astype(data.dtype)
    F = jnp.fft.fft2(data)
    u_low = jnp.fft.ifft2(F * low_mask).real
    u_high = jnp.fft.ifft2(F * (1.0 - low_mask)).real
    return u_low, u_high


def multiscale_dmd(data: Array, low_rank: int = 5, high_rank: int = 15, cutoff: float = 0.1) -> Array:
    """Frequency-split DMD (comprehensive_benchmark.py:272-295): FFT low/high
    separation at |k| < cutoff, separate DMD ranks, recombine."""
    u_low, u_high = _frequency_split(data, cutoff)
    return standard_dmd(u_low, rank=low_rank) + standard_dmd(u_high, rank=high_rank)


def sparse_dmd(data: Array, rank: int = 20, sparsity: float = 0.1) -> Array:
    """Mode-energy percentile selection DMD (comprehensive_benchmark.py:297-321).

    The reference keeps the top (1-sparsity) modes by total |Phi| energy; mode
    selection happens on the host (percentile + boolean mask give a
    data-dependent shape), then the kept modes are re-fit on device.
    """
    T, H, W = data.shape
    r = min(rank, T - 1)
    M, Atilde, x0 = _dmd_prep(data, r)

    eigvals, Wm = np.linalg.eig(np.asarray(Atilde))
    Phi = np.asarray(M) @ Wm  # (N, r) complex, host

    mode_energies = np.abs(Phi).sum(axis=0)
    thr = np.percentile(mode_energies, 100 * (1 - sparsity))
    keep = mode_energies >= thr
    Phi_k, eig_k = Phi[:, keep], eigvals[keep]

    Pr = jnp.asarray(np.ascontiguousarray(Phi_k.real), dtype=data.dtype)
    Pi = jnp.asarray(np.ascontiguousarray(Phi_k.imag), dtype=data.dtype)
    b_re, b_im = _lstsq_complex_real(Pr, Pi, x0)
    b = np.asarray(b_re) + 1j * np.asarray(b_im)

    C = _vandermonde(eig_k, b, T)
    return _dmd_stack(
        Pr, Pi,
        jnp.asarray(np.ascontiguousarray(C.real), dtype=data.dtype),
        jnp.asarray(np.ascontiguousarray(C.imag), dtype=data.dtype),
        H, W,
    )


@jax.jit
def _lstsq_complex_real(Phi_re: Array, Phi_im: Array, x0: Array):
    """min ||Phi b - x0|| for complex b with real x0, as a real 2N x 2r solve."""
    A = jnp.concatenate(
        [
            jnp.concatenate([Phi_re, -Phi_im], axis=1),
            jnp.concatenate([Phi_im, Phi_re], axis=1),
        ],
        axis=0,
    )
    rhs = jnp.concatenate([x0, jnp.zeros_like(x0)])
    sol, *_ = jnp.linalg.lstsq(A, rhs)
    r = Phi_re.shape[1]
    return sol[:r], sol[r:]
