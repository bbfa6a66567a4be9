"""2-D Kuramoto-Sivashinsky simulators (explicit Euler and spectral ETD).

  u_t = -lap(u) - lap^2(u) - 0.5 |grad u|^2   on a periodic box

Parity targets:
  * explicit Euler with FD stencils and per-step nan_to_num guard:
    ``ks2d_stridge_benchmark.py:751-782`` (SimConfig / simulate / ks_rhs);
  * integrating-factor pseudo-spectral stepper: notebook 08 cell 0.

Design: the time loop is a single ``lax.scan`` compiled once; frames
are emitted from the scan (no host round-trips). The initial condition is
drawn on the host with numpy's Philox-free default_rng to preserve bit-exact
parity with the reference's ``default_rng(seed).uniform``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import Array

from pdx.ops.fd import gradients_periodic, laplacian_periodic


@dataclass(frozen=True)
class Ks2dConfig:
    """Parity: SimConfig (ks2d_stridge_benchmark.py:751-760)."""

    Lx: float = 50.0
    Ly: float = 50.0
    Nx: int = 100
    Ny: int = 100
    dt: float = 1e-3
    n_seconds: float = 2.0
    save_every: int = 1
    seed: int = 42

    @property
    def dx(self) -> float:
        return self.Lx / self.Nx

    @property
    def dy(self) -> float:
        return self.Ly / self.Ny

    @property
    def total_steps(self) -> int:
        return int(self.n_seconds / self.dt)

    @property
    def n_frames(self) -> int:
        return self.total_steps // self.save_every

    @property
    def DT(self) -> float:
        return self.dt * self.save_every


def ks_rhs(u: Array, dx: float, dy: float) -> Array:
    """KS right-hand side via periodic FD stencils (ks2d_stridge_benchmark.py:118-122)."""
    lap = laplacian_periodic(u, dx, dy)
    bih = laplacian_periodic(lap, dx, dy)
    ux, uy = gradients_periodic(u, dx, dy)
    return -lap - bih - 0.5 * (ux**2 + uy**2)


def initial_condition(cfg: Ks2dConfig, dtype=None) -> np.ndarray:
    """Host-side IC: uniform(-0.1, 0.1) from np.random.default_rng(seed)
    (ks2d_stridge_benchmark.py:770-771) for bit-exact parity."""
    rng = np.random.default_rng(cfg.seed)
    u0 = rng.uniform(-0.1, 0.1, size=(cfg.Nx, cfg.Ny))
    return u0.astype(dtype or np.result_type(float(1.0)))


def simulate_ks2d(cfg: Ks2dConfig, u0: Array | None = None, dtype=None) -> tuple[Array, float, float, float]:
    """Explicit-Euler KS-2D under lax.scan. Returns (U[(n_frames, Nx, Ny)], dx, dy, DT).

    Matches the reference's frame-saving convention exactly: the state is
    advanced, nan_to_num-guarded, and saved whenever ``step % save_every == 0``
    (ks2d_stridge_benchmark.py:775-780) — i.e. frame 0 is the state after one
    Euler step.
    """
    dtype = dtype or jnp.result_type(float)
    if u0 is None:
        u0 = jnp.asarray(initial_condition(cfg), dtype=dtype)
    else:
        u0 = jnp.asarray(u0, dtype=dtype)
    dx, dy = cfg.dx, cfg.dy
    dt = jnp.asarray(cfg.dt, dtype=dtype)
    se = cfg.save_every

    def euler_step(u, _):
        u = u + dt * ks_rhs(u, dx, dy)
        u = jnp.nan_to_num(u)
        return u, None

    if se == 1:
        def step_and_save(u, _):
            u, _ = euler_step(u, None)
            return u, u

        _, U = jax.lax.scan(step_and_save, u0, None, length=cfg.total_steps)
    else:
        # One frame per outer scan step: advance once (the saved state), then
        # advance save_every-1 more to land on the next multiple.
        def outer(u, _):
            u, _ = euler_step(u, None)
            saved = u
            u, _ = jax.lax.scan(euler_step, u, None, length=se - 1)
            return u, saved

        _, U = jax.lax.scan(outer, u0, None, length=cfg.n_frames)

    return U, dx, dy, cfg.DT


# ---------------------------------------------------------------------------
# Pseudo-spectral integrating-factor stepper (notebook 08 cell 0)
# ---------------------------------------------------------------------------


def simulate_ks2d_spectral(
    cfg: Ks2dConfig, u0: Array | None = None, dtype=None
) -> tuple[Array, float, float, float]:
    """Integrating-factor Euler: exact linear step exp((k^2 - k^4) dt) in
    Fourier space + pseudospectral nonlinear term (notebook 08 cell 0).

    The stiff 4th-order linear operator is handled exactly, so dt can be much
    larger than the explicit Euler stepper tolerates — this is the preferred
    generator for long trajectories.
    """
    dtype = dtype or jnp.result_type(float)
    if u0 is None:
        u0 = jnp.asarray(initial_condition(cfg), dtype=dtype)
    else:
        u0 = jnp.asarray(u0, dtype=dtype)
    dx, dy = cfg.dx, cfg.dy
    nx, ny = cfg.Nx, cfg.Ny
    kx = 2.0 * jnp.pi * jnp.fft.fftfreq(nx, d=dx)
    ky = 2.0 * jnp.pi * jnp.fft.rfftfreq(ny, d=dy)
    KX, KY = jnp.meshgrid(kx, ky, indexing="ij")
    K2 = KX**2 + KY**2
    L = K2 - K2**2  # -(-k^2) - (k^4): linear symbol of -lap - lap^2
    E = jnp.exp(cfg.dt * L)

    def nonlinear(u):
        ux = jnp.fft.irfft2(1j * KX * jnp.fft.rfft2(u), s=(nx, ny))
        uy = jnp.fft.irfft2(1j * KY * jnp.fft.rfft2(u), s=(nx, ny))
        return -0.5 * (ux**2 + uy**2)

    def step(uh, _):
        u = jnp.fft.irfft2(uh, s=(nx, ny))
        Nh = jnp.fft.rfft2(nonlinear(u))
        uh = E * (uh + cfg.dt * Nh)
        return uh, None

    se = cfg.save_every

    def outer(uh, _):
        uh, _ = jax.lax.scan(step, uh, None, length=se)
        return uh, jnp.fft.irfft2(uh, s=(nx, ny))

    uh0 = jnp.fft.rfft2(u0)
    _, U = jax.lax.scan(outer, uh0, None, length=cfg.n_frames)
    return U.astype(dtype), dx, dy, cfg.DT
