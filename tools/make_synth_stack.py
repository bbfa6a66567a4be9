"""Generate a reference-scale synthetic TIFF stack for wall-clock benchmarks.

The reference's 51 laser-matter TIFFs don't ship; this produces a stack with
the same shape contract (51 frames, ~1024x1280, uint16, sorted *.tif names)
and smooth advecting-diffusing dynamics a PDE fit can capture, so both the
reference scripts (CPU) and the pdx pipelines (GPU) can be timed on
identical inputs.

Usage: python tools/make_synth_stack.py [OUT_DIR] [T] [H] [W]
(OUT_DIR defaults to outputs/synth51 in the repository.)
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def make_stack(T: int = 51, H: int = 1024, W: int = 1280, seed: int = 0) -> np.ndarray:
    """Diffusion + drift + gentle nonlinearity on a periodic FFT grid."""
    rng = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter

    u0 = gaussian_filter(rng.normal(size=(H, W)), 24, mode="wrap")
    u0 = (u0 - u0.min()) / (u0.max() - u0.min())
    kx = 2 * np.pi * np.fft.fftfreq(H)
    ky = 2 * np.pi * np.fft.fftfreq(W)
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    K2 = KX**2 + KY**2
    F0 = np.fft.fft2(u0)
    D, vx, vy = 1.5, 0.6, -0.4
    frames = []
    for t in range(T):
        phase = np.exp(-D * K2 * t - 1j * (KX * vx + KY * vy) * t)
        u = np.fft.ifft2(F0 * phase).real
        # mild saturating nonlinearity + measurement noise, like the real data
        u = u / (1.0 + 0.3 * np.abs(u))
        u = u + 0.002 * rng.normal(size=u.shape)
        frames.append(u)
    U = np.stack(frames)
    U = (U - U.min()) / (U.max() - U.min())
    return (U * 60000).astype(np.uint16)


def main() -> None:
    out = (
        Path(sys.argv[1]) if len(sys.argv) > 1
        else Path(__file__).resolve().parent.parent / "outputs" / "synth51"
    )
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 51
    H = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    W = int(sys.argv[4]) if len(sys.argv) > 4 else 1280
    out.mkdir(parents=True, exist_ok=True)
    from PIL import Image

    U = make_stack(T, H, W)
    for i, frame in enumerate(U):
        Image.fromarray(frame).save(out / f"frame_{i:03d}.tif")
    print(f"wrote {T} frames ({H}x{W} uint16) to {out}")


if __name__ == "__main__":
    main()
