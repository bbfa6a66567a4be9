"""Candidate-term dictionaries Theta(u) as stacked (n_terms, ...) arrays.

Parity targets:
  * KS "true" dictionary {lap u, lap^2 u, |grad u|^2} (+ optional u_x, u_y):
    ``build_dictionary_true`` (ks2d_stridge_benchmark.py:1063-1104);
  * KS "rich" dictionary (true + decoys {1, u, u^2, u_x, u_y, u*lap u}):
    ``build_dictionary`` (ks2d_stridge_benchmark.py:1017-1060);
  * real-image Models 1-6 nested term sets (analyze_results.py:598-624);
  * 13-term registration-study library
    (pde_discovery_improved_registration.py:411-424).

Batched: derivatives are computed for the whole (T, H, W) stack in one call
(roll stencils / batched FFT) — no per-frame loops — and terms are returned as
one stacked array ready for the Gram GEMM.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from pdx.ops.fd import (
    gradients_periodic,
    laplacian_periodic,
    derivs_2d_reflect,
)
from pdx.ops.spectral import gradients_spectral, laplacian_spectral

# Ground-truth KS coefficients (ks2d_stridge_benchmark.py:1786)
KS_GROUND_TRUTH = {"lap": -1.0, "bih": -1.0, "gradsq": -0.5}

# canonical ASCII term keys <-> reference's unicode display names
TERM_DISPLAY = {
    "one": "1",
    "u": "u",
    "u2": "u^2",
    "u3": "u^3",
    "ux": "u_x",
    "uy": "u_y",
    "uxx": "u_xx",
    "uyy": "u_yy",
    "lap": "∇²u",
    "bih": "∇⁴u",
    "gradsq": "|∇u|²",
    "u_lap": "u·∇²u",
    "u_ux": "u·u_x",
    "u_uy": "u·u_y",
    "ux2": "u_x²",
    "uy2": "u_y²",
}


def _ks_derivative_fields(
    U: Array, dx: float, dy: float, *, deriv: str, spectral_cutoff: float
) -> tuple[Array, Array, Array, Array]:
    """(ux, uy, lap, bih) for a (T, H, W) stack, periodic BCs."""
    if deriv == "spectral":
        ux, uy = gradients_spectral(U, dx, dy, cutoff_frac=spectral_cutoff)
        lap = laplacian_spectral(U, dx, dy, cutoff_frac=spectral_cutoff)
        bih = laplacian_spectral(lap, dx, dy, cutoff_frac=spectral_cutoff)
    else:
        ux, uy = gradients_periodic(U, dx, dy)
        lap = laplacian_periodic(U, dx, dy)
        bih = laplacian_periodic(lap, dx, dy)
    return ux, uy, lap, bih


def build_dictionary_true(
    U: Array,
    dx: float,
    dy: float,
    *,
    deriv: str = "finite",
    spectral_cutoff: float = 1.0,
    include_advection: bool = False,
) -> tuple[list[str], Array]:
    """KS true terms. Returns (names, terms[(p, T, H, W)]).

    Parity: ks2d_stridge_benchmark.py:1063-1104 (term order preserved).
    """
    ux, uy, lap, bih = _ks_derivative_fields(U, dx, dy, deriv=deriv, spectral_cutoff=spectral_cutoff)
    gradsq = ux**2 + uy**2
    names = ["lap", "bih", "gradsq"]
    terms = [lap, bih, gradsq]
    if include_advection:
        names += ["ux", "uy"]
        terms += [ux, uy]
    return names, jnp.stack(terms, axis=0)


def build_dictionary_rich(
    U: Array,
    dx: float,
    dy: float,
    *,
    deriv: str = "finite",
    spectral_cutoff: float = 1.0,
    drop_advection: bool = False,
) -> tuple[list[str], Array]:
    """KS rich dictionary: true terms + decoys.

    Parity: ks2d_stridge_benchmark.py:1017-1060 — term order
    [1, u, u^2, u_x, u_y, lap, bih, |grad u|^2, u*lap]; the
    --enforce-no-advection drop removes u_x/u_y (:1536-1539).
    """
    ux, uy, lap, bih = _ks_derivative_fields(U, dx, dy, deriv=deriv, spectral_cutoff=spectral_cutoff)
    gradsq = ux**2 + uy**2
    names = ["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"]
    terms = [jnp.ones_like(U), U, U**2, ux, uy, lap, bih, gradsq, U * lap]
    if drop_advection:
        keep = [i for i, n in enumerate(names) if n not in {"ux", "uy"}]
        names = [names[i] for i in keep]
        terms = [terms[i] for i in keep]
    return names, jnp.stack(terms, axis=0)


# ---------------------------------------------------------------------------
# Real-image model families (non-periodic reflect-padded derivatives)
# ---------------------------------------------------------------------------

# Nested model term sets, parity: analyze_results.py:598-624. Note the
# reference's Model 1 and Model 2 are identical ({1, u, lap}); we preserve
# that quirk deliberately so model numbering and outputs line up.
REAL_MODEL_TERMS: dict[int, list[str]] = {
    1: ["one", "u", "lap"],
    2: ["one", "u", "lap"],
    3: ["one", "u", "ux", "uy", "lap"],
    4: ["one", "u", "ux", "uy", "lap", "u2"],
    5: ["one", "u", "ux", "uy", "uxx", "uyy", "lap", "u2", "u_ux", "u_uy"],
    6: [
        "one",
        "u",
        "ux",
        "uy",
        "uxx",
        "uyy",
        "lap",
        "u2",
        "u_ux",
        "u_uy",
        "u3",
        "ux2",
        "uy2",
    ],
}

# 13-term registration-study library, parity:
# pde_discovery_improved_registration.py:411-424
REGISTRATION_STUDY_TERMS: list[str] = [
    "one",
    "u",
    "ux",
    "uy",
    "uxx",
    "uyy",
    "lap",
    "u2",
    "u_ux",
    "u_uy",
    "u3",
    "ux2",
    "uy2",
]


def real_image_term_fields(U: Array, dx: float, dy: float) -> dict[str, Array]:
    """All scalar fields needed by the real-image model families, computed once
    for the full (T, H, W) stack with reflect-padded central differences
    (analyze_results.py:302-315 derivative convention)."""
    ux, uy, uxx, uyy = derivs_2d_reflect(U, dx, dy)
    lap = uxx + uyy
    return {
        "one": jnp.ones_like(U),
        "u": U,
        "u2": U**2,
        "u3": U**3,
        "ux": ux,
        "uy": uy,
        "uxx": uxx,
        "uyy": uyy,
        "lap": lap,
        "u_ux": U * ux,
        "u_uy": U * uy,
        "ux2": ux**2,
        "uy2": uy**2,
    }


# 25-term 4th-order extended library, parity: notebook 02 cells 8-9
FOURTH_ORDER_TERMS: list[str] = [
    "one", "u", "ux", "uy", "uxx", "uyy", "lap",
    "u2", "u_ux", "u_uy", "ux2", "uy2", "u_uxx", "u_uyy", "u_lap",
    "u3", "u2_ux", "u2_uy", "uxxx", "uyyy",
    "uxxxx", "uyyyy", "bih", "u_uxxxx", "u_uyyyy",
]

FOURTH_ORDER_DISPLAY = {
    **TERM_DISPLAY,
    "u_uxx": "u·u_xx",
    "u_uyy": "u·u_yy",
    "u2_ux": "u²·u_x",
    "u2_uy": "u²·u_y",
    "uxxx": "u_xxx",
    "uyyy": "u_yyy",
    "uxxxx": "u_xxxx",
    "uyyyy": "u_yyyy",
    "u_uxxxx": "u·u_xxxx",
    "u_uyyyy": "u·u_yyyy",
}


def fourth_order_term_fields(U: Array, dx: float, dy: float) -> dict[str, Array]:
    """4th-order-accurate derivative fields for the extended real-image
    library (notebook 02 cell 8, edge-padded): 4th-order central 1st/2nd
    derivatives, 2nd-order 3rd/4th derivatives, same-grid via 3-pixel edge
    padding. Convention: x = cols (axis -1), y = rows (axis -2), matching the
    notebook's axis usage.
    """
    pads = [(0, 0)] * (U.ndim - 2) + [(3, 3), (3, 3)]
    p = jnp.pad(U, pads, mode="edge")

    def roll(f, s, ax):
        return jnp.roll(f, s, axis=ax)

    # 4th-order first derivatives on the padded grid, then crop
    ux = (-roll(p, -2, -1) + 8 * roll(p, -1, -1) - 8 * roll(p, 1, -1) + roll(p, 2, -1)) / (12 * dx)
    uy = (-roll(p, -2, -2) + 8 * roll(p, -1, -2) - 8 * roll(p, 1, -2) + roll(p, 2, -2)) / (12 * dy)
    uxx = (-roll(p, -2, -1) + 16 * roll(p, -1, -1) - 30 * p + 16 * roll(p, 1, -1) - roll(p, 2, -1)) / (12 * dx**2)
    uyy = (-roll(p, -2, -2) + 16 * roll(p, -1, -2) - 30 * p + 16 * roll(p, 1, -2) - roll(p, 2, -2)) / (12 * dy**2)
    crop = (slice(None),) * (U.ndim - 2) + (slice(3, -3), slice(3, -3))
    ux, uy, uxx, uyy = ux[crop], uy[crop], uxx[crop], uyy[crop]

    # 2nd-order 3rd/4th derivatives with periodic rolls on the raw field
    # (notebook quirk: these use np.roll on the unpadded array)
    uxxx = (roll(U, -2, -1) - 2 * roll(U, -1, -1) + 2 * roll(U, 1, -1) - roll(U, 2, -1)) / (2 * dx**3)
    uyyy = (roll(U, -2, -2) - 2 * roll(U, -1, -2) + 2 * roll(U, 1, -2) - roll(U, 2, -2)) / (2 * dy**3)
    uxxxx = (roll(U, -2, -1) - 4 * roll(U, -1, -1) + 6 * U - 4 * roll(U, 1, -1) + roll(U, 2, -1)) / dx**4
    uyyyy = (roll(U, -2, -2) - 4 * roll(U, -1, -2) + 6 * U - 4 * roll(U, 1, -2) + roll(U, 2, -2)) / dy**4

    lap = uxx + uyy
    return {
        "one": jnp.ones_like(U),
        "u": U,
        "ux": ux,
        "uy": uy,
        "uxx": uxx,
        "uyy": uyy,
        "lap": lap,
        "u2": U**2,
        "u_ux": U * ux,
        "u_uy": U * uy,
        "ux2": ux**2,
        "uy2": uy**2,
        "u_uxx": U * uxx,
        "u_uyy": U * uyy,
        "u_lap": U * lap,
        "u3": U**3,
        "u2_ux": U**2 * ux,
        "u2_uy": U**2 * uy,
        "uxxx": uxxx,
        "uyyy": uyyy,
        "uxxxx": uxxxx,
        "uyyyy": uyyyy,
        "bih": uxxxx + uyyyy,
        "u_uxxxx": U * uxxxx,
        "u_uyyyy": U * uyyyy,
    }


def stack_terms(fields: dict[str, Array], names: list[str]) -> Array:
    """Stack named fields into a (p, ...) term array."""
    return jnp.stack([fields[n] for n in names], axis=0)


def display_names(names: list[str]) -> list[str]:
    return [TERM_DISPLAY.get(n, n) for n in names]
