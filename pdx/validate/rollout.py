"""One-step prediction and k-step explicit-Euler rollout validation.

Parity targets:
  * one_step_prediction_rmse (analyze_results.py:157-186);
  * rollout_k_rmse (analyze_results.py:348-393) — k Euler steps from every
    valid start time, RMSE/nRMSE on an optional spatial mask;
  * KS benchmark rollout (ks2d_stridge_benchmark.py:1805-1838).

Batched: the reference's double Python loop (start times x k steps x
per-frame stencils) becomes ``vmap`` over start frames and ``lax.scan`` over
steps — one compiled dispatch per (model, k_max) instead of
O(T * k * models) interpreted stencil passes.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from pdx.library.dictionaries import real_image_term_fields
from pdx.ops.fd import gradients_periodic, laplacian_periodic


def make_rhs_periodic(names: list[str], coeffs: Array, dx: float, dy: float) -> Callable[[Array], Array]:
    """Term-map RHS with periodic FD derivatives (KS benchmark rollout,
    ks2d_stridge_benchmark.py:1805-1827)."""

    def rhs(u: Array) -> Array:
        ux, uy = gradients_periodic(u, dx, dy)
        lap = laplacian_periodic(u, dx, dy)
        bih = laplacian_periodic(lap, dx, dy)
        vals = {
            "one": jnp.ones_like(u),
            "u": u,
            "u2": u**2,
            "ux": ux,
            "uy": uy,
            "lap": lap,
            "bih": bih,
            "gradsq": ux**2 + uy**2,
            "u_lap": u * lap,
        }
        out = jnp.zeros_like(u)
        for name, c in zip(names, coeffs):
            out = out + c * vals[name]
        return out

    return rhs


def make_rhs_reflect(names: list[str], coeffs: Array, dx: float, dy: float) -> Callable[[Array], Array]:
    """Term-map RHS with reflect-padded derivatives (real-image rollout,
    analyze_results.py:318-345)."""

    def rhs(u: Array) -> Array:
        fields = real_image_term_fields(u, dx, dy)
        out = jnp.zeros_like(u)
        for name, c in zip(names, coeffs):
            out = out + c * fields[name]
        return out

    return rhs


def make_rhs_fourth_order(names: list[str], coeffs: Array, dx: float, dy: float) -> Callable[[Array], Array]:
    """Term-map RHS for the 25-term 4th-order extended library (notebook 02)."""
    from pdx.library.dictionaries import fourth_order_term_fields

    def rhs(u: Array) -> Array:
        fields = fourth_order_term_fields(u, dx, dy)
        out = jnp.zeros_like(u)
        for name, c in zip(names, coeffs):
            out = out + c * fields[name]
        return out

    return rhs


def one_step_prediction_rmse(
    u_field: Array,
    ut_pred: Array,
    dt: float = 1.0,
    spatial_mask: Array | None = None,
) -> Array:
    """u(t+1) ~ u(t) + dt * ut_pred(t); RMSE over all forward pairs."""
    t_max = min(u_field.shape[0] - 1, ut_pred.shape[0])
    u0 = u_field[:t_max]
    u1 = u_field[1 : t_max + 1]
    err = (u1 - (u0 + dt * ut_pred[:t_max])) ** 2
    if spatial_mask is not None:
        m = jnp.broadcast_to(spatial_mask, err.shape)
        return jnp.sqrt(jnp.sum(err * m) / jnp.sum(m))
    return jnp.sqrt(jnp.mean(err))


def rollout_predict(rhs: Callable[[Array], Array], u0: Array, k: int, dt: float) -> Array:
    """k explicit-Euler steps from u0 (scan)."""

    def step(u, _):
        return u + dt * rhs(u), None

    u, _ = jax.lax.scan(step, u0, None, length=int(k))
    return u


def rollout_trajectories(
    rhs: Callable[[Array], Array], starts: Array, k_max: int, dt: float
) -> Array:
    """All intermediate rollout states for a batch of start frames.

    Returns (k_max, n_starts, H, W): step j holds u(t0 + j + 1) predictions.
    vmap over starts + scan over steps — the entire rollout curve for every
    horizon comes from one dispatch.
    """

    def step(u, _):
        u_next = u + dt * jax.vmap(rhs)(u)
        return u_next, u_next

    _, traj = jax.lax.scan(step, starts, None, length=int(k_max))
    return traj


def rollout_k_rmse(
    u_true: Array,
    rhs: Callable[[Array], Array],
    k: int,
    t0: int,
    t1: int,
    dt: float,
    spatial_mask: Array | None = None,
) -> dict[str, Array]:
    """k-step rollout RMSE over start times t in [t0, t1-k) — reference
    enumeration (analyze_results.py:364-393)."""
    if k <= 0 or (t1 - t0) <= k:
        nan = jnp.asarray(jnp.nan, dtype=u_true.dtype)
        return {"rmse": nan, "nrmse": nan}
    starts = u_true[t0 : t1 - k]
    traj = rollout_trajectories(rhs, starts, k, dt)  # (k, n, H, W)
    preds = traj[-1]
    targets = u_true[t0 + k : t1]
    diff2 = (targets - preds) ** 2
    if spatial_mask is not None:
        m = jnp.broadcast_to(spatial_mask, diff2.shape)
        msum = jnp.sum(m)
        rm = jnp.sqrt(jnp.sum(diff2 * m) / msum)
        tsel = targets * m
        tmean = jnp.sum(tsel) / msum
        tstd = jnp.sqrt(jnp.sum(((targets - tmean) ** 2) * m) / msum)
    else:
        rm = jnp.sqrt(jnp.mean(diff2))
        tstd = jnp.std(targets)
    return {"rmse": rm, "nrmse": rm / (tstd + 1e-12)}


from functools import partial


@partial(jax.jit, static_argnames=("term_set", "k", "t0", "t1", "masked", "dx", "dy"))
def _rollout_k_dense(u_true, coeffs, dt, spatial_mask, *, term_set, k, t0, t1, masked, dx, dy):
    if term_set == "real13":
        from pdx.library.dictionaries import real_image_term_fields as fields_fn

        names = list(ANALYZE13)
    else:
        from pdx.library.dictionaries import fourth_order_term_fields as fields_fn, FOURTH_ORDER_TERMS

        names = list(FOURTH_ORDER_TERMS)

    def rhs(u):
        fields = fields_fn(u, dx, dy)
        out = jnp.zeros_like(u)
        for i, n in enumerate(names):
            out = out + coeffs[i] * fields[n]
        return out

    starts = u_true[t0 : t1 - k]
    traj = rollout_trajectories(rhs, starts, k, dt)
    preds = traj[-1]
    targets = u_true[t0 + k : t1]
    diff2 = (targets - preds) ** 2
    if masked:
        m = jnp.broadcast_to(spatial_mask, diff2.shape)
        msum = jnp.sum(m)
        rm = jnp.sqrt(jnp.sum(diff2 * m) / msum)
        tmean = jnp.sum(targets * m) / msum
        tstd = jnp.sqrt(jnp.sum(((targets - tmean) ** 2) * m) / msum)
    else:
        rm = jnp.sqrt(jnp.mean(diff2))
        tstd = jnp.std(targets)
    return rm, rm / (tstd + 1e-12)


ANALYZE13 = (
    "one", "u", "ux", "uy", "uxx", "uyy", "lap", "u2", "u_ux", "u_uy", "u3", "ux2", "uy2",
)


@partial(jax.jit, static_argnames=("term_set", "k", "masked"))
def _rollout_k_dense_batch_core(starts, targets, coeffs_batch, dt, dx, dy, spatial_mask,
                                *, term_set, k, masked):
    """Per-model rollout metrics for a batch of dense coefficient vectors —
    one dispatch covers every model family at this (k, split).

    Start/target slicing happens in the caller and dx/dy enter as runtime
    scalars, so one compiled program serves every start slice and grid."""
    if term_set == "real13":
        from pdx.library.dictionaries import real_image_term_fields as fields_fn

        names = list(ANALYZE13)
    else:
        from pdx.library.dictionaries import fourth_order_term_fields as fields_fn, FOURTH_ORDER_TERMS

        names = list(FOURTH_ORDER_TERMS)

    def for_model(coeffs):
        def rhs(u):
            fields = fields_fn(u, dx, dy)
            out = jnp.zeros_like(u)
            for i, n in enumerate(names):
                out = out + coeffs[i] * fields[n]
            return out

        def step(s, _):
            return s + dt * jax.vmap(rhs)(s), None

        preds, _ = jax.lax.scan(step, starts, None, length=k)
        diff2 = (targets - preds) ** 2
        if masked:
            m = jnp.broadcast_to(spatial_mask, diff2.shape)
            msum = jnp.sum(m)
            rm = jnp.sqrt(jnp.sum(diff2 * m) / msum)
            tmean = jnp.sum(targets * m) / msum
            tstd = jnp.sqrt(jnp.sum(((targets - tmean) ** 2) * m) / msum)
        else:
            rm = jnp.sqrt(jnp.mean(diff2))
            tstd = jnp.std(targets)
        return rm, rm / (tstd + 1e-12)

    return jax.vmap(for_model)(coeffs_batch)


def _rollout_k_dense_batch(u_true, coeffs_batch, dt, spatial_mask, *, term_set, k, t0, t1, masked, dx, dy):
    starts = u_true[t0 : t1 - k]
    targets = u_true[t0 + k : t1]
    return _rollout_k_dense_batch_core(
        starts, targets, coeffs_batch,
        jnp.asarray(dt, u_true.dtype), jnp.asarray(dx, u_true.dtype), jnp.asarray(dy, u_true.dtype),
        spatial_mask, term_set=term_set, k=k, masked=masked,
    )


@partial(jax.jit, static_argnames=("k_max", "t0", "t1", "term_set"))
def rollout_curve_bundle(u_true, coeffs_batch, dt, dx, dy, masks, *, k_max, t0, t1,
                         term_set="real13"):
    """Rollout metrics for EVERY horizon k=1..k_max, every model, and every
    spatial mask in ONE compiled program.

    The per-(model, k, mask) formulation compiles a separate scan per static
    k — the analyze pipeline needs ~50 of them (10 horizons x 2 splits +
    10 x 3 mask variants), each a distinct XLA program. Instead: one scan to
    k_max per model over the maximal start set u[t0:t1-1]; step j of start s
    is exactly the j-step Euler prediction, so every horizon's metrics are
    read off the same trajectory (identical values to the per-k programs).

    masks is (Nm, H, W); column 0 of the outputs is the unmasked metric and
    columns 1..Nm the masked ones. Horizons with no valid start are NaN.
    Returns (rmse, nrmse), each (M, k_max, Nm + 1).
    """
    if term_set == "real13":
        from pdx.library.dictionaries import real_image_term_fields as fields_fn

        names = list(ANALYZE13)
    else:
        from pdx.library.dictionaries import fourth_order_term_fields as fields_fn, FOURTH_ORDER_TERMS

        names = list(FOURTH_ORDER_TERMS)
    starts = u_true[t0 : t1 - 1]
    n_masks = masks.shape[0]
    nan = jnp.asarray(jnp.nan, u_true.dtype)

    def for_model(coeffs):
        def rhs(u):
            fields = fields_fn(u, dx, dy)
            out = jnp.zeros_like(u)
            for i, n in enumerate(names):
                out = out + coeffs[i] * fields[n]
            return out

        def step(s, _):
            s_next = s + dt * jax.vmap(rhs)(s)
            return s_next, s_next

        _, traj = jax.lax.scan(step, starts, None, length=k_max)  # (k_max, S, H, W)
        rm_rows, nrm_rows = [], []
        for k in range(1, k_max + 1):
            n_valid = t1 - t0 - k
            if n_valid < 1:
                rm_rows.append(jnp.full((n_masks + 1,), nan))
                nrm_rows.append(jnp.full((n_masks + 1,), nan))
                continue
            preds = traj[k - 1, :n_valid]
            targets = u_true[t0 + k : t1]
            diff2 = (targets - preds) ** 2
            rm = jnp.sqrt(jnp.mean(diff2))
            row_rm = [rm]
            row_nrm = [rm / (jnp.std(targets) + 1e-12)]
            for mi in range(n_masks):
                m = jnp.broadcast_to(masks[mi], diff2.shape)
                msum = jnp.sum(m)
                rm_m = jnp.sqrt(jnp.sum(diff2 * m) / msum)
                tmean = jnp.sum(targets * m) / msum
                tstd = jnp.sqrt(jnp.sum(((targets - tmean) ** 2) * m) / msum)
                row_rm.append(rm_m)
                row_nrm.append(rm_m / (tstd + 1e-12))
            rm_rows.append(jnp.stack(row_rm))
            nrm_rows.append(jnp.stack(row_nrm))
        return jnp.stack(rm_rows), jnp.stack(nrm_rows)

    return jax.vmap(for_model)(coeffs_batch)


def dense_coeffs(names: list[str], coeffs, superset) -> np.ndarray:
    """Scatter a model's coefficient vector into the dense superset order."""
    cvals = np.asarray(coeffs)
    dense = np.zeros((len(superset),))
    for i, n in enumerate(names):
        dense[list(superset).index(n)] = cvals[i]
    return dense


@partial(jax.jit, static_argnames=("k_max", "t_start", "t0", "t1"))
def fig4_rollout_bundle(u_true, coeffs_batch, dt, dx, dy, *, k_max, t_start, t0, t1):
    """Everything FIG4 needs in ONE compiled program (per shape).

    A per-(model, k) formulation compiles ~20 separate programs (each scan
    length is static) — minutes of compile for a qualitative figure.
    Instead: one scan to k_max per model over [the snapshot start + every
    test-split start], collecting intermediate states; error maps and the
    whole nRMSE-vs-k curve are read off the same trajectory.

    Returns (snap_traj[(M, k_max, H, W)], nrmse[(M, k_max)]) for dense
    13-term coefficient vectors (ANALYZE13 order).
    """
    from pdx.library.dictionaries import real_image_term_fields as fields_fn

    names = list(ANALYZE13)
    starts = jnp.concatenate([u_true[t_start][None], u_true[t0 : t1 - 1]], axis=0)

    def for_model(coeffs):
        def rhs(u):
            fields = fields_fn(u, dx, dy)
            out = jnp.zeros_like(u)
            for i, n in enumerate(names):
                out = out + coeffs[i] * fields[n]
            return out

        def step(s, _):
            s_next = s + dt * jax.vmap(rhs)(s)
            return s_next, s_next

        _, traj = jax.lax.scan(step, starts, None, length=k_max)  # (k_max, S+1, H, W)
        snap = traj[:, 0]
        roll = traj[:, 1:]  # (k_max, S, H, W) predictions from test starts
        nrmses = []
        S = t1 - t0 - 1
        for k in range(1, k_max + 1):
            n_valid = max(t1 - t0 - k, 1)
            preds = roll[k - 1, :n_valid] if t1 - t0 - k >= 1 else roll[k - 1, :1]
            targets = u_true[t0 + k : t0 + k + preds.shape[0]]
            rm = jnp.sqrt(jnp.mean((targets - preds) ** 2))
            nrmses.append(rm / (jnp.std(targets) + 1e-12))
        return snap, jnp.stack(nrmses)

    return jax.vmap(for_model)(coeffs_batch)


def rollout_k_rmse_dense_batch(
    u_true: Array,
    coeffs_batch: Array,
    k: int,
    t0: int,
    t1: int,
    dt: float,
    dx: float,
    dy: float,
    spatial_mask: Array | None = None,
    term_set: str = "real13",
) -> tuple[np.ndarray, np.ndarray]:
    """Batched-over-models k-step rollout. coeffs_batch is (M, p_superset)
    dense vectors. Returns (rmse[M], nrmse[M]) as numpy."""
    M = coeffs_batch.shape[0]
    if k <= 0 or (t1 - t0) <= k:
        nan = np.full((M,), np.nan)
        return nan, nan
    mask_arg = spatial_mask if spatial_mask is not None else jnp.zeros(u_true.shape[-2:], u_true.dtype)
    rm, nrm = _rollout_k_dense_batch(
        u_true, coeffs_batch, dt, mask_arg,
        term_set=term_set, k=int(k), t0=int(t0), t1=int(t1),
        masked=spatial_mask is not None, dx=float(dx), dy=float(dy),
    )
    return np.asarray(rm), np.asarray(nrm)


def rollout_k_rmse_dense(
    u_true: Array,
    names: list[str],
    coeffs: Array,
    k: int,
    t0: int,
    t1: int,
    dt: float,
    dx: float,
    dy: float,
    spatial_mask: Array | None = None,
) -> dict[str, Array]:
    """Jit-cached k-step rollout with coefficients as a runtime ARGUMENT.

    The closure-based :func:`rollout_k_rmse` bakes coefficients into the
    compiled program as constants, so every (model, k, split) combination
    recompiles — 120+ scan compiles for the six-model analyze pipeline. Here
    the model's coefficients are scattered into a dense vector over the full
    term superset ('real13' or the 25-term 4th-order set) and passed as data:
    one compile per (term_set, k, t0, t1, masked) signature, shared by every
    model and every run.

    """
    if k <= 0 or (t1 - t0) <= k:
        nan = jnp.asarray(jnp.nan, dtype=u_true.dtype)
        return {"rmse": nan, "nrmse": nan}
    from pdx.library.dictionaries import FOURTH_ORDER_TERMS

    if set(names) <= set(ANALYZE13):
        term_set = "real13"
        superset = list(ANALYZE13)
    else:
        term_set = "fourth25"
        superset = list(FOURTH_ORDER_TERMS)
    cvals = np.asarray(coeffs)  # ONE host transfer (a float() per entry costs
    # a device sync each — 1500+ syncs across the analyze model loop)
    dense = np.zeros((len(superset),))
    for i, n in enumerate(names):
        dense[superset.index(n)] = cvals[i]
    dense = jnp.asarray(dense, dtype=u_true.dtype)
    mask_arg = spatial_mask if spatial_mask is not None else jnp.zeros(u_true.shape[-2:], u_true.dtype)
    rm, nrm = _rollout_k_dense(
        u_true, dense, dt, mask_arg,
        term_set=term_set, k=int(k), t0=int(t0), t1=int(t1),
        masked=spatial_mask is not None, dx=float(dx), dy=float(dy),
    )
    return {"rmse": rm, "nrmse": nrm}


def rollout_curve(
    u_true: Array,
    rhs: Callable[[Array], Array],
    k_list: list[int],
    t0: int,
    t1: int,
    dt: float,
    spatial_mask: Array | None = None,
) -> dict[int, dict[str, Array]]:
    """Rollout metrics for every horizon in k_list, sharing one trajectory scan.

    For each k, the reference restarts rollouts from every t in [t0, t1-k);
    we run one scan from the maximal start set and mask the per-k valid range.
    """
    out: dict[int, dict[str, Array]] = {}
    for k in k_list:
        out[int(k)] = rollout_k_rmse(u_true, rhs, int(k), t0, t1, dt, spatial_mask)
    return out


def rollout_rmse_curve(
    U: Array, rhs: Callable[[Array], Array], n_steps: int, dt: float
) -> Array:
    """Single-trajectory rollout from U[0]: errs[k] = rmse(U[k+1], u_hat_k)
    (ks2d_stridge_benchmark.py:1829-1835)."""

    def step(u, target):
        u_next = u + dt * rhs(u)
        err = jnp.sqrt(jnp.mean((target - u_next) ** 2))
        return u_next, err

    _, errs = jax.lax.scan(step, U[0], U[1 : n_steps + 1])
    return errs


def _rollout_curve_named_impl(U, coeffs, names: tuple, n_steps: int, dt, dx, dy):
    def rhs(u):
        ux, uy = gradients_periodic(u, dx, dy)
        lap = laplacian_periodic(u, dx, dy)
        vals = {
            "one": jnp.ones_like(u), "u": u, "u2": u**2, "ux": ux, "uy": uy,
            "lap": lap, "bih": laplacian_periodic(lap, dx, dy),
            "gradsq": ux**2 + uy**2, "u_lap": u * lap,
        }
        out = jnp.zeros_like(u)
        for i, name in enumerate(names):
            out = out + coeffs[i] * vals[name]
        return out

    def step(u, target):
        u_next = u + dt * rhs(u)
        err = jnp.sqrt(jnp.mean((target - u_next) ** 2))
        return u_next, err

    _, errs = jax.lax.scan(step, U[0], U[1 : n_steps + 1])
    return errs


_rollout_curve_named = jax.jit(
    _rollout_curve_named_impl, static_argnames=("names", "n_steps")
)


def rollout_rmse_curve_named(
    U: Array, coeffs: Array, names: list[str], n_steps: int, dt: float, dx: float, dy: float
) -> Array:
    """`rollout_rmse_curve` for the periodic term-map RHS, jitted with the
    coefficient VECTOR as a runtime argument — repeated calls with new
    coefficients (every benchmark run) reuse one compiled program instead of
    re-tracing a fresh closure each time."""
    return _rollout_curve_named(
        U, jnp.asarray(coeffs, U.dtype), tuple(names), int(n_steps),
        jnp.asarray(dt, U.dtype), jnp.asarray(dx, U.dtype), jnp.asarray(dy, U.dtype),
    )
