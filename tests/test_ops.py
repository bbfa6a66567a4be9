"""Unit tests for L0 primitives against analytic results and NumPy/scipy."""

import numpy as np
import jax.numpy as jnp
import pytest

from pdx.ops import (
    gradients_periodic,
    laplacian_periodic,
    biharmonic_periodic,
    derivs_2d_reflect,
    gradients_spectral,
    laplacian_spectral,
    gaussian_smooth_periodic,
    time_smooth_moving_average,
    smooth_1d,
    gaussian_filter_reflect,
    median_filter_3x3,
    savgol_time,
    rmse,
    r2_score,
)
from pdx.ops.fd import gradient_edge2
from pdx.ops.interp import shift_periodic, resize_area, bilinear_sample_reflect
from pdx.ops.spectral import spectral_derivative_1d


def periodic_field(n=64, L=10.0):
    x = np.linspace(0, L, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    f = np.sin(2 * np.pi * X / L) * np.cos(4 * np.pi * Y / L)
    return f, L / n, X, Y, L


class TestFDStencils:
    def test_gradients_match_numpy_roll(self):
        f, d, *_ = periodic_field()
        gx, gy = gradients_periodic(jnp.asarray(f), d, d)
        gx_np = (np.roll(f, -1, 0) - np.roll(f, 1, 0)) / (2 * d)
        gy_np = (np.roll(f, -1, 1) - np.roll(f, 1, 1)) / (2 * d)
        np.testing.assert_allclose(gx, gx_np, atol=1e-13)
        np.testing.assert_allclose(gy, gy_np, atol=1e-13)

    def test_laplacian_analytic(self):
        f, d, X, Y, L = periodic_field(n=256)
        lap = laplacian_periodic(jnp.asarray(f), d, d)
        k1, k2 = 2 * np.pi / L, 4 * np.pi / L
        lap_exact = -(k1**2 + k2**2) * f
        np.testing.assert_allclose(lap, lap_exact, atol=2e-3 * np.abs(lap_exact).max())

    def test_batched_equals_per_frame(self):
        rng = np.random.default_rng(1)
        U = rng.normal(size=(5, 32, 32))
        lap_b = np.asarray(laplacian_periodic(jnp.asarray(U), 0.5, 0.5))
        for t in range(5):
            lap_t = np.asarray(laplacian_periodic(jnp.asarray(U[t]), 0.5, 0.5))
            np.testing.assert_allclose(lap_b[t], lap_t, rtol=1e-12)

    def test_derivs_2d_reflect_matches_reference_padding(self):
        rng = np.random.default_rng(2)
        f = rng.normal(size=(20, 24))
        dx, dy = 0.1, 0.1
        fpad = np.pad(f, 1, mode="reflect")
        u_x = (fpad[1:-1, 2:] - fpad[1:-1, :-2]) / (2 * dx)
        u_y = (fpad[2:, 1:-1] - fpad[:-2, 1:-1]) / (2 * dy)
        u_xx = (fpad[1:-1, 2:] - 2 * fpad[1:-1, 1:-1] + fpad[1:-1, :-2]) / dx**2
        u_yy = (fpad[2:, 1:-1] - 2 * fpad[1:-1, 1:-1] + fpad[:-2, 1:-1]) / dy**2
        # reference derivs_2d convention: x = cols (fpad[1:-1, 2:])
        ux, uy, uxx, uyy = derivs_2d_reflect(jnp.asarray(f), dx, dy)
        np.testing.assert_allclose(ux, u_x, rtol=1e-12)
        np.testing.assert_allclose(uy, u_y, rtol=1e-12)
        np.testing.assert_allclose(uxx, u_xx, rtol=1e-12)
        np.testing.assert_allclose(uyy, u_yy, rtol=1e-12)

    def test_gradient_edge2_matches_numpy(self):
        rng = np.random.default_rng(3)
        f = rng.normal(size=(10, 12))
        for axis in (0, 1):
            got = gradient_edge2(jnp.asarray(f), 0.3, axis)
            want = np.gradient(f, 0.3, axis=axis, edge_order=2)
            np.testing.assert_allclose(got, want, rtol=1e-12)


class TestSpectral:
    def test_gradients_spectral_matches_numpy_fft(self):
        rng = np.random.default_rng(4)
        f = rng.normal(size=(32, 48))
        dx, dy = 0.5, 0.25
        kx = 2 * np.pi * np.fft.fftfreq(32, dx)
        ky = 2 * np.pi * np.fft.fftfreq(48, dy)
        KX, KY = np.meshgrid(kx, ky, indexing="ij")
        F = np.fft.fft2(f)
        gx_np = np.fft.ifft2(1j * KX * F).real
        gy_np = np.fft.ifft2(1j * KY * F).real
        gx, gy = gradients_spectral(jnp.asarray(f), dx, dy)
        np.testing.assert_allclose(gx, gx_np, atol=1e-10)
        np.testing.assert_allclose(gy, gy_np, atol=1e-10)

    def test_spectral_cutoff_mask(self):
        rng = np.random.default_rng(5)
        f = rng.normal(size=(32, 32))
        lap_full = laplacian_spectral(jnp.asarray(f), 1.0, 1.0, cutoff_frac=1.0)
        lap_cut = laplacian_spectral(jnp.asarray(f), 1.0, 1.0, cutoff_frac=0.5)
        assert not np.allclose(lap_full, lap_cut)
        # cutoff removes high-k energy: smoother result
        assert np.std(np.asarray(lap_cut)) < np.std(np.asarray(lap_full))

    def test_gaussian_smooth_periodic_matches_reference_formula(self):
        rng = np.random.default_rng(6)
        f = rng.normal(size=(40, 40))
        sigma = 2.0
        kx = 2 * np.pi * np.fft.fftfreq(40)
        KX, KY = np.meshgrid(kx, kx, indexing="ij")
        H = np.exp(-0.5 * sigma**2 * (KX**2 + KY**2))
        want = np.fft.ifft2(np.fft.fft2(f) * H).real
        got = gaussian_smooth_periodic(jnp.asarray(f), sigma)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_spectral_derivative_1d(self):
        n, L = 128, 7.0
        x = np.linspace(0, L, n, endpoint=False)
        f = np.sin(2 * np.pi * 3 * x / L)
        d1 = spectral_derivative_1d(jnp.asarray(f), L, order=1)
        want = (2 * np.pi * 3 / L) * np.cos(2 * np.pi * 3 * x / L)
        np.testing.assert_allclose(d1, want, atol=1e-10)


class TestFilters:
    def test_time_smooth_moving_average_matches_reference(self):
        rng = np.random.default_rng(7)
        U = rng.normal(size=(11, 8, 8))
        w = 5
        pad = w // 2
        U_pad = np.pad(U, ((pad, pad), (0, 0), (0, 0)), mode="reflect")
        cs = np.concatenate([np.zeros_like(U_pad[:1]), np.cumsum(U_pad, axis=0)], axis=0)
        want = (cs[w:] - cs[:-w]) / w
        got = time_smooth_moving_average(jnp.asarray(U), w)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_smooth_1d_matches_reference(self):
        x = np.random.default_rng(8).normal(size=30)
        for w in (3, 4, 7):
            weff = w if w % 2 else w + 1
            pad = weff // 2
            xp = np.pad(x, (pad, pad), mode="edge")
            k = np.ones(weff) / weff
            want = np.convolve(xp, k, mode="valid")
            got = smooth_1d(jnp.asarray(x), w)
            np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_gaussian_filter_matches_scipy(self):
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(9)
        f = rng.normal(size=(31, 37))
        for sigma in (0.7, 1.0, 1.5, 2.0):
            want = gaussian_filter(f, sigma=sigma)
            got = gaussian_filter_reflect(jnp.asarray(f), sigma)
            np.testing.assert_allclose(got, want, atol=1e-10)

    def test_median_filter_matches_scipy(self):
        from scipy.ndimage import median_filter

        rng = np.random.default_rng(10)
        f = rng.normal(size=(16, 19))
        want = median_filter(f, size=3)
        got = median_filter_3x3(jnp.asarray(f))
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_median_filter_general_sizes_match_scipy(self):
        from scipy.ndimage import median_filter
        from pdx.ops.filters import median_filter_2d
        from pdx.preprocess import preprocess_median

        rng = np.random.default_rng(10)
        f = rng.normal(size=(16, 19))
        for size in (3, 5, 7):
            want = median_filter(f, size=size)
            got = median_filter_2d(jnp.asarray(f), size)
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=f"size={size}")
        # batched leading axis through the preprocessor entry point
        U = rng.normal(size=(4, 12, 13))
        want = np.stack([median_filter(u, size=5) for u in U])
        np.testing.assert_allclose(preprocess_median(jnp.asarray(U), size=5), want, rtol=1e-12)
        with pytest.raises(ValueError):
            median_filter_2d(jnp.asarray(f), 4)

    def test_savgol_matches_scipy(self):
        from scipy.signal import savgol_filter

        rng = np.random.default_rng(11)
        U = rng.normal(size=(25, 6, 7))
        for w, p in ((5, 2), (7, 3)):
            want = savgol_filter(U, w, p, axis=0, mode="interp")
            got = savgol_time(jnp.asarray(U), w, p)
            np.testing.assert_allclose(got, want, atol=1e-9)


class TestInterp:
    def test_integer_shift_periodic_is_roll(self):
        rng = np.random.default_rng(12)
        f = rng.normal(size=(16, 16))
        got = shift_periodic(jnp.asarray(f), 3.0, -2.0)
        want = np.roll(np.roll(f, 3, axis=0), -2, axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_subpixel_shift_matches_cv2_warpaffine(self):
        cv2 = pytest.importorskip("cv2")
        rng = np.random.default_rng(13)
        f = rng.normal(size=(40, 40)).astype(np.float32)
        sx, sy = 1.3, -0.7
        M = np.array([[1.0, 0.0, sy], [0.0, 1.0, sx]], dtype=np.float32)
        want = cv2.warpAffine(f, M, (40, 40), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_WRAP)
        got = np.asarray(shift_periodic(jnp.asarray(f, dtype=jnp.float64), sx, sy))
        # cv2 quantizes interpolation coords to 1/32 px — tolerance reflects that
        assert np.abs(got - want).max() < 5e-2 * np.abs(f).max()

    def test_resize_area_half_is_block_mean(self):
        rng = np.random.default_rng(14)
        f = rng.normal(size=(20, 24))
        got = resize_area(jnp.asarray(f), 10, 12)
        want = f.reshape(10, 2, 12, 2).mean(axis=(1, 3))
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_resize_area_matches_cv2(self):
        cv2 = pytest.importorskip("cv2")
        rng = np.random.default_rng(15)
        f = rng.normal(size=(21, 33)).astype(np.float32)
        want = cv2.resize(f, (16, 10), interpolation=cv2.INTER_AREA)
        got = np.asarray(resize_area(jnp.asarray(f, dtype=jnp.float64), 10, 16))
        np.testing.assert_allclose(got, want, atol=2e-6)

    def test_reflect101_sampling_at_integer_points(self):
        rng = np.random.default_rng(16)
        f = rng.normal(size=(8, 9))
        x = jnp.asarray([[-1.0, 0.0, 8.0]])
        y = jnp.asarray([[2.0, -2.0, 9.0]])
        got = np.asarray(bilinear_sample_reflect(jnp.asarray(f), x, y))
        assert np.isclose(got[0, 0], f[1, 2])  # -1 -> 1
        assert np.isclose(got[0, 1], f[0, 2])  # -2 -> 2 on y
        assert np.isclose(got[0, 2], f[6, 7])  # 8 -> 6, 9 -> 7

    def test_batched_samplers_match_unbatched(self):
        # pins the batched-gather lowering (flat take / channel-last take)
        # against the per-element unbatched path
        from pdx.ops.interp import (
            bilinear_sample_reflect_batch,
            bilinear_sample_reflect_cbatch,
        )

        rng = np.random.default_rng(21)
        B, C, H, W, h, w = 3, 5, 17, 13, 9, 11
        f3 = jnp.asarray(rng.normal(size=(B, H, W)), jnp.float32)
        f4 = jnp.asarray(rng.normal(size=(C, B, H, W)), jnp.float32)
        x = jnp.asarray(rng.uniform(-2, H + 1, size=(B, h, w)), jnp.float32)
        y = jnp.asarray(rng.uniform(-2, W + 1, size=(B, h, w)), jnp.float32)
        got3 = np.asarray(bilinear_sample_reflect_batch(f3, x, y))
        want3 = np.stack(
            [np.asarray(bilinear_sample_reflect(f3[b], x[b], y[b])) for b in range(B)]
        )
        np.testing.assert_allclose(got3, want3, rtol=1e-6, atol=1e-6)
        got4 = np.asarray(bilinear_sample_reflect_cbatch(f4, x, y))
        want4 = np.stack(
            [np.asarray(bilinear_sample_reflect(f4[:, b], x[b], y[b])) for b in range(B)],
            axis=1,
        )
        np.testing.assert_allclose(got4, want4, rtol=1e-6, atol=1e-6)

    def test_packed_sampler_matches_taps(self):
        # the packed 2x2-block sampler folds the COORDINATES (float
        # reflect-101) instead of each integer tap: same value to fp
        # precision, 4x fewer gather indices (the accelerator warp policy)
        from pdx.ops.interp import (
            bilinear_sample_reflect_batch,
            bilinear_sample_reflect_batch_packed,
        )

        rng = np.random.default_rng(22)
        B, H, W, h, w = 3, 17, 13, 9, 11
        f3 = jnp.asarray(rng.normal(size=(B, H, W)), jnp.float32)
        # coordinates deliberately well outside the domain (multi-period
        # reflect folds) plus exact-boundary points
        x = jnp.asarray(rng.uniform(-2 * H, 3 * H, size=(B, h, w)), jnp.float32)
        y = jnp.asarray(rng.uniform(-2 * W, 3 * W, size=(B, h, w)), jnp.float32)
        x = x.at[0, 0, :3].set(jnp.asarray([0.0, H - 1.0, -1.0], jnp.float32))
        y = y.at[0, 0, :3].set(jnp.asarray([W - 1.0, 0.0, W + 0.5], jnp.float32))
        got = np.asarray(bilinear_sample_reflect_batch_packed(f3, x, y))
        want = np.asarray(bilinear_sample_reflect_batch(f3, x, y))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_packed_channel_samplers_match_taps(self):
        from pdx.ops.interp import (
            bilinear_sample_reflect_cbatch,
            bilinear_sample_reflect_cbatch_packed,
            bilinear_sample_reflect_packed,
        )

        rng = np.random.default_rng(24)
        C, B, H, W, h, w = 5, 3, 17, 13, 9, 11
        f4 = jnp.asarray(rng.normal(size=(C, B, H, W)), jnp.float32)
        x = jnp.asarray(rng.uniform(-H, 2 * H, size=(B, h, w)), jnp.float32)
        y = jnp.asarray(rng.uniform(-W, 2 * W, size=(B, h, w)), jnp.float32)
        got = np.asarray(bilinear_sample_reflect_cbatch_packed(f4, x, y))
        want = np.asarray(bilinear_sample_reflect_cbatch(f4, x, y))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        # unbatched channel-first (the scan-chain pyramid shape)
        f3 = f4[:, 0]
        got3 = np.asarray(bilinear_sample_reflect_packed(f3, x[0], y[0]))
        want3 = np.asarray(bilinear_sample_reflect(f3, x[0], y[0]))
        np.testing.assert_allclose(got3, want3, rtol=1e-4, atol=1e-5)
        # plain (H, W) single-channel
        got2 = np.asarray(bilinear_sample_reflect_packed(f3[0], x[0], y[0]))
        np.testing.assert_allclose(got2, want3[0], rtol=1e-4, atol=1e-5)

    def test_flow_fetch_impl_parity(self, monkeypatch):
        """The packed expansion fetch must leave Farnebäck flows essentially
        unchanged (same math, different gather lowering)."""
        import jax

        from pdx.register.farneback import farneback_flow

        rng = np.random.default_rng(25)
        a = jnp.asarray(rng.random((2, 48, 40)), jnp.float32)
        b = jnp.asarray(rng.random((2, 48, 40)), jnp.float32)
        outs = {}
        for impl in ("taps", "packed"):
            monkeypatch.setenv("PDX_FETCH_IMPL", impl)
            monkeypatch.setenv("PDX_WARP_IMPL", impl)
            # the impl policy is read at TRACE time: drop cached executables
            # so the env change actually reaches the lowering
            jax.clear_caches()
            fx, fy = farneback_flow(
                a, b, levels=2, winsize=9, iterations=3, poly_n=5,
                poly_sigma=1.1, gaussian_win=False, refine=1, batched=True,
            )
            fxs, fys = farneback_flow(
                a[0], b[0], levels=2, winsize=9, iterations=3, poly_n=5,
                poly_sigma=1.1, gaussian_win=False, refine=1,
            )
            outs[impl] = (np.asarray(fx), np.asarray(fy), np.asarray(fxs), np.asarray(fys))
        for g, w in zip(outs["packed"], outs["taps"]):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-4)

    def test_warp_flow_batch_impl_parity(self, monkeypatch):
        from pdx.ops.interp import warp_flow_batch

        rng = np.random.default_rng(23)
        f = jnp.asarray(rng.normal(size=(2, 20, 24)), jnp.float32)
        fx = jnp.asarray(rng.normal(size=(2, 20, 24)) * 3, jnp.float32)
        fy = jnp.asarray(rng.normal(size=(2, 20, 24)) * 3, jnp.float32)
        monkeypatch.setenv("PDX_WARP_IMPL", "taps")
        a = np.asarray(warp_flow_batch(f, fx, fy))
        monkeypatch.setenv("PDX_WARP_IMPL", "packed")
        b = np.asarray(warp_flow_batch(f, fx, fy))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


class TestMetrics:
    def test_rmse_r2(self):
        rng = np.random.default_rng(17)
        y = rng.normal(size=100)
        yp = y + 0.1 * rng.normal(size=100)
        assert np.isclose(float(rmse(jnp.asarray(y), jnp.asarray(yp))), np.sqrt(np.mean((y - yp) ** 2)))
        ss_res = np.sum((y - yp) ** 2)
        ss_tot = np.sum((y - y.mean()) ** 2)
        assert np.isclose(float(r2_score(jnp.asarray(y), jnp.asarray(yp))), 1 - ss_res / (ss_tot + 1e-18))


    def test_masked_metrics_match_extracted(self):
        """masked_regression_metrics(y, yp, m) == regression_metrics on the
        extracted subset y[m] (the device formulation that replaced the
        spatial-holdout host extraction round-trips)."""
        from pdx.ops.metrics import masked_regression_metrics, regression_metrics

        rng = np.random.default_rng(18)
        y = rng.normal(size=400)
        yp = y + 0.2 * rng.normal(size=400)
        m = rng.random(400) < 0.4
        got = {k: float(v) for k, v in masked_regression_metrics(
            jnp.asarray(y), jnp.asarray(yp), jnp.asarray(m)).items()}
        want = {k: float(v) for k, v in regression_metrics(
            jnp.asarray(y[m]), jnp.asarray(yp[m])).items()}
        want["resid_med_abs"] = float(np.median(np.abs(y[m] - yp[m])))
        for k, v in want.items():
            assert np.isclose(got[k], v, rtol=1e-10, atol=1e-12), (k, got[k], v)


class TestGaussian3D:
    def test_matches_scipy_tuple_sigma(self):
        from scipy.ndimage import gaussian_filter as sgf
        from pdx.ops.filters import gaussian_filter3d_reflect

        rng = np.random.default_rng(30)
        U = rng.normal(size=(12, 20, 22))
        for st, ss in ((1.0, 0.8), (2.0, 1.5)):
            want = sgf(U, sigma=(st, ss, ss))
            got = gaussian_filter3d_reflect(jnp.asarray(U), st, ss)
            np.testing.assert_allclose(got, want, atol=1e-10)
