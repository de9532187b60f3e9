"""ECC registration parity: recover known affine warps; compare against cv2."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp

from upsp_tpu.ops.registration import ecc_affine, register_frame, warp_affine


def make_test_image(rng, h=96, w=128):
    """Smooth blobby image with texture (registration needs gradients)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w), np.float32)
    for _ in range(12):
        cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
        s = rng.uniform(3, 12)
        a = rng.uniform(500, 2000)
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    img += 800
    return img.astype(np.float32)


class TestWarpAffine:
    def test_identity(self, rng):
        img = make_test_image(rng)
        W = np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32)
        out = np.array(warp_affine(jnp.asarray(img), jnp.asarray(W)))
        np.testing.assert_allclose(out, img, atol=1e-4)

    def test_vs_cv2(self, rng):
        img = make_test_image(rng)
        W = np.array([[1.01, 0.02, 1.5], [-0.015, 0.99, -2.3]], np.float32)
        ours = np.array(warp_affine(jnp.asarray(img), jnp.asarray(W)))
        ref = cv2.warpAffine(
            img, W, (img.shape[1], img.shape[0]),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )
        # interiors must match closely (borders differ by the sampling edge)
        np.testing.assert_allclose(ours[4:-4, 4:-4], ref[4:-4, 4:-4], atol=0.15, rtol=1e-4)

    def test_nearest(self, rng):
        img = make_test_image(rng)
        W = np.array([[1.0, 0.0, 3.0], [0.0, 1.0, -2.0]], np.float32)
        ours = np.array(warp_affine(jnp.asarray(img), jnp.asarray(W), "nearest"))
        np.testing.assert_allclose(ours[5:-5, 5:-5], img[3:-7, 8:-2], atol=1e-4)


class TestECC:
    @pytest.mark.parametrize(
        "true_warp",
        [
            np.array([[1.0, 0.0, 1.7], [0.0, 1.0, -1.2]], np.float32),
            np.array([[1.004, 0.006, 0.8], [-0.005, 0.998, 1.1]], np.float32),
        ],
    )
    def test_matches_cv2_displacement_field(self, true_warp):
        rng = np.random.default_rng(7)  # fixed: test is sensitive to texture
        """Ours and cv2.findTransformECC must land on the same warp.

        Neither recovers the analytic inverse exactly (the synthetic image's
        constant borders bias both identically), so the right parity check is
        ours-vs-cv2 over interior pixel displacements.
        """
        # Warp on a large canvas, then crop interiors: no constant-zero borders
        # contaminate either solver.
        big = make_test_image(rng, h=160, w=192)
        big_warped = cv2.warpAffine(
            big, true_warp, (big.shape[1], big.shape[0]),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        crop = (slice(32, 128), slice(32, 160))
        ref = np.ascontiguousarray(big[crop])
        inp = np.ascontiguousarray(big_warped[crop])
        cv_warp = np.eye(2, 3, dtype=np.float32)
        cv2.findTransformECC(
            ref, inp, cv_warp, cv2.MOTION_AFFINE,
            (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 1e-3),
        )
        warp, rho = ecc_affine(jnp.asarray(ref), jnp.asarray(inp))
        warp = np.array(warp)
        h, w = ref.shape
        ys, xs = np.mgrid[8 : h - 8, 8 : w - 8]
        pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=0)
        disp = (warp @ pts) - (cv_warp @ pts)
        assert np.abs(disp).max() < 0.25  # sub-quarter-pixel agreement with cv2

    def test_register_frame_realigns(self, rng):
        ref = make_test_image(rng)
        true_warp = np.array([[1.0, 0.0, 2.5], [0.0, 1.0, 1.5]], np.float32)
        inp = cv2.warpAffine(
            ref, true_warp, (ref.shape[1], ref.shape[0]),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        aligned, warp, rho = register_frame(jnp.asarray(ref), jnp.asarray(inp))
        aligned = np.array(aligned)
        inner = (slice(8, -8), slice(8, -8))
        err_before = np.abs(inp[inner] - ref[inner]).mean()
        err_after = np.abs(aligned[inner] - ref[inner]).mean()
        # bilinear resampling of an already-resampled image bounds how far the
        # residual can drop; 6x is far beyond what a wrong warp could achieve
        assert err_after < err_before / 6.0
        assert float(rho) > 0.95


class TestPyramid:
    def test_large_shift_recovered(self):
        """Single-level ECC can't capture ~8 px shifts; the pyramid can."""
        from upsp_tpu.ops.registration import ecc_affine_pyramid

        rng = np.random.default_rng(11)
        big = make_test_image(rng, h=192, w=256)
        true_warp = np.array([[1.0, 0.0, 8.0], [0.0, 1.0, -6.0]], np.float32)
        inp = cv2.warpAffine(
            big, true_warp, (big.shape[1], big.shape[0]),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        warp, rho = ecc_affine_pyramid(
            jnp.asarray(big), jnp.asarray(inp), levels=3
        )
        warp = np.array(warp)
        # recovered translation close to the inverse shift
        assert abs(warp[0, 2] + 8.0) < 0.6
        assert abs(warp[1, 2] - 6.0) < 0.6
        assert float(rho) > 0.9


class TestTelemetry:
    def test_return_iters(self, rng):
        import jax.numpy as jnp

        from upsp_tpu.ops.registration import ecc_affine, warp_affine

        H, W = 64, 80
        yy, xx = np.mgrid[0:H, 0:W]
        ref = (
            1000
            + 500 * np.exp(-((xx - 40) ** 2 + (yy - 30) ** 2) / 150.0)
            + 200 * np.sin(xx / 6.0)
        ).astype(np.float32)
        true = jnp.array([[1.0, 0.0, 0.8], [0.0, 1.0, -0.5]], jnp.float32)
        inp = warp_affine(jnp.asarray(ref), true)
        warp, rho, iters = ecc_affine(jnp.asarray(ref), inp, return_iters=True)
        assert 1 <= int(iters) <= 50
        assert float(rho) > 0.95
        # default signature unchanged
        warp2, rho2 = ecc_affine(jnp.asarray(ref), inp)
        np.testing.assert_array_equal(np.asarray(warp), np.asarray(warp2))

    def test_process_frame_telemetry(self):
        import jax.numpy as jnp

        from upsp_tpu.pipeline.phase1 import make_frame_processor
        from upsp_tpu.pipeline.synthetic import make_frame_batch, make_synthetic_state

        state = make_synthetic_state(
            n_cameras=2, image_hw=(64, 96), grid_shape=(24, 20),
            n_patch_dots=3, registration="pixel",
        )
        frames = make_frame_batch(state, n_frames=2)
        fn = make_frame_processor(state, with_telemetry=True)
        sol, tele = fn(jnp.asarray(frames[1]))
        assert tele.shape == (2, 5)
        tele = np.asarray(tele)
        assert (tele[:, 0] > 0.9).all()        # rho
        assert (tele[:, 1] >= 1).all()          # iterations
        assert np.abs(tele[:, 2:4]).max() < 5.0  # sub-5px jitter recovered
        # intensity identical to the non-telemetry path
        base = make_frame_processor(state)(jnp.asarray(frames[1]))
        np.testing.assert_array_equal(np.asarray(sol), np.asarray(base))


def _gn_statistics_f64(iw, tmpl, warp, mask_warp):
    """Float64 numpy form of registration.gn_statistics."""
    iw = np.asarray(iw, np.float64)
    tmpl = np.asarray(tmpl, np.float64)
    a = np.asarray(warp, np.float64)
    mw = np.asarray(mask_warp, np.float64)
    H, W = iw.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    gix = np.zeros_like(iw)
    giy = np.zeros_like(iw)
    gix[:, 1:-1] = 0.5 * (iw[:, 2:] - iw[:, :-2])
    giy[1:-1, :] = 0.5 * (iw[2:, :] - iw[:-2, :])
    det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    gx = (a[1, 1] * gix - a[1, 0] * giy) / det
    gy = (-a[0, 1] * gix + a[0, 0] * giy) / det
    y_sep = mw[1, 1] * ys[:, 0] + mw[1, 2] + mw[1, 0] * (W - 1) / 2
    x_sep = mw[0, 0] * xs[0] + mw[0, 2] + mw[0, 1] * (H - 1) / 2
    m = np.outer((y_sep >= 0) & (y_sep <= H - 1), (x_sep >= 0) & (x_sep <= W - 1))
    m = m.astype(np.float64)
    area = max(m.sum(), 1.0)
    gx, gy = gx * m, gy * m
    t_zm = (tmpl - (tmpl * m).sum() / area) * m
    i_zm = (iw - (iw * m).sum() / area) * m
    G = np.stack([gx * xs, gy * xs, gx * ys, gy * ys, gx, gy]).reshape(6, -1)
    return (G @ G.T, G @ i_zm.ravel(), G @ t_zm.ravel(), (i_zm**2).sum(),
            (t_zm * i_zm).sum(), np.sqrt((t_zm**2).sum()))


class TestGNStatistics:
    @pytest.mark.parametrize("warp,shift", [
        ([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], (0, 0)),
        ([[1.0, 0.0, 0.6], [0.0, 1.0, -0.8]], (0, 0)),
        ([[1.0003, -2e-4, 0.4], [1e-4, 0.9997, -0.3]], (0, 0)),
        ([[1.0, 0.0, 0.2], [0.0, 1.0, 0.1]], (4, -6)),
    ])
    def test_matches_float64(self, rng, warp, shift):
        from upsp_tpu.ops.registration import gn_statistics
        from upsp_tpu.ops.warp import warp_affine_mxu

        tmpl = make_test_image(rng)
        w = np.asarray(warp, np.float32)
        iw = np.asarray(warp_affine_mxu(jnp.asarray(make_test_image(rng)),
                                        jnp.asarray(w)))
        mw = w.copy()
        mw[:, 2] += shift
        got = gn_statistics(jnp.asarray(iw), jnp.asarray(tmpl),
                            jnp.asarray(w), jnp.asarray(mw))
        want = _gn_statistics_f64(iw, tmpl, w, mw)
        for g, e in zip(got, want):
            np.testing.assert_allclose(np.asarray(g, np.float64), e,
                                       rtol=2e-4, atol=1e-6 * np.abs(e).max())
