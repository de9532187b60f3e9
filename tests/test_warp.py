"""Separable tent-matrix warp vs the gather-bilinear reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from upsp_tpu.ops.registration import warp_affine
from upsp_tpu.ops.warp import downsample2, scale_warp, warp_affine_mxu, warp_validity_mask


def textured(rng, h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 1000 + 3 * xx + 2 * yy + 300 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    img += rng.normal(0, 5, (h, w))
    return img.astype(np.float32)


class TestWarpMXU:
    def test_identity(self, rng):
        img = textured(rng)
        W = jnp.array([[1.0, 0, 0], [0, 1.0, 0]], jnp.float32)
        np.testing.assert_allclose(
            np.array(warp_affine_mxu(jnp.asarray(img), W)), img, atol=1e-3
        )

    def test_separable_exact_vs_gather(self, rng):
        """Pure scale+translation: matmul warp == gather warp exactly."""
        img = textured(rng)
        W = jnp.array([[1.02, 0.0, 1.7], [0.0, 0.98, -2.3]], jnp.float32)
        ours = np.array(warp_affine_mxu(jnp.asarray(img), W))
        oracle = np.array(warp_affine(jnp.asarray(img), W))
        np.testing.assert_allclose(ours, oracle, atol=5e-2, rtol=1e-5)

    def test_small_shear_vs_gather(self, rng):
        """uPSP-scale shear (|a01| ~ 1e-3): Taylor correction holds sub-1%."""
        img = textured(rng)
        W = jnp.array([[1.004, 0.002, 1.1], [-0.0015, 0.997, -0.9]], jnp.float32)
        ours = np.array(warp_affine_mxu(jnp.asarray(img), W))
        oracle = np.array(warp_affine(jnp.asarray(img), W))
        inner = (slice(4, -4), slice(4, -4))
        err = np.abs(ours[inner] - oracle[inner])
        scale = np.abs(oracle[inner]).mean()
        assert err.max() / scale < 0.01
        assert err.mean() / scale < 5e-4

    def test_pre_blur_composition(self, rng):
        """pre_blur folds the Gaussian into the tents: warp∘blur exactly."""
        from upsp_tpu.ops.image import gaussian_blur

        img = textured(rng)
        W = jnp.array([[1.001, 2e-4, 0.7], [-1e-4, 0.999, -0.4]], jnp.float32)
        for k in (3, 5):
            composed = np.array(
                warp_affine_mxu(jnp.asarray(img), W, pre_blur=k)
            )
            explicit = np.array(
                warp_affine_mxu(gaussian_blur(jnp.asarray(img), k), W)
            )
            np.testing.assert_allclose(composed, explicit, atol=2e-3)
        # banded fallback path takes the explicit-blur route
        composed_b = np.array(
            warp_affine_mxu(jnp.asarray(img), W, pre_blur=5, band=8)
        )
        explicit_b = np.array(
            warp_affine_mxu(gaussian_blur(jnp.asarray(img), 5), W, band=8)
        )
        np.testing.assert_allclose(composed_b, explicit_b, atol=1e-4)

    def test_blur_matrix_matches_blur(self, rng):
        """gaussian_blur_matrix_1d reproduces the separable blur exactly."""
        from upsp_tpu.ops.image import gaussian_blur, gaussian_blur_matrix_1d

        img = textured(rng)
        h, w = img.shape
        By = gaussian_blur_matrix_1d(h, 5)
        Bx = gaussian_blur_matrix_1d(w, 5)
        via_mat = By @ img @ Bx.T
        np.testing.assert_allclose(
            via_mat, np.array(gaussian_blur(jnp.asarray(img), 5)), atol=1e-3
        )

    def test_validity_mask(self):
        W = jnp.array([[1.0, 0.0, 5.0], [0.0, 1.0, -3.0]], jnp.float32)
        m = np.array(warp_validity_mask((32, 48), W))
        # x_src = x + 5 -> invalid for x >= 43; y_src = y - 3 -> invalid y < 3
        assert m[10, 42] == 1.0 and m[10, 43] == 0.0
        assert m[2, 10] == 0.0 and m[3, 10] == 1.0

    def test_downsample2(self):
        img = jnp.asarray(np.arange(16, dtype=np.float32).reshape(4, 4))
        d = np.array(downsample2(img))
        assert d.shape == (2, 2)
        assert d[0, 0] == pytest.approx((0 + 1 + 4 + 5) / 4)

    def test_scale_warp(self):
        W = jnp.array([[1.01, 0.002, 4.0], [0.001, 0.99, -2.0]], jnp.float32)
        s = np.array(scale_warp(W, 0.5))
        assert s[0, 2] == pytest.approx(2.0)
        assert s[1, 2] == pytest.approx(-1.0)
        assert s[0, 0] == pytest.approx(1.01)


class TestDenseVsGatherHighest:
    """The dense tent-matmul warp against the gather-bilinear warp (the
    plain reference), with f32 matmuls pinned to full precision."""

    @pytest.mark.parametrize("w", [
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
        [[1.0, 0.0, 0.37], [0.0, 1.0, -1.21]],
        [[1.003, 0.0, -2.6], [0.0, 0.996, 3.4]],
    ])
    def test_separable_exact(self, rng, w):
        import jax

        img = jnp.asarray(textured(rng))
        W = jnp.asarray(w, jnp.float32)
        with jax.default_matmul_precision("highest"):
            dense = np.asarray(warp_affine_mxu(img, W))
        gather = np.asarray(warp_affine(img, W))
        np.testing.assert_allclose(dense, gather, rtol=1e-5, atol=1e-2)

    @pytest.mark.parametrize("w", [
        [[1.0, 0.001, 0.4], [-0.001, 1.0, -0.3]],
        [[1.002, -0.0015, -1.1], [0.002, 0.999, 0.8]],
    ])
    def test_sheared_within_taylor(self, rng, w):
        import jax

        img = jnp.asarray(textured(rng))
        W = jnp.asarray(w, jnp.float32)
        with jax.default_matmul_precision("highest"):
            dense = np.asarray(warp_affine_mxu(img, W))
        gather = np.asarray(warp_affine(img, W))
        inner = (slice(4, -4), slice(4, -4))
        err = np.abs(dense[inner] - gather[inner]) / np.abs(gather[inner]).mean()
        assert err.max() < 0.01 and err.mean() < 5e-4
