"""Image ops parity tests (cv2 as oracle where applicable)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp

from upsp_tpu.ops.image import (
    box_blur,
    convert_to_8u,
    first_min_threshold,
    fix_hot_pixels,
    gaussian_blur,
    intensity_histc,
    scale_image_max_inlier,
)


class TestFixHotPixels:
    def test_replaces_hot_pixel(self):
        img = np.full((8, 8), 1000, np.uint16)
        img[3, 4] = 4095
        out = np.array(fix_hot_pixels(jnp.asarray(img)))
        assert out[3, 4] == 1000
        assert (out == img).sum() == 63

    def test_small_excursion_kept(self):
        img = np.full((8, 8), 4000, np.uint16)
        img[3, 4] = 4095  # hot but change < min_change
        out = np.array(fix_hot_pixels(jnp.asarray(img)))
        assert out[3, 4] == 4095

    def test_too_many_hot(self):
        img = np.full((8, 8), 100, np.uint16)
        img.flat[:6] = 4095  # 6 > max_hot=5
        out = np.array(fix_hot_pixels(jnp.asarray(img)))
        np.testing.assert_array_equal(out, img)

    def test_edge_pixel(self):
        img = np.full((8, 8), 500, np.uint16)
        img[0, 0] = 4095
        out = np.array(fix_hot_pixels(jnp.asarray(img)))
        assert out[0, 0] == 500


class TestBlurs:
    def test_gaussian_vs_cv2(self, rng):
        img = rng.uniform(0, 4095, (64, 48)).astype(np.float32)
        for k in (3, 5, 7):
            ours = np.array(gaussian_blur(jnp.asarray(img), k))
            ref = cv2.GaussianBlur(img, (k, k), 0)
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=2e-2)

    def test_box_vs_cv2(self, rng):
        img = rng.uniform(0, 4095, (64, 48)).astype(np.float32)
        for k in (3, 5):
            ours = np.array(box_blur(jnp.asarray(img), k))
            ref = cv2.blur(img, (k, k), borderType=cv2.BORDER_REFLECT_101)
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=2e-2)


class TestScaling:
    def test_convert_to_8u(self):
        img = np.array([[0, 2048], [1024, 4095]], np.uint16)
        out = convert_to_8u(img)
        assert out.dtype == np.uint8
        assert out[0, 0] == 0 and out[1, 1] == 255

    def test_max_inlier_robust_to_outliers(self, rng):
        img = rng.uniform(0, 1000, (100, 100)).astype(np.uint16)
        img[0, 0] = 65535  # single saturated outlier must not set the scale
        out = scale_image_max_inlier(img)
        # most pixels should spread over the full 8-bit range
        assert out.max() == 255
        assert np.percentile(out, 99) > 200


class TestHistogramThreshold:
    def test_histc_counts(self):
        img = np.array([[0, 16, 16], [32, 4095, 5000]], np.uint16)
        edges, counts = intensity_histc(img, depth=12, bins=256)
        assert counts.sum() == 5  # 5000 >= 4096 excluded
        assert counts[0] == 1 and counts[1] == 2 and counts[2] == 1

    def test_first_min_threshold_bimodal(self):
        # clean bimodal histogram: dark peak at bin 2, valley at 5, peak at 8
        counts = np.array([1, 5, 30, 6, 3, 1, 4, 20, 40, 10, 2])
        idx = first_min_threshold(counts, 1)
        assert 4 <= idx <= 6


def _hot_pixel_reference(img, thresh=4064, min_change=512, max_hot=5):
    """Loop-form float64 reference of fix_hot_pixels (4-neighbor median)."""
    x = np.asarray(img, np.float64)
    H, W = x.shape
    hot = np.argwhere(x >= thresh)
    out = x.copy()
    if len(hot) > max_hot:
        return out
    for y, xx in hot:
        nb = [x[y + dy, xx + dx] for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))
              if 0 <= y + dy < H and 0 <= xx + dx < W]
        med = sorted(nb)[len(nb) // 2]
        if x[y, xx] - med > min_change:
            out[y, xx] = med
    return out


class TestFixHotPixelsReference:
    @pytest.mark.parametrize("n_hot,dtype", [
        (0, np.float32), (1, np.float32), (3, np.uint16), (5, np.float32),
        (6, np.float32), (4, np.uint16),
    ])
    def test_matches_loop_reference(self, n_hot, dtype):
        rng = np.random.default_rng(n_hot)
        img = rng.normal(2000, 200, (24, 32))
        pos = [(0, 0), (0, 31), (23, 5), (11, 0), (12, 17), (7, 9)][:n_hot]
        for y, x in pos:
            img[y, x] = 4090.0
        img = img.astype(dtype)
        got = np.asarray(fix_hot_pixels(jnp.asarray(img)), np.float64)
        np.testing.assert_array_equal(got, _hot_pixel_reference(img))


def _blur_reference(img, taps):
    """Separable float64 convolution with reflect-101 borders."""
    x = np.asarray(img, np.float64)
    r = len(taps) // 2
    for axis in (0, 1):
        p = np.pad(x, [(r, r) if a == axis else (0, 0) for a in (0, 1)],
                   mode="reflect")
        n = x.shape[axis]
        x = sum(
            t * np.take(p, np.arange(k, k + n), axis=axis)
            for k, t in enumerate(np.asarray(taps, np.float64))
        )
    return x


class TestBlursFloat64:
    @pytest.mark.parametrize("kind,k,shape", [
        ("gaussian", 3, (40, 56)), ("gaussian", 5, (40, 56)),
        ("gaussian", 7, (40, 56)), ("gaussian", 5, (33, 47)),
        ("box", 3, (40, 56)), ("box", 5, (33, 47)),
    ])
    def test_matches_float64(self, rng, kind, k, shape):
        from upsp_tpu.ops.image import gaussian_kernel_1d

        img = rng.uniform(0, 4095, shape).astype(np.float32)
        if kind == "gaussian":
            got = np.asarray(gaussian_blur(jnp.asarray(img), k))
            taps = gaussian_kernel_1d(k)
        else:
            got = np.asarray(box_blur(jnp.asarray(img), k))
            taps = np.full(k, 1.0 / k)
        np.testing.assert_allclose(got, _blur_reference(img, taps),
                                   rtol=1e-5, atol=2e-3)
