"""Image-space utilities: hot-pixel repair, blurs, scaling, histogram threshold.

JAX (jit/vmap-safe) versions of the reference's OpenCV-based helpers
(cpp/utils/cv_extras.cpp:138-272, cpp/lib/image_processing.ipp:11-60,
cpp/utils/clustering.ipp:63-96 — behavior studied, not copied).  Everything in
the per-frame path is branch-free so it fuses into the phase-1 XLA program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def fix_hot_pixels(
    img: jax.Array,
    thresh: int = 4064,
    min_change: int = 512,
    max_hot: int = 5,
) -> jax.Array:
    """Replace hot pixels (>= thresh) by the median of their 4-neighbors.

    If more than ``max_hot`` pixels look hot the frame is returned unchanged
    (matches cv_extras.cpp:230-272 semantics; replacement requires
    ``old - median > min_change``).  Vectorized: all hot pixels are repaired
    against the *original* frame rather than sequentially.
    """
    x = img.astype(jnp.float32)
    big = 3.0e38  # sentinel for missing neighbors
    xp = jnp.pad(x, 1, constant_values=big)
    up = xp[:-2, 1:-1]
    down = xp[2:, 1:-1]
    left = xp[1:-1, :-2]
    right = xp[1:-1, 2:]

    # branch-free 4-element sorting network (sentinels sink to the top), then
    # median index n_valid//2: 3rd-smallest when all 4 neighbors exist,
    # 2nd-smallest for edge (3) and corner (2) pixels
    n_valid = 4 - ((up >= big).astype(jnp.int32) + (down >= big) + (left >= big)
                   + (right >= big))
    lo1, hi1 = jnp.minimum(up, down), jnp.maximum(up, down)
    lo2, hi2 = jnp.minimum(left, right), jnp.maximum(left, right)
    mid_lo = jnp.maximum(lo1, lo2)  # 2nd or 3rd smallest
    mid_hi = jnp.minimum(hi1, hi2)  # the other of the middle pair
    s2 = jnp.minimum(mid_lo, mid_hi)  # 2nd smallest
    s3 = jnp.maximum(mid_lo, mid_hi)  # 3rd smallest
    median = jnp.where(n_valid == 4, s3, s2)

    hot = img >= thresh
    n_hot = hot.sum()
    replace = hot & ((x - median) > min_change) & (n_hot <= max_hot)
    return jnp.where(replace, median.astype(img.dtype), img)


def convert_to_8u(img: np.ndarray) -> np.ndarray:
    """Min-max scale to uint8 (diagnostic images; host-side)."""
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return np.rint((img - lo) * scale).clip(0, 255).astype(np.uint8)


def _reflect101_pad(x: jax.Array, r: int) -> jax.Array:
    """BORDER_REFLECT_101 padding on both spatial axes (cv2 default)."""
    return jnp.pad(x, ((r, r), (r, r)), mode="reflect")


_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array(
        [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        np.float32,
    ),
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV-compatible Gaussian kernel.

    For sigma<=0 and ksize in {1,3,5,7} cv2.getGaussianKernel returns fixed
    binomial-ish kernels; larger sizes derive sigma from ksize.
    """
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2
    xs = np.arange(ksize) - r
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_matrix_1d(n: int, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """(n, n) matrix form of the 1-D Gaussian blur with reflect-101 borders.

    Row i holds the kernel taps at reflected source indices, so applying
    ``B @ x`` along an axis equals :func:`gaussian_blur` along that axis
    exactly.  Used to pre-compose the ECC blur into the separable-warp tent
    matrices (ops/warp.py): the blur then costs one extra small matmul
    per warp instead of two full image passes per frame.
    """
    k = gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    if r >= n:
        raise ValueError(
            f"gaussian_blur_matrix_1d: kernel radius {r} (ksize={ksize}) "
            f"requires axis length > {r}, got {n} — the single reflect-101 "
            "fold only covers offsets within one image span"
        )
    B = np.zeros((n, n), np.float32)
    for t in range(ksize):
        off = t - r
        for i in range(n):
            j = i + off
            if j < 0:
                j = -j  # reflect-101: -1 -> 1
            elif j >= n:
                j = 2 * (n - 1) - j
            B[i, j] += k[t]
    return B


@functools.partial(jax.jit, static_argnames=("ksize",))
def gaussian_blur(img: jax.Array, ksize: int = 3, sigma: float = 0.0) -> jax.Array:
    """Separable Gaussian blur with reflect-101 borders (cv2.GaussianBlur parity).

    bfloat16 images stay bfloat16 (halves the HBM bytes of both passes; taps
    accumulate in f32 registers, one fused output cast) — part of the
    ``compute_dtype=bfloat16`` pipeline.  Everything else computes in f32.
    """
    out_dtype = img.dtype if img.dtype == jnp.bfloat16 else jnp.float32
    k = jnp.asarray(gaussian_kernel_1d(ksize, sigma))
    r = ksize // 2
    x = _reflect101_pad(img if img.dtype == out_dtype else img.astype(jnp.float32), r)
    # horizontal then vertical 1-D convolutions via dot products over shifts
    # (f32 kernel taps promote bf16 pixels to f32 in registers, so the
    # accumulation is full precision either way)
    xh = sum(k[i] * x[:, i : i + img.shape[1]] for i in range(ksize))
    xv = sum(k[i] * xh[i : i + img.shape[0], :] for i in range(ksize))
    return xv.astype(out_dtype)


@functools.partial(jax.jit, static_argnames=("ksize",))
def box_blur(img: jax.Array, ksize: int = 3) -> jax.Array:
    """Normalized box filter with reflect-101 borders (cv2.blur parity)."""
    out_dtype = img.dtype if img.dtype == jnp.bfloat16 else jnp.float32
    r = ksize // 2
    x = _reflect101_pad(img.astype(jnp.float32), r)
    xh = sum(x[:, i : i + img.shape[1]] for i in range(ksize))
    xv = sum(xh[i : i + img.shape[0], :] for i in range(ksize))
    return (xv / float(ksize * ksize)).astype(out_dtype)


def apply_filter(img: jax.Array, filter_type: str, ksize: int) -> jax.Array:
    """Dispatch on the input-deck FilterType (none/gaussian/box)."""
    if filter_type == "gaussian":
        return gaussian_blur(img, ksize)
    if filter_type == "box":
        return box_blur(img, ksize)
    return img if img.dtype == jnp.bfloat16 else img.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Histogram-based patch threshold (phase-0, host-side numpy)


def intensity_histc(img: np.ndarray, depth: int = 12, bins: int = 256):
    """Histogram counts/edges over [0, 2^depth) with ceil-sized bins."""
    img = np.asarray(img)
    max_value = 2**depth
    bin_sz = int(np.ceil(max_value / bins))
    counts = np.zeros(bins, np.int64)
    vals = img[img < max_value].astype(np.int64) // bin_sz
    np.add.at(counts, vals, 1)
    edges = np.arange(bins + 1, dtype=np.int64) * bin_sz
    return edges, counts


def find_peaks(data: np.ndarray, separation: int = 1) -> list:
    """Local maxima with plateau handling and a minimum index separation."""
    data = np.asarray(data, np.float64)
    peaks = []
    n = len(data)
    plateau = False
    plateau_begin = 0
    for i in range(n - 1):
        if not plateau:
            rising = data[i] > data[i + 1] and (i == 0 or data[i] > data[i - 1])
            if rising:
                if peaks and (i - peaks[-1]) < separation:
                    if data[peaks[-1]] < data[i]:
                        peaks[-1] = i
                    continue
                peaks.append(i)
            elif i > 0 and data[i] > data[i - 1] and data[i] == data[i + 1]:
                plateau = True
                plateau_begin = i
        else:
            if data[i] < data[i + 1]:
                plateau = False
            elif data[i] > data[i + 1]:
                plateau = False
                plateau_i = (i + plateau_begin) // 2
                if peaks and (plateau_i - peaks[-1]) < separation:
                    if data[peaks[-1]] < data[plateau_i]:
                        peaks[-1] = plateau_i
                    continue
                peaks.append(plateau_i)
    return peaks


def first_min_threshold(counts: np.ndarray, separation: int = 1) -> int:
    """Index of the first histogram valley after the first (dark) peak.

    Used to size fiducial patches to their darkened pixels
    (psp_process.cpp:2157-2158).
    """
    counts = np.asarray(counts, np.float64)
    max_peaks = find_peaks(counts, separation)
    if not max_peaks:
        return 0
    with np.errstate(divide="ignore"):
        inv = np.where(counts > 0, 1.0 / counts, np.inf)
    min_peaks = find_peaks(np.where(np.isfinite(inv), inv, np.nanmax(inv[np.isfinite(inv)]) if np.isfinite(inv).any() else 0.0), separation)
    first_max = max_peaks[0]
    for p in min_peaks:
        if p > first_max:
            return p
    return 0


def patch_threshold_from_frame(img: np.ndarray, bit_depth: int = 12) -> int:
    """The full reference recipe: histc -> first-min valley -> +5 offset."""
    edges, counts = intensity_histc(img, depth=bit_depth, bins=256)
    return int(edges[first_min_threshold(counts, 5)] + 5)


def scale_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Clip to `scale`, normalize to [0,1], round to uint8 [0,255]."""
    img_temp = np.minimum(np.asarray(img), scale).astype(np.float64) / scale
    return np.rint(img_temp * 255).astype(np.uint8)


def scale_image_max_inlier(img: np.ndarray) -> np.ndarray:
    """Normalize so the max *inlier* intensity maps to 255 (uint8).

    Max inlier = largest sorted intensity[i] with
    ``0.9 * intensity[i] <= intensity[round(i * 0.999)]`` — robust to a few
    saturated pixels (docs/md/upsp-swdd.md:94-108,
    python/upsp/cam_cal_utils/img_utils.py:57-89 semantics).
    """
    img_flat = np.sort(np.asarray(img).ravel())
    i = len(img_flat) - 1
    while i > 0 and 0.9 * img_flat[i] > img_flat[min(int(np.rint(i * 0.999)), i - 1)]:
        i -= 1
    return scale_image(img, scale=float(img_flat[i]))
