"""Affine image warping by separable matmul resampling.

A bilinear 1-D resample is a sparse tent-function matrix, and a *separable*
affine (scale + translation) is exactly two such matmuls:

    out = R @ img @ C.T          R (H,H), C (W,W), 2 nonzeros per row

with R[i,j] = max(0, 1 - |y_src(i) - j|) — which reproduces bilinear
interpolation *and* cv2's BORDER_CONSTANT zero-border semantics exactly.

General affines add shear terms.  uPSP registration warps are near-identity
(|off-diagonal| ~ 1e-3, sub-pixel shear displacement across the frame), so the
shear residual is applied as a 2nd-order Taylor correction using central
differences of the separably-warped image.  Exact for pure scale+translation;
O(d^3) error in the shear displacement d (sub-pixel here).

This replaces the per-iteration gather warps inside ECC registration
(cv::findTransformECC's warpAffine calls — registration.cpp:63-80) and the
final frame warp.  The gather-bilinear warp (ops/registration.warp_affine) is
the plain reference it is tested against.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def _tent_matrix(
    n_out: int, n_src: int, positions: jax.Array, dtype=None
) -> jax.Array:
    """(n_out, n_src) bilinear sampling matrix: row i samples src at positions[i].

    ``dtype``: output dtype — positions/weights are always computed in f32
    (bf16 cannot represent pixel indices past 256 exactly); a bf16 output
    cast fuses into the same elementwise expression (one tiled write), so a
    bf16 image pipeline never pays a separate conversion pass.
    """
    j = jnp.arange(n_src, dtype=positions.dtype)
    t = jnp.maximum(0.0, 1.0 - jnp.abs(positions[:, None] - j[None, :]))
    return t if dtype is None else t.astype(dtype)


def _resample_rows_banded(img: jax.Array, pos: jax.Array, band: int) -> jax.Array:
    """Row resample out[i, :] = sum_j tent(pos[i] - j) img[j, :], banded.

    The dense tent matrix has 2 nonzeros per row; when |pos[i] - i| <= band-1
    (near-identity warps — uPSP vibration is a few px, and the reference's
    own identity-start ECC assumes motion within the blur radius), only
    diagonals i-band..i+band contribute, so the (H,H)@(H,W) matmul
    (2.6 GFLOP at 2 MP) collapses to 2*band+1 fused weighted adds
    (bandwidth-bound, one pass).  Zero padding reproduces the dense matrix's
    BORDER_CONSTANT semantics exactly.
    """
    H = img.shape[0]
    base = jnp.arange(H, dtype=pos.dtype)
    pad = jnp.pad(img, ((band, band), (0, 0)))
    out = jnp.zeros_like(img)
    for d in range(-band, band + 1):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(pos - (base + d)))
        out = out + w[:, None] * pad[band + d : band + d + H, :]
    return out


def _resample_cols_banded(img: jax.Array, pos: jax.Array, band: int) -> jax.Array:
    """Column analog of :func:`_resample_rows_banded`."""
    W = img.shape[1]
    base = jnp.arange(W, dtype=pos.dtype)
    pad = jnp.pad(img, ((0, 0), (band, band)))
    out = jnp.zeros_like(img)
    for d in range(-band, band + 1):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(pos - (base + d)))
        out = out + w[None, :] * pad[:, band + d : band + d + W]
    return out


@functools.partial(jax.jit, static_argnames=("order", "band", "pre_blur"))
def warp_affine_mxu(
    img: jax.Array,
    warp: jax.Array,
    order: int = 2,
    band: int | None = None,
    pre_blur: int | None = None,
) -> jax.Array:
    """out(y, x) = img(W @ [x, y, 1]) via separable matmuls + shear Taylor.

    ``order``: 0 = separable part only (ignore shear), 1/2 = Taylor order for
    the shear residual.  Matches gather-bilinear to O(shear_disp^(order+1)).
    ``band``: use the banded elementwise resample instead of the dense
    matmuls — exact (no matmul rounding) while every sample displacement
    stays within band-1 px; serves as the precision oracle for the dense
    path.
    ``pre_blur``: Gaussian ksize composed INTO the tent matrices, computing
    ``warp(gaussian_blur(img, pre_blur))`` without ever materializing the
    blurred image: warp∘blur = (R @ By) @ img @ (C @ Bx)^T by associativity
    (both are linear), trading two full image passes per frame for two
    small matmuls per warp.  Exact for the separable part;
    the shear-Taylor derivatives are taken from the blurred+warped image,
    matching blur-then-warp to the same Taylor order.  Dense path only.
    """
    H, W = img.shape
    # bf16 images stay bf16 (the compute_dtype=bfloat16 pipeline: no dtype
    # conversion pass around each matmul); positions/tent weights are
    # computed in f32 for index accuracy and cast to the image dtype.
    dtype = img.dtype if img.dtype == jnp.bfloat16 else jnp.float32
    img = img.astype(dtype)
    if pre_blur is not None and band is not None:
        from upsp_tpu.ops.image import gaussian_blur

        img = gaussian_blur(img, pre_blur)
        pre_blur = None
    warp = warp.astype(jnp.float32)
    a00, a01, tx = warp[0, 0], warp[0, 1], warp[0, 2]
    a10, a11, ty = warp[1, 0], warp[1, 1], warp[1, 2]

    ys = jnp.arange(H, dtype=jnp.float32)
    xs = jnp.arange(W, dtype=jnp.float32)
    cy = (H - 1) * 0.5
    cx = (W - 1) * 0.5

    # separable sample positions (residual shear centered at the image middle)
    y_sep = a11 * ys + ty + a10 * cx
    x_sep = a00 * xs + tx + a01 * cy
    if band is not None:
        img = img.astype(jnp.float32)
        dtype = jnp.float32
        sep = _resample_cols_banded(
            _resample_rows_banded(img, y_sep, band), x_sep, band
        )
    else:
        R = _tent_matrix(H, H, y_sep, dtype)
        C = _tent_matrix(W, W, x_sep, dtype)
        if pre_blur is not None:
            from upsp_tpu.ops.image import gaussian_blur_matrix_1d

            R = R @ jnp.asarray(gaussian_blur_matrix_1d(H, pre_blur))
            C = C @ jnp.asarray(gaussian_blur_matrix_1d(W, pre_blur))
        # Precision: these f32 matmuls run at JAX's default matmul
        # precision, which on an NVIDIA H100 lets cuBLAS use TF32 passes
        # (10-bit operand mantissa, f32 accumulation): a 1024^3 f32 matmul
        # lands 5.3e-5 (relative to its largest entry) from float64, against
        # 2.0e-6 at "highest".  On the four worst-registered frames of
        # chip_smoke.py's deck, phase-1 intensities differ from the
        # CPU-backend values by 3.6e-4 of full scale at the 99th percentile
        # and 6.5e-4 at most (an H100 80GB HBM3 at 400 W), under the
        # ~sqrt(I) ~ 50-count shot noise of real 12-bit data.  A patch operator multiplies the rounding of its
        # boundary ring by its fill gain (ops/patching.fill_gain: ~3.4 for
        # a whole ring, thousands for a ring the threshold emptied, which
        # phase 0 warns of).  The production default keeps TF32;
        # ``jax.default_matmul_precision("highest")`` around the call removes
        # it (full f32 passes, 1.75x the warp time there), and band=8 removes
        # it exactly.
        sep = R @ img @ C.T

    if order == 0:
        return sep

    # shear residual displacement in source coords:
    #   dy(x) = a10 * (x - cx)   (same for every row)
    #   dx(y) = a01 * (y - cy)
    dy = (a10 * (xs - cx))[None, :]  # (1, W)
    dx = (a01 * (ys - cy))[:, None]  # (H, 1)

    # derivatives of img at the separable sample points, from central
    # differences of `sep` (chain rule: d sep/d x_out = a00 * img_x).
    # Derivative scratch arrays are f32 even on the bf16 path (the inv_a*
    # scale factors are f32, so the set values are f32; a bf16 scatter would
    # be an unsafe implicit downcast) — the final cast below restores dtype.
    inv_ax = 1.0 / a00
    inv_ay = 1.0 / a11
    sep32 = sep.astype(jnp.float32)
    gx = jnp.zeros(sep.shape, jnp.float32)
    gx = gx.at[:, 1:-1].set(0.5 * (sep32[:, 2:] - sep32[:, :-2]) * inv_ax)
    gy = jnp.zeros(sep.shape, jnp.float32)
    gy = gy.at[1:-1, :].set(0.5 * (sep32[2:, :] - sep32[:-2, :]) * inv_ay)

    out = sep + dx * gx + dy * gy
    if order >= 2:
        gxx = jnp.zeros(sep.shape, jnp.float32)
        gxx = gxx.at[:, 1:-1].set(
            (sep32[:, 2:] - 2 * sep32[:, 1:-1] + sep32[:, :-2]) * inv_ax * inv_ax
        )
        gyy = jnp.zeros(sep.shape, jnp.float32)
        gyy = gyy.at[1:-1, :].set(
            (sep32[2:, :] - 2 * sep32[1:-1, :] + sep32[:-2, :]) * inv_ay * inv_ay
        )
        gxy = jnp.zeros(sep.shape, jnp.float32)
        gxy = gxy.at[1:-1, 1:-1].set(
            0.25
            * (
                sep32[2:, 2:] - sep32[2:, :-2] - sep32[:-2, 2:] + sep32[:-2, :-2]
            )
            * inv_ax
            * inv_ay
        )
        out = out + 0.5 * dx * dx * gxx + dx * dy * gxy + 0.5 * dy * dy * gyy
    # bf16 images: the shear-Taylor terms promote to f32 (dx/dy are f32
    # coordinate ramps); one fused cast returns the image to the pipeline's
    # compute dtype so downstream passes stay half-width
    return out.astype(dtype)


@functools.partial(jax.jit, static_argnames=("shape_hw",))
def warp_validity_mask(
    shape_hw: Tuple[int, int], warp: jax.Array
) -> jax.Array:
    """(H, W) float mask: 1 where the separable sample is fully in-bounds."""
    H, W = shape_hw
    dtype = jnp.float32
    ys = jnp.arange(H, dtype=dtype)
    xs = jnp.arange(W, dtype=dtype)
    cy = (H - 1) * 0.5
    cx = (W - 1) * 0.5
    y_sep = warp[1, 1] * ys + warp[1, 2] + warp[1, 0] * cx
    x_sep = warp[0, 0] * xs + warp[0, 2] + warp[0, 1] * cy
    my = ((y_sep >= 0.0) & (y_sep <= H - 1.0)).astype(dtype)
    mx = ((x_sep >= 0.0) & (x_sep <= W - 1.0)).astype(dtype)
    return my[:, None] * mx[None, :]


def downsample2(img: jax.Array) -> jax.Array:
    """2x box downsample (pyramid level construction).

    Reshape-mean formulation (one reduction over a free reshape) rather
    than four strided slices.
    """
    H, W = img.shape
    h2, w2 = H // 2, W // 2
    return img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))


MAX_INTEGER_SHIFT = 64  # px; see integer_shift


def integer_shift(img: jax.Array, t_int: jax.Array,
                  max_shift: int = MAX_INTEGER_SHIFT) -> jax.Array:
    """Zero-filled integer translation: out(y, x) = img(y + ty, x + tx).

    ``t_int``: (2,) [tx, ty] integer-valued (float ok), |t| <= max_shift.
    Matches sampling the image at the translated position with
    BORDER_CONSTANT zeros — the warp convention of :func:`warp_affine_mxu`
    for a pure integer translation.

    Implemented as pad + ``dynamic_slice`` (a dynamic ``jnp.roll`` lowers to
    a concatenate+gather pair).  Shifts beyond ``max_shift`` clamp; callers
    must clamp their own shift record the same way (phase1 does) so the
    composed warp stays consistent — an over-clamped frame then carries the
    excess in its ECC residual.  Production shifts are ~1 px (prior sigma
    12 px), so the clamp is a never-taken guard rail.
    """
    H, W = img.shape
    M = max_shift
    tx = jnp.clip(t_int[0].astype(jnp.int32), -M, M)
    ty = jnp.clip(t_int[1].astype(jnp.int32), -M, M)
    p = jnp.pad(img, ((M, M), (M, M)))
    return jax.lax.dynamic_slice(p, (M + ty, M + tx), (H, W))


def scale_warp(warp: jax.Array, factor: float) -> jax.Array:
    """Rescale a warp between pyramid levels (translation scales, A doesn't).

    Elementwise (no .at scatter): this runs inside the batched ECC solve,
    where a vmapped scatter would be a separate op per batch.
    """
    scale = jnp.array([[1.0, 1.0, factor], [1.0, 1.0, factor]], warp.dtype)
    return warp * scale
