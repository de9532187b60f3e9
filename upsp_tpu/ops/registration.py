"""Per-frame image registration: ECC affine alignment, pure JAX.

Replaces ``cv::findTransformECC`` + ``cv::warpAffine`` (cpp/lib/
registration.cpp:31-84 — behavior studied, not copied) with the
Evangelidis–Psarakis Enhanced-Correlation-Coefficient maximization written as a
``lax.while_loop`` of fused image ops + one small 6x6 solve per iteration.

Conventions (identical to the reference):
- The warp ``W`` (2x3) maps *template/reference* pixel coords to *input* image
  coords: an aligned output is ``out(x) = input(W @ [x, y, 1])``.
- Iteration cap 50, epsilon 1e-3 on the correlation-coefficient increment
  (psp_process.cpp:1665-1667 defaults).
- Bilinear (or nearest) sampling, constant-zero borders.

Everything is ``vmap``-able over a frame batch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from upsp_tpu.ops.image import gaussian_blur
from upsp_tpu.ops.warp import warp_affine_mxu, warp_validity_mask


def identity_warp(dtype=jnp.float32) -> jax.Array:
    return jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype)


def _sample_bilinear(img: jax.Array, xs: jax.Array, ys: jax.Array) -> jax.Array:
    """Bilinear sample with constant-0 out-of-bounds (cv2 BORDER_CONSTANT)."""
    H, W = img.shape
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)]
        return jnp.where(inb, v, 0.0)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def _sample_nearest(img: jax.Array, xs: jax.Array, ys: jax.Array) -> jax.Array:
    H, W = img.shape
    xi = jnp.rint(xs).astype(jnp.int32)
    yi = jnp.rint(ys).astype(jnp.int32)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    v = img[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)]
    return jnp.where(inb, v, 0.0)


@functools.partial(jax.jit, static_argnames=("interpolation",))
def warp_affine(img: jax.Array, warp: jax.Array, interpolation: str = "linear"):
    """out(y, x) = img(W @ [x, y, 1]) — cv2.warpAffine WARP_INVERSE_MAP parity."""
    H, W = img.shape
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=img.dtype), jnp.arange(W, dtype=img.dtype), indexing="ij"
    )
    wx = warp[0, 0] * xs + warp[0, 1] * ys + warp[0, 2]
    wy = warp[1, 0] * xs + warp[1, 1] * ys + warp[1, 2]
    if interpolation == "nearest":
        return _sample_nearest(img, wx, wy)
    return _sample_bilinear(img, wx, wy)


def _chol_factor_unrolled(H: jax.Array, n: int = 6):
    """Compile-time-unrolled Cholesky of a tiny SPD matrix.

    ``jnp.linalg.inv``/``solve`` lower tiny LU factorizations to serial,
    latency-bound loops (or library calls) per solve; unrolling the n=6
    factorization into scalar ops lets it fuse with the surrounding
    reductions, and it vmaps over frame batches with no per-batch dispatch.
    Returns L as a Python list-of-lists of traced scalars.
    """
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_unrolled(L, b: jax.Array, n: int = 6) -> jax.Array:
    """Solve (L L^T) x = b with the unrolled factor from above."""
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _gradients(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Central differences with replicated edges ([-0.5, 0, 0.5] filter)."""
    gx = jnp.zeros_like(img)
    gx = gx.at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    gy = jnp.zeros_like(img)
    gy = gy.at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    return gx, gy


@functools.partial(jax.jit, static_argnames=("max_iters", "gauss_size", "levels"))
def ecc_affine_pyramid(
    ref: jax.Array,
    inp: jax.Array,
    max_iters: int = 50,
    epsilon: float = 1e-3,
    gauss_size: int = 5,
    levels: int = 2,
):
    """Coarse-to-fine ECC: estimate at 2^k decimation, refine at full res.

    Extends the capture range beyond single-level ECC (which needs the
    initial displacement within the blur radius) to ~2^levels x larger
    motions, at lower total cost — the coarse iterations run on 4^k fewer
    pixels.  Returns (warp, rho) like :func:`ecc_affine`.
    """
    from upsp_tpu.ops.warp import downsample2, scale_warp

    warp = identity_warp()
    for lev in range(levels - 1, -1, -1):
        r, i = ref.astype(jnp.float32), inp.astype(jnp.float32)
        for _ in range(lev):
            r = downsample2(r)
            i = downsample2(i)
        warp_lv = scale_warp(warp, 0.5**lev)
        warp_lv, rho, _ = _ecc_core(
            r, i, warp_lv, max_iters=max_iters, epsilon=epsilon,
            gauss_size=gauss_size,
        )
        warp = scale_warp(warp_lv, 2.0**lev)
    return warp, rho


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iters", "gauss_size", "return_iters", "unroll", "coarse_iters",
        "band",
    ),
)
def ecc_affine(
    ref: jax.Array,
    inp: jax.Array,
    max_iters: int = 50,
    epsilon: float = 1e-3,
    gauss_size: int = 5,
    warp_init: jax.Array | None = None,
    return_iters: bool = False,
    unroll: bool = False,
    coarse_iters: int = 0,
    band: int | None = None,
    valid_shift: jax.Array | None = None,
):
    """Estimate the 2x3 affine warp aligning ``inp`` to ``ref`` by ECC maximization.

    ``warp_init`` warm-starts the iteration (e.g. the previous frame's warp —
    model vibration is temporally coherent, so this typically converges in
    1-3 iterations instead of 5-15; the converged solution is unchanged since
    the objective and stopping rule are identical).  Returns (warp, rho), or
    (warp, rho, conv) with ``return_iters`` — the per-sequence telemetry that
    drives epsilon/iteration-budget tuning in production runs.  ``conv`` is
    the iteration count in while-loop mode; in ``unroll`` (fixed-iteration)
    mode it is the final |drho| instead — the count is a compile-time
    constant there, while |drho| < epsilon certifies the solve reached the
    while_loop fixed point.

    ``valid_shift``: (2,) integer translation already applied to ``inp``
    (the fft pre-shift); the validity mask composes it back in so the
    shift's zero strip never enters the statistics.
    """
    init = identity_warp() if warp_init is None else warp_init
    if unroll and coarse_iters > 0:
        # coarse-to-fine for the fixed-iteration path: Gauss-Newton steps on
        # a 2x box-decimated pair cost 1/4 of a full-resolution step, and the
        # final full-res step(s) anchor sub-pixel accuracy (same two-scale
        # structure as ecc_affine_pyramid, without data-dependent control
        # flow so the whole solve still vmaps over frame batches)
        from upsp_tpu.ops.warp import downsample2, scale_warp

        rc = downsample2(ref.astype(jnp.float32))
        ic = downsample2(inp.astype(jnp.float32))
        vs_c = None if valid_shift is None else valid_shift * 0.5
        wc, _, _ = _ecc_core(
            rc, ic, scale_warp(init, 0.5), max_iters=coarse_iters,
            epsilon=epsilon, gauss_size=gauss_size, unroll=True, band=band,
            valid_shift=vs_c,
        )
        init = scale_warp(wc, 2.0)
    out = _ecc_core(ref, inp, init, max_iters=max_iters,
                    epsilon=epsilon, gauss_size=gauss_size, unroll=unroll,
                    band=band, valid_shift=valid_shift)
    return out if return_iters else out[:2]


def gn_statistics(
    iw: jax.Array, tmpl: jax.Array, warp: jax.Array, mask_warp: jax.Array
):
    """Masked Gauss-Newton statistics of one ECC step.

    ``iw``: the input warped by ``warp``; ``tmpl``: the (blurred) template;
    ``mask_warp``: the warp whose in-bounds region masks the statistics
    (``warp`` with any integer pre-shift composed back in).  Returns
    (Hessian G^T G (6, 6), G^T i_zm (6,), G^T t_zm (6,), |i_zm|^2,
    <t_zm, i_zm>, |t_zm|) for the zero-mean masked images and the
    steepest-descent images G of p = [a00 a10 a01 a11 tx ty].
    """
    dtype = jnp.float32
    H, W = tmpl.shape
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=dtype), jnp.arange(W, dtype=dtype), indexing="ij"
    )
    gix, giy = _gradients(iw)
    # closed-form 2x2 inverse-transpose (see _chol_factor_unrolled)
    a00, a01 = warp[0, 0], warp[0, 1]
    a10, a11 = warp[1, 0], warp[1, 1]
    detA = a00 * a11 - a01 * a10
    gx = (a11 * gix - a10 * giy) / detA
    gy = (-a01 * gix + a00 * giy) / detA

    # validity mask: pixels whose warped sample lies fully in-bounds.
    # All statistics/projections are restricted to it (findTransformECC
    # warps its mask the same way); without this the constant-0 border
    # drags the mean and diverges the solve.
    m = warp_validity_mask((H, W), mask_warp)
    area = jnp.maximum(jnp.sum(m), 1.0)
    gx = gx * m
    gy = gy * m

    t_mean = jnp.sum(tmpl * m) / area
    t_zm = (tmpl - t_mean) * m
    tmpl_norm = jnp.maximum(jnp.sqrt(jnp.sum(t_zm * t_zm)), 1e-12)
    i_mean = jnp.sum(iw * m) / area
    i_zm = (iw - i_mean) * m

    # The steepest-descent images for p = [a00 a10 a01 a11 tx ty] are
    # G = [gx*x, gy*x, gx*y, gy*y, gx, gy].  Materializing G (a (HW, 6)
    # matrix) would cost 24 MB/frame of device-memory traffic at 1 MP;
    # every entry of G^T G and every projection G^T z is instead a
    # monomial-weighted reduction over {gx*gx, gx*gy, gy*gy} that XLA
    # can fuse into a few passes over the gradient images.
    gxx, gxy, gyy = gx * gx, gx * gy, gy * gy

    def mom(im):
        return (
            jnp.sum(im * xs * xs), jnp.sum(im * xs * ys),
            jnp.sum(im * ys * ys), jnp.sum(im * xs),
            jnp.sum(im * ys), jnp.sum(im),
        )

    a_xx, a_xy, a_yy, a_x, a_y, a_1 = mom(gxx)
    b_xx, b_xy, b_yy, b_x, b_y, b_1 = mom(gxy)
    c_xx, c_xy, c_yy, c_x, c_y, c_1 = mom(gyy)
    Hmat = jnp.array(
        [
            [a_xx, b_xx, a_xy, b_xy, a_x, b_x],
            [b_xx, c_xx, b_xy, c_xy, b_x, c_x],
            [a_xy, b_xy, a_yy, b_yy, a_y, b_y],
            [b_xy, c_xy, b_yy, c_yy, b_y, c_y],
            [a_x, b_x, a_y, b_y, a_1, b_1],
            [b_x, c_x, b_y, c_y, b_1, c_1],
        ],
        dtype,
    )

    def proj(z):
        return jnp.array(
            [
                jnp.sum(gx * xs * z), jnp.sum(gy * xs * z),
                jnp.sum(gx * ys * z), jnp.sum(gy * ys * z),
                jnp.sum(gx * z), jnp.sum(gy * z),
            ],
            dtype,
        )

    return (Hmat, proj(i_zm), proj(t_zm), jnp.sum(i_zm * i_zm),
            jnp.sum(t_zm * i_zm), tmpl_norm)


def _ecc_core(
    ref: jax.Array,
    inp: jax.Array,
    warp_init: jax.Array,
    max_iters: int = 50,
    epsilon: float = 1e-3,
    gauss_size: int = 5,
    unroll: bool = False,
    band: int | None = None,
    valid_shift: jax.Array | None = None,
):
    dtype = jnp.float32
    # compute_dtype=bfloat16 pipeline: bf16 inputs keep the IMAGES bf16
    # through blur/warp (halving every image pass) while warp parameters, moment
    # reductions, and the 6x6 solve stay f32 — products of bf16 pixels with
    # f32 coordinates promote to f32 in registers, so all accumulation is
    # full precision.
    im_dtype = (
        jnp.bfloat16
        if (ref.dtype == jnp.bfloat16 or inp.dtype == jnp.bfloat16)
        else dtype
    )
    tmpl = gaussian_blur(ref.astype(im_dtype), gauss_size)
    img = gaussian_blur(inp.astype(im_dtype), gauss_size)

    def body(state):
        warp, rho_prev, drho, it = state
        # separable matmul warp (see ops/warp.py), and ONE
        # warp per iteration: warped gradients come from the warped image by
        # the affine chain rule  grad(img)(Wp) = A^-T grad_p[img(Wp)],
        # exact for affine warps up to the same finite-difference error as
        # differentiating the unwarped image.
        iw = warp_affine_mxu(img, warp, order=2, band=band)
        # when the input was integer-pre-shifted (fft mode), the zero strip
        # it introduced corresponds to samples the COMPOSED warp would take
        # out of bounds — mask with the composed translation so the strip
        # never enters the statistics (findTransformECC's warped mask
        # behaves the same way)
        mask_warp = (
            warp
            if valid_shift is None
            else jnp.concatenate(
                [warp[:, :2], (warp[:, 2] + valid_shift)[:, None]], axis=1
            )
        )
        Hmat, i_proj, t_proj, iw_norm2, corr, tmpl_norm = gn_statistics(
            iw, tmpl, warp, mask_warp
        )
        # scale-aware Tikhonov: keeps the solve finite when the warp walks
        # off the image and the masked Hessian degenerates (the reference's
        # cv2 throws in that case; we freeze on the last finite iterate)
        reg = 1e-9 * jnp.trace(Hmat) / 6.0 + 1e-12
        Lc = _chol_factor_unrolled(Hmat + reg * jnp.eye(6, dtype=dtype))
        Hinv_i = _chol_solve_unrolled(Lc, i_proj)  # Hinv @ i_proj
        Hinv_t = _chol_solve_unrolled(Lc, t_proj)  # Hinv @ t_proj
        num = iw_norm2 - i_proj @ Hinv_i
        den = corr - t_proj @ Hinv_i
        lam = num / jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)
        # dp = Hinv @ proj(lam*t_zm - i_zm), and proj is linear in z
        dp = lam * Hinv_t - Hinv_i

        dwarp = jnp.array(
            [[dp[0], dp[2], dp[4]], [dp[1], dp[3], dp[5]]], dtype
        )
        new_warp = warp + dwarp
        new_warp = jnp.where(jnp.isfinite(new_warp), new_warp, warp)
        rho = corr / jnp.maximum(tmpl_norm * jnp.sqrt(iw_norm2), 1e-12)
        rho = jnp.where(jnp.isfinite(rho), rho, jnp.asarray(-1.0, dtype))
        return new_warp, rho, jnp.abs(rho - rho_prev), it + 1

    def cond(state):
        _, _, drho, it = state
        return (it < max_iters) & (drho >= epsilon)

    init = (
        warp_init.astype(dtype),
        jnp.asarray(-1.0, dtype),
        jnp.asarray(jnp.inf, dtype),
        0,
    )
    step = body
    if unroll:
        # fixed iteration count, statically unrolled: no data-dependent
        # control flow, so the whole solve vmaps over a frame batch (the
        # while_loop version does not vmap usefully — all lanes run to the
        # slowest).  Pair with a phase-correlation init (ops/fftreg.py):
        # Gauss-Newton converges quadratically from inside the basin, so
        # max_iters=2-3 reaches the while_loop fixed point.
        # The third return is the FINAL |drho| — a real convergence signal
        # (the iteration count is a static constant here and carries no
        # information; |drho| < epsilon means the solve reached the same
        # fixed point the while_loop stopping rule accepts).
        state = init
        for _ in range(max_iters):
            state = step(state)
        warp, rho, drho, _ = state
        return warp, rho, drho
    warp, rho, _, iters = jax.lax.while_loop(cond, step, init)
    return warp, rho, iters


@functools.partial(jax.jit, static_argnames=("max_iters", "interpolation"))
def register_frame(
    ref: jax.Array,
    inp: jax.Array,
    max_iters: int = 50,
    epsilon: float = 1e-3,
    interpolation: str = "linear",
):
    """ECC-align ``inp`` to ``ref`` and return (aligned image, warp, rho).

    Mirrors upsp::register_pixel (registration.cpp:31-84): the warp estimated on
    blurred/float images is applied to the *raw* input.
    """
    warp, rho = ecc_affine(ref, inp, max_iters=max_iters, epsilon=epsilon)
    if interpolation == "nearest":
        aligned = warp_affine(inp.astype(jnp.float32), warp, interpolation="nearest")
    else:
        aligned = warp_affine_mxu(inp.astype(jnp.float32), warp)
    return aligned, warp, rho
