"""FFT phase-correlation translation estimate (ECC initialization).

A device-side accelerator for the reference's image registration
(cpp/lib/registration.cpp:30-66 identity-starts every cv::findTransformECC
solve — studied, not copied): one rfft2 + cross-power spectrum + irfft2 +
argmax per frame estimates the dominant translation directly, and ECC then
starts inside its convergence basin and polishes to the affine optimum in
1-3 iterations instead of 5-15.

Unlike carrying the previous frame's warp (a ``lax.scan``), this estimate
depends ONLY on the frame itself, so results are bit-invariant to chunk and
shard boundaries — the property the reference gets from identity starts,
without paying identity-start iteration counts.  It also extends capture
range to +-H/(4*decimate) pixels (far beyond ECC's ~2-3 px basin at 1 MP).

Cost notes: the estimate runs on a ``decimate``x average-pooled image (an
ECC init needs ~1 px accuracy, not 0.05 px), which cuts the FFT cost
~decimate^2.  The template spectrum is computed INSIDE the traced program
(prepare_template) rather than embedded as a complex64 jit constant; XLA
hoists the per-chunk recomputation out of the frame loop.

The peak is refined to sub-pixel by a 3-point parabolic fit per axis
(standard phase-correlation practice).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def default_decimate(h: int, w: int) -> int:
    """Largest power of two keeping the pooled image at least 256 px (peak
    localization error scales with the pool factor; 256 px keeps the init
    within ~1 px at full resolution — inside ECC's basin)."""
    k = 1
    while min(h, w) // (2 * k) >= 256:
        k *= 2
    return k


def _pool_matrix(n: int, k: int) -> jax.Array:
    """(n//k, n) average-pooling matrix: row i averages source block i."""
    m = n // k
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (m, n), 1)
    return jnp.where(cols // k == rows, 1.0 / k, 0.0).astype(jnp.float32)


def decimate_image(img: jax.Array, k: int) -> jax.Array:
    """k x k average pool (crops to a multiple of k first).

    Lowered as two separable pooling MATMULS (P_h @ img @ P_w^T, ~0.5
    GFLOP at 1 MP).  Reduced-precision matmul passes (TF32 or bf16, a few
    counts on a 2000-count pooled pixel) are irrelevant here — the pooled
    image only seeds a ~1 px-accuracy phase-correlation init.
    """
    if k == 1:
        return img.astype(jnp.float32) if img.dtype == jnp.bfloat16 else img
    h, w = img.shape
    hh, ww = (h // k) * k, (w // k) * k
    # bf16 frames feed the pooling matmuls directly (no f32 conversion pass);
    # the f32 pool matrices promote the product, so the FFT still sees f32
    x = img[:hh, :ww]
    if x.dtype != jnp.bfloat16:
        x = x.astype(jnp.float32)
    return (_pool_matrix(hh, k) @ x @ _pool_matrix(ww, k).T).astype(jnp.float32)


def _pow2_floor(n: int) -> int:
    k = 1
    while k * 2 <= n:
        k *= 2
    return k


def pow2_center_crop(img: jax.Array) -> jax.Array:
    """Center-crop both dims to the largest power of two.

    Power-of-two sizes are the fast path of FFT libraries; arbitrary sizes
    fall back to slower mixed-radix or Bluestein plans.  Translation is
    preserved under a common centered crop of template and frame, and the
    capture range (crop/2 x decimate) stays in the hundreds of pixels.
    """
    h, w = img.shape
    h2, w2 = _pow2_floor(h), _pow2_floor(w)
    y0, x0 = (h - h2) // 2, (w - w2) // 2
    return img[y0 : y0 + h2, x0 : x0 + w2]


def _hann(n: int) -> jax.Array:
    k = jnp.arange(n, dtype=jnp.float32)
    return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * k / n)


def _parabolic(c: jax.Array, l: jax.Array, r: jax.Array) -> jax.Array:
    """Sub-sample peak offset from (left, center, right) correlation values."""
    denom = l - 2.0 * c + r
    off = 0.5 * (l - r) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    # a degenerate fit (flat top) stays at the integer peak
    return jnp.clip(off, -0.5, 0.5)


class CorrelationTemplate(NamedTuple):
    spectrum: jax.Array  # (H/k, W/k//2+1) complex64, conj-ready
    window: jax.Array  # (H/k, W/k) float32 (or scalar 1.0)
    decimate: int
    hw: tuple  # pooled (H, W)
    prior: jax.Array  # (H, W) float32 peak prior (or scalar 1.0)


def _displacement_prior(h: int, w: int, sigma: float) -> jax.Array:
    """Gaussian prior over WRAPPED displacement, centered at zero shift.

    Periodic scene content creates aliased correlation peaks a full texture
    period away; on uPSP data the true frame-to-frame motion is vibration of
    a few pixels (the reference's identity-start ECC assumes it is within
    the blur radius), so weighting the correlation surface toward zero
    displacement rejects distant aliases while leaving genuine shifts up to
    ~2 sigma competitive.
    """
    dy = jnp.minimum(jnp.arange(h, dtype=jnp.float32), h - jnp.arange(h, dtype=jnp.float32))
    dx = jnp.minimum(jnp.arange(w, dtype=jnp.float32), w - jnp.arange(w, dtype=jnp.float32))
    py = jnp.exp(-0.5 * (dy / sigma) ** 2)
    px = jnp.exp(-0.5 * (dx / sigma) ** 2)
    return py[:, None] * px[None, :]


def prepare_template(
    ref: jax.Array,
    decimate: int = 1,
    window: bool = True,
    prior_sigma_px: float | None = 12.0,
) -> CorrelationTemplate:
    """Template spectrum for :func:`correlate`.  MUST run inside jit on this
    backend (complex64 cannot cross the host boundary).

    ``prior_sigma_px``: width (FULL-RESOLUTION pixels) of the Gaussian
    displacement prior applied to the correlation surface; ``None`` disables
    it (pure phase correlation).
    """
    small = pow2_center_crop(decimate_image(ref.astype(jnp.float32), decimate))
    h, w = small.shape
    win = (_hann(h)[:, None] * _hann(w)[None, :]) if window else jnp.float32(1.0)
    prior = (
        _displacement_prior(h, w, prior_sigma_px / decimate)
        if prior_sigma_px is not None
        else jnp.float32(1.0)
    )
    return CorrelationTemplate(
        spectrum=jnp.fft.rfft2(small * win),
        window=win,
        decimate=decimate,
        hw=(h, w),
        prior=prior,
    )


def correlate(tmpl: CorrelationTemplate, img: jax.Array) -> jax.Array:
    """(tx, ty) float32 translation in full-resolution pixels.

    Convention matches :func:`upsp_tpu.ops.registration.warp_affine`
    (WARP_INVERSE_MAP): sampling ``img`` at ``(x + tx, y + ty)`` reproduces
    the template.
    """
    h, w = tmpl.hw
    small = pow2_center_crop(
        decimate_image(
            img if img.dtype == jnp.bfloat16 else img.astype(jnp.float32),
            tmpl.decimate,
        )
    )
    img_f = jnp.fft.rfft2(small * tmpl.window)
    cross = tmpl.spectrum * jnp.conj(img_f)
    cross = cross / (jnp.abs(cross) + 1e-8)
    surf = jnp.fft.irfft2(cross, s=(h, w)) * tmpl.prior
    idx = jnp.argmax(surf)
    py = idx // w
    px = idx % w
    # wrapped 3-point neighborhoods for the sub-pixel fit
    ym, yp = (py - 1) % h, (py + 1) % h
    xm, xp = (px - 1) % w, (px + 1) % w
    c = surf[py, px]
    oy = _parabolic(c, surf[ym, px], surf[yp, px])
    ox = _parabolic(c, surf[py, xm], surf[py, xp])
    fy = py.astype(jnp.float32) + oy
    fx = px.astype(jnp.float32) + ox
    # peak position p corresponds to displacement -p (mod N); center to
    # [-N/2, N/2) then negate to land in the warp convention
    dy = jnp.where(fy > h / 2, fy - h, fy)
    dx = jnp.where(fx > w / 2, fx - w, fx)
    return (jnp.stack([-dx, -dy]) * tmpl.decimate).astype(jnp.float32)


def make_phase_correlator(ref: jax.Array, window: bool = True, decimate: int = 1):
    """Bind the template: returns ``fn(img) -> (2,) float32 (tx, ty)``.

    Standalone convenience (tests, host-side use); inside chunk programs call
    :func:`prepare_template` once per chunk and :func:`correlate` per frame so
    the template spectrum is traced, not an eager complex constant.
    """

    def fn(img: jax.Array) -> jax.Array:
        return correlate(prepare_template(ref, decimate, window), img)

    return fn


def translation_warp(t: jax.Array) -> jax.Array:
    """(tx, ty) -> (2, 3) affine warp [[1,0,tx],[0,1,ty]]."""
    eye = jnp.eye(2, dtype=jnp.float32)
    return jnp.concatenate([eye, t.reshape(2, 1)], axis=1)
