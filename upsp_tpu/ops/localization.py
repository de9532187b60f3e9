"""Sub-pixel target localization: batched super-Gaussian Levenberg–Marquardt.

The reference fits a "super 2D Gaussian" (platykurtic elliptical Gaussian,
power p) to a small crop around each detected target with scipy.curve_fit,
one target at a time (python/upsp/target_operations/
gaussian_localization_methods.py:17-436 — studied, not copied).  Here every
target fits simultaneously: fixed-size crops are gathered into a (T, K, K)
batch and a fixed-iteration LM loop runs under ``vmap`` — Jacobians via
``jacfwd``, all T solves in lockstep on the device.

Bounds are enforced through the reference's own "nobounds" reparameterization
(log amplitude / log sigma / p = exp(lnp) + 1).

Model (on the NEGATED image so dark dots become peaks):
  g(x, y) = A * exp(-(a dx^2 + 2 b dx dy + c dy^2)^p) + offset
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

SUPER_GAUSS_POWER_UPPER_BOUND = 20.0

# parameter vector: [ln_amp, xo, yo, ln_sx, ln_sy, theta, offset, ln_p]
N_PARAMS = 8


def super_gaussian(params: jax.Array, xg: jax.Array, yg: jax.Array) -> jax.Array:
    """Evaluate the super 2D Gaussian on a pixel grid (reparameterized)."""
    amp = jnp.exp(params[0])
    xo, yo = params[1], params[2]
    sx = jnp.exp(params[3])
    sy = jnp.exp(params[4])
    theta = params[5]
    offset = params[6]
    p = jnp.exp(params[7]) + 1.0

    dx = xg - xo
    dy = yg - yo
    cos_sq = jnp.cos(theta) ** 2
    sin_sq = jnp.sin(theta) ** 2
    sin2 = jnp.sin(2.0 * theta)
    a = cos_sq / (2 * sx * sx) + sin_sq / (2 * sy * sy)
    b = -sin2 / (4 * sx * sx) + sin2 / (4 * sy * sy)
    c = sin_sq / (2 * sx * sx) + cos_sq / (2 * sy * sy)
    quad = a * dx * dx + 2 * b * dx * dy + c * dy * dy
    # clamp the base so quad**p stays finite under jacfwd at quad -> 0
    quad = jnp.maximum(quad, 1e-12)
    return amp * jnp.exp(-jnp.power(quad, p)) + offset


def _residuals(params, patch, xg, yg, mask):
    pred = super_gaussian(params, xg, yg)
    return ((pred - patch) * mask).ravel()


@functools.partial(jax.jit, static_argnames=("n_iters",))
def fit_super_gaussian(
    patch: jax.Array,  # (K, K) negated crop (peak positive)
    init: jax.Array,  # (8,) initial parameter vector
    mask: jax.Array,  # (K, K) valid-pixel weights
    n_iters: int = 40,
) -> Tuple[jax.Array, jax.Array]:
    """Levenberg–Marquardt fit of one crop; returns (params, rms)."""
    K = patch.shape[0]
    yg, xg = jnp.meshgrid(
        jnp.arange(K, dtype=jnp.float32), jnp.arange(K, dtype=jnp.float32),
        indexing="ij",
    )

    def r_fn(p):
        return _residuals(p, patch, xg, yg, mask)

    jac_fn = jax.jacfwd(r_fn)

    def body(carry, _):
        params, lam = carry
        r = r_fn(params)
        J = jac_fn(params)  # (K*K, 8)
        JTJ = J.T @ J
        g = J.T @ r
        step_ok = False
        A = JTJ + lam * jnp.diag(jnp.maximum(jnp.diag(JTJ), 1e-8))
        dp = jnp.linalg.solve(A, g)
        new_params = params - dp
        new_cost = jnp.sum(r_fn(new_params) ** 2)
        cost = jnp.sum(r * r)
        improved = new_cost < cost
        params = jnp.where(improved, new_params, params)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-7, 1e7)
        return (params, lam), None

    (params, _), _ = jax.lax.scan(body, (init, jnp.float32(1e-2)), None, length=n_iters)
    r = r_fn(params)
    denom = jnp.maximum(jnp.sum(mask), 1.0)
    rms = jnp.sqrt(jnp.sum(r * r) / denom)
    return params, rms


def default_init(
    patch: jax.Array, center_xy: jax.Array, target_type_code: jax.Array
) -> jax.Array:
    """Reference initial guess: amp = max-mean, offset = mean, sizes by type.

    type codes: 0 = dot (size 1.2, p 3.2), 1 = kulite (size 0.8, p 1.8),
    2 = unknown (size 0.75, p 2.6).
    """
    amp0 = jnp.maximum(jnp.max(patch) - jnp.mean(patch), 1e-3)
    size = jnp.select(
        [target_type_code == 0, target_type_code == 1],
        [1.2, 0.8],
        0.75,
    )
    p0 = jnp.select(
        [target_type_code == 0, target_type_code == 1],
        [3.2, 1.8],
        2.6,
    )
    return jnp.stack(
        [
            jnp.log(amp0),
            center_xy[0],
            center_xy[1],
            jnp.log(size),
            jnp.log(size),
            jnp.asarray(0.0, jnp.float32),
            jnp.mean(patch),
            jnp.log(p0 - 1.0),
        ]
    )


class LocalizeResult(NamedTuple):
    centers: jax.Array  # (T, 2) refined positions (full-image coords)
    valid: jax.Array  # (T,) bool — fit accepted
    rms: jax.Array  # (T,)


@functools.partial(jax.jit, static_argnames=("crop_size", "n_iters"))
def localize_targets(
    img: jax.Array,  # (H, W)
    centers: jax.Array,  # (T, 2) float initial positions (x, y)
    type_codes: jax.Array,  # (T,) int 0=dot 1=kulite 2=other
    pads: jax.Array,  # (T,) int per-target pad radius
    crop_size: int = 11,  # static: 2*max_pad + 1
    max_localize_delta: jax.Array | None = None,  # (T,) or None -> pad-2
    n_iters: int = 40,
) -> LocalizeResult:
    """Batched sub-pixel localization of all targets in one image.

    Filtering parity with subpixel_localize (target_detection.py:18-180):
    out-of-bounds crops rejected; fits that move the center more than
    max_localize_delta (default pad-2) rejected.
    """
    H, W = img.shape
    T = centers.shape[0]
    imgf = -img.astype(jnp.float32)  # dark dots -> peaks

    center_px = jnp.rint(centers).astype(jnp.int32)  # (T, 2) x, y
    half = crop_size // 2
    x0 = center_px[:, 0] - half
    y0 = center_px[:, 1] - half

    # bbox validity uses the per-target pad (reference semantics)
    in_bounds = (
        (center_px[:, 0] - pads >= 0)
        & (center_px[:, 1] - pads >= 0)
        & (center_px[:, 0] + pads + 1 < W)
        & (center_px[:, 1] + pads + 1 < H)
    )

    def crop_one(ox, oy):
        return jax.lax.dynamic_slice(
            imgf, (jnp.clip(oy, 0, H - crop_size), jnp.clip(ox, 0, W - crop_size)),
            (crop_size, crop_size),
        )

    patches = jax.vmap(crop_one)(x0, y0)  # (T, K, K)

    # mask off pixels beyond each target's own pad radius (square mask)
    k = jnp.arange(crop_size)
    off = k[None, :] - half
    sq_mask = (
        (jnp.abs(off)[:, None, :] <= pads[:, None, None])
        & (jnp.abs(off)[:, :, None] <= pads[:, None, None])
    ).astype(jnp.float32)

    local_init_xy = centers - jnp.stack([x0, y0], axis=1).astype(centers.dtype)
    inits = jax.vmap(default_init)(
        patches, local_init_xy.astype(jnp.float32), type_codes
    )
    params, rms = jax.vmap(
        lambda p, i, m: fit_super_gaussian(p, i, m, n_iters=n_iters)
    )(patches, inits, sq_mask)

    local_xy = params[:, 1:3]
    refined = local_xy + jnp.stack([x0, y0], axis=1).astype(jnp.float32)

    if max_localize_delta is None:
        max_delta = (pads - 2).astype(jnp.float32)
    else:
        max_delta = max_localize_delta
    moved = jnp.linalg.norm(refined - centers.astype(jnp.float32), axis=1)
    # also reject fits whose center left the crop
    inside_crop = (
        (local_xy[:, 0] >= 0)
        & (local_xy[:, 0] <= crop_size - 1)
        & (local_xy[:, 1] >= 0)
        & (local_xy[:, 1] <= crop_size - 1)
    )
    valid = in_bounds & inside_crop & (moved <= jnp.maximum(max_delta, 0.5))
    return LocalizeResult(centers=refined, valid=valid, rms=rms)


TYPE_CODES = {"dot": 0, "kulite": 1}


def type_code(target_type: str) -> int:
    return TYPE_CODES.get(target_type, 2)
