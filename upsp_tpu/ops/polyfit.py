"""Time-series polynomial detrend — the Phase-2 compute core, as matmuls.

The reference fits a degree-6 polynomial over normalized frame index to each
node's Iref/I series with a per-node QR solve (cpp/lib/filtering.ipp:12-77 —
studied, not copied).  Least-squares fit + evaluation is linear, so we
precompute the projector once:

    basis   A = [(f/F)^c]            (F, C)
    fitter  P = A @ pinv(A)          (F, F)  — or two skinny matmuls

and per node-block the detrend is ``fit = Y @ P.T`` — pure matmul work batched
over the whole (nodes_shard, frames) block instead of a QR per node.

``pinv(A)`` is computed once in float64 on the host; the device matmuls run in
float32 with float32 accumulation (preferred_element_type).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PolyDetrender(NamedTuple):
    basis: jax.Array  # (F, C) float32 — orthonormal basis Q (spans Vandermonde)
    pinv: jax.Array  # (C, F) float32 — Q^T (projector = basis @ pinv)
    to_monomial: jax.Array  # (C, C) — R^-1: Q-basis coeffs -> monomial coeffs

    @property
    def n_frames(self) -> int:
        return self.basis.shape[0]

    @property
    def n_coeffs(self) -> int:
        return self.basis.shape[1]


def make_detrender(n_frames: int, degree: int = 6) -> PolyDetrender:
    """Build the degree-`degree` polynomial projector over (f/F) frame index.

    The raw monomial Vandermonde has condition ~1e4 at degree 6, which
    amplifies f32 round-off in the fit by the same factor.  Orthonormalizing
    the columns (QR in f64) spans the identical polynomial subspace but makes
    the device-side matmuls O(1)-conditioned: fit = Q (Q^T y).  ``to_monomial``
    recovers reference-format monomial coefficients for save/restore.
    """
    # cap the polynomial order at what the frame count can support
    degree = min(degree, max(n_frames - 1, 0))
    f = np.arange(n_frames, dtype=np.float64) / n_frames
    A = np.stack([f**c for c in range(degree + 1)], axis=1)  # (F, C)
    Q, R = np.linalg.qr(A)
    return PolyDetrender(
        basis=jnp.asarray(Q, jnp.float32),
        pinv=jnp.asarray(Q.T, jnp.float32),
        to_monomial=jnp.asarray(np.linalg.inv(R)),  # f64 under x64, else f32
    )


def monomial_coeffs(det: PolyDetrender, coeffs: jax.Array) -> jax.Array:
    """Q-basis coefficients (..., C) -> monomial coefficients (low->high)."""
    return jnp.einsum("dc,...c->...d", det.to_monomial.astype(coeffs.dtype),
                      coeffs)


@jax.jit
def fit_coeffs(det: PolyDetrender, series: jax.Array) -> jax.Array:
    """Least-squares coefficients for each row: series (..., F) -> (..., C)."""
    return jnp.einsum(
        "...f,cf->...c", series, det.pinv, preferred_element_type=jnp.float32
    )


@jax.jit
def eval_fit(det: PolyDetrender, coeffs: jax.Array) -> jax.Array:
    """Evaluate fitted polynomials at every frame: (..., C) -> (..., F)."""
    return jnp.einsum(
        "...c,fc->...f", coeffs, det.basis, preferred_element_type=jnp.float32
    )


@jax.jit
def detrend(det: PolyDetrender, series: jax.Array) -> jax.Array:
    """series - polynomial fit, batched over leading dims (nodes)."""
    return series - eval_fit(det, fit_coeffs(det, series))


def polyfit_1d(x: np.ndarray, y: np.ndarray, degree: int) -> np.ndarray:
    """Host-side generic polynomial fit (coeffs low->high), parity helper."""
    A = np.stack([np.asarray(x, np.float64) ** c for c in range(degree + 1)], axis=1)
    coeffs, *_ = np.linalg.lstsq(A, np.asarray(y, np.float64), rcond=None)
    return coeffs


def polyval_1d(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    A = np.stack(
        [np.asarray(x, np.float64) ** c for c in range(len(coeffs))], axis=1
    )
    return A @ np.asarray(coeffs)


# ---------------------------------------------------------------------------
# coefficient save/restore (TransPolyFitter::write_coeffs format parity:
# int32 check=1, int32 val_size, int32 rows(C), int32 cols(N), then data)


def write_coeffs(filename: str, coeffs: np.ndarray) -> None:
    """coeffs (C, N) float32 -> reference-compatible binary file."""
    c = np.asarray(coeffs, np.float32)
    with open(filename, "wb") as f:
        np.array([1, 4, c.shape[0], c.shape[1]], np.int32).tofile(f)
        c.T.ravel().astype(np.float32).tofile(f)  # column-major like Eigen


def read_coeffs(filename: str) -> np.ndarray:
    with open(filename, "rb") as f:
        hdr = np.fromfile(f, np.int32, 4)
        if hdr[0] != 1:
            raise ValueError("bad coefficients file header")
        if hdr[1] != 4:
            raise ValueError("only float32 coefficient files supported")
        rows, cols = int(hdr[2]), int(hdr[3])
        data = np.fromfile(f, np.float32, rows * cols)
    return data.reshape(cols, rows).T  # back from column-major
