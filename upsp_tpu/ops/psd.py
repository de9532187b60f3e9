"""Batched Welch PSD over grid nodes — surface spectra at campaign scale.

The reference computes PSDs only for a handful of kulite channels via
scipy.signal.welch (kulite_utilities.py:451-490).  This framework makes the
*whole surface* spectral: a (nodes_shard, frames) block maps to
(nodes_shard, freqs) with one rFFT batch per Welch segment — device work that
shards over the node axis like the rest of phase 2.

Matches scipy.signal.welch(window='hann', detrend='linear'|'constant',
scaling='density', onesided) within float tolerance.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _hann(n: int) -> np.ndarray:
    # periodic=False (symmetric) like scipy.signal.get_window('hann', n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.partial(
    jax.jit, static_argnames=("nperseg", "noverlap", "detrend")
)
def welch_psd(
    series: jax.Array,  # (..., F)
    fs: float,
    nperseg: int = 1024,
    noverlap: int | None = None,
    detrend: str = "linear",
) -> Tuple[jax.Array, jax.Array]:
    """Welch power spectral density over the last axis.

    Returns (freqs (nfreq,), psd (..., nfreq)).
    """
    F = series.shape[-1]
    nperseg = min(nperseg, F)
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    n_seg = max((F - nperseg) // step + 1, 1)

    win = jnp.asarray(_hann(nperseg), series.dtype)
    win_norm = jnp.sum(win * win)

    starts = jnp.arange(n_seg) * step

    def segment(s):
        seg = jax.lax.dynamic_slice_in_dim(series, s, nperseg, axis=-1)
        if detrend == "linear":
            x = jnp.arange(nperseg, dtype=seg.dtype)
            xm = jnp.mean(x)
            xc = x - xm
            denom = jnp.sum(xc * xc)
            slope = jnp.sum(seg * xc, axis=-1, keepdims=True) / denom
            intercept = jnp.mean(seg, axis=-1, keepdims=True)
            seg = seg - (intercept + slope * xc)
        elif detrend == "constant":
            seg = seg - jnp.mean(seg, axis=-1, keepdims=True)
        spec = jnp.fft.rfft(seg * win, axis=-1)
        return (spec.real**2 + spec.imag**2) / (fs * win_norm)

    psd = jnp.mean(jax.vmap(segment, out_axes=0)(starts), axis=0)
    # one-sided correction: double all bins except DC (and Nyquist if present)
    nfreq = nperseg // 2 + 1
    scale = jnp.ones(nfreq, series.dtype) * 2.0
    scale = scale.at[0].set(1.0)
    if nperseg % 2 == 0:
        scale = scale.at[-1].set(1.0)
    psd = psd * scale
    freqs = jnp.arange(nfreq, dtype=series.dtype) * (fs / nperseg)
    return freqs, psd


def surface_psd(
    pressure_transpose: jax.Array,  # (nodes, frames) delta-Cp
    frame_rate: float,
    nperseg: int = 1024,
) -> Tuple[jax.Array, jax.Array]:
    """Whole-surface PSD map: (freqs, (nodes, nfreq)); NaN nodes stay NaN."""
    return welch_psd(pressure_transpose, frame_rate, nperseg=nperseg)
