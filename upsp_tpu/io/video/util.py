"""Packed-pixel (un)packing for high-speed camera formats.

10-bit and 12-bit pixels are packed MSBit-first (Vision Research / Photron
conventions; behavior parity with python/upsp/video/util.py:6-51 and
cpp/include/PSPVideo.h:188-215 — studied, not copied).  All routines are
vectorized numpy; ops/unpack.py holds the same bit math for on-device
unpacking of packed chunks.
"""

from __future__ import annotations

import numpy as np


def unpack_10bpp(buf: bytes | np.ndarray) -> np.ndarray:
    """5 bytes -> 4 10-bit pixels (MSBits first) as uint16."""
    b = np.frombuffer(buf, dtype=np.uint8).astype(np.uint16)
    n = b.size // 5 * 5
    b = b[:n]
    out = np.empty(n // 5 * 4, np.uint16)
    out[0::4] = (b[0::5] << 2) | (b[1::5] >> 6)
    out[1::4] = ((b[1::5] & 0x3F) << 4) | (b[2::5] >> 4)
    out[2::4] = ((b[2::5] & 0x0F) << 6) | (b[3::5] >> 2)
    out[3::4] = ((b[3::5] & 0x03) << 8) | b[4::5]
    return out


def unpack_12bpp(buf: bytes | np.ndarray) -> np.ndarray:
    """3 bytes -> 2 12-bit pixels (MSBits first) as uint16."""
    b = np.frombuffer(buf, dtype=np.uint8).astype(np.uint16)
    n = b.size // 3 * 3
    b = b[:n]
    out = np.empty(n // 3 * 2, np.uint16)
    out[0::2] = (b[0::3] << 4) | (b[1::3] >> 4)
    out[1::2] = ((b[1::3] & 0x0F) << 8) | b[2::3]
    return out


def pack_12bpp(pix: np.ndarray) -> np.ndarray:
    """Inverse of unpack_12bpp (values clipped to [0, 4095])."""
    pix = np.clip(np.asarray(pix), 0, 2**12 - 1).astype(np.uint16).ravel()
    if pix.size % 2:
        pix = np.concatenate([pix, np.zeros(1, np.uint16)])
    buf = np.empty(pix.size * 3 // 2, np.uint8)
    buf[0::3] = (pix[0::2] >> 4).astype(np.uint8)
    buf[1::3] = (((pix[0::2] & 0x0F) << 4) | (pix[1::2] >> 8)).astype(np.uint8)
    buf[2::3] = (pix[1::2] & 0xFF).astype(np.uint8)
    return buf


def pack_10bpp(pix: np.ndarray) -> np.ndarray:
    """Inverse of unpack_10bpp (values clipped to [0, 1023])."""
    pix = np.clip(np.asarray(pix), 0, 2**10 - 1).astype(np.uint16).ravel()
    pad = (-pix.size) % 4
    if pad:
        pix = np.concatenate([pix, np.zeros(pad, np.uint16)])
    buf = np.empty(pix.size * 5 // 4, np.uint8)
    buf[0::5] = (pix[0::4] >> 2).astype(np.uint8)
    buf[1::5] = (((pix[0::4] & 0x3) << 6) | (pix[1::4] >> 4)).astype(np.uint8)
    buf[2::5] = (((pix[1::4] & 0xF) << 4) | (pix[2::4] >> 6)).astype(np.uint8)
    buf[3::5] = (((pix[2::4] & 0x3F) << 2) | (pix[3::4] >> 8)).astype(np.uint8)
    buf[4::5] = (pix[3::4] & 0xFF).astype(np.uint8)
    return buf
