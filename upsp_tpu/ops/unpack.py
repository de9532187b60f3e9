"""On-device packed-pixel unpacking.

Raw high-speed video is 10- or 12-bit packed (1.25 / 1.5 bytes per pixel).
Unpacking on the *device* means the host->device transfer ships packed bytes
— 25% (12-bit) or 37.5% (10-bit) less traffic per frame than pre-unpacked
uint16 — and the bit shuffling fuses into one elementwise XLA loop.  The
byte order matches the host unpackers in ``io/video/util.py`` (MSBits
first), which the tests use as the oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def unpack_12bpp_jnp(packed: jax.Array) -> jax.Array:
    """Packed 12-bit buffer (3G,) uint8 -> (2G,) uint16 pixels."""
    G = packed.shape[0] // 3
    b = packed[: G * 3].reshape(G, 3).astype(jnp.uint16)
    hi = (b[:, 0] << 4) | (b[:, 1] >> 4)
    lo = ((b[:, 1] & 0x0F) << 8) | b[:, 2]
    return jnp.stack([hi, lo], axis=1).reshape(2 * G)


@jax.jit
def unpack_10bpp_jnp(packed: jax.Array) -> jax.Array:
    """Packed 10-bit buffer (5G,) uint8 -> (4G,) uint16 pixels."""
    G = packed.shape[0] // 5
    b = packed[: G * 5].reshape(G, 5).astype(jnp.uint16)
    p0 = (b[:, 0] << 2) | (b[:, 1] >> 6)
    p1 = ((b[:, 1] & 0x3F) << 4) | (b[:, 2] >> 4)
    p2 = ((b[:, 2] & 0x0F) << 6) | (b[:, 3] >> 2)
    p3 = ((b[:, 3] & 0x03) << 8) | b[:, 4]
    return jnp.stack([p0, p1, p2, p3], axis=1).reshape(4 * G)
