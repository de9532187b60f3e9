"""On-device packed-pixel unpack (ops/unpack.py) vs the host unpackers."""

import numpy as np
import pytest

import jax.numpy as jnp

from upsp_tpu.io.video.util import pack_12bpp, unpack_12bpp
from upsp_tpu.ops.unpack import unpack_12bpp_jnp


class TestDeviceUnpack:
    def test_jnp_matches_host(self, rng):
        pix = rng.integers(0, 4096, 2 * 32768).astype(np.uint16)
        buf = pack_12bpp(pix)
        out = np.array(unpack_12bpp_jnp(jnp.asarray(buf)))
        np.testing.assert_array_equal(out, unpack_12bpp(buf))


class TestPackedChunkProcessor:
    def test_matches_host_decode_path(self):
        """Fused unpack+phase1 == host decode then phase1, exactly."""
        import jax.numpy as jnp

        from upsp_tpu.io.video.util import pack_12bpp
        from upsp_tpu.pipeline.phase1 import (
            make_packed_chunk_processor,
            process_frames,
        )
        from upsp_tpu.pipeline.synthetic import make_frame_batch, make_synthetic_state

        state = make_synthetic_state(
            n_cameras=2, image_hw=(64, 96), grid_shape=(24, 20),
            n_patch_dots=3, registration="none",
        )
        frames = make_frame_batch(state, n_frames=3)
        # quantize to the 12-bit camera domain so packing round-trips exactly
        q = np.clip(np.round(frames), 0, 4095).astype(np.uint16)
        packed = np.stack(
            [
                np.stack([pack_12bpp(q[f, c].reshape(-1)) for c in range(q.shape[1])])
                for f in range(q.shape[0])
            ]
        )  # (F, C, B) uint8
        fn = make_packed_chunk_processor(state)
        got = np.asarray(fn(jnp.asarray(packed)))
        want = np.asarray(process_frames(state, jnp.asarray(q)))
        np.testing.assert_array_equal(got, want)


class TestUnpack10:
    def test_jnp_matches_host(self, rng):
        import jax.numpy as jnp

        from upsp_tpu.io.video.util import pack_10bpp, unpack_10bpp
        from upsp_tpu.ops.unpack import unpack_10bpp_jnp

        pix = rng.integers(0, 1024, size=4 * 5000).astype(np.uint16)
        buf = pack_10bpp(pix)
        got = np.asarray(unpack_10bpp_jnp(jnp.asarray(buf)))
        np.testing.assert_array_equal(got, unpack_10bpp(buf))

    def test_packed_processor_10bit_with_lut(self):
        """10-bit packed chunk + companding LUT == host-decoded path."""
        import jax.numpy as jnp

        from upsp_tpu.io.video.cine import LUT_10_TO_12
        from upsp_tpu.io.video.util import pack_10bpp
        from upsp_tpu.pipeline.phase1 import (
            make_packed_chunk_processor,
            process_frames,
        )
        from upsp_tpu.pipeline.synthetic import make_frame_batch, make_synthetic_state

        state = make_synthetic_state(
            n_cameras=1, image_hw=(64, 96), grid_shape=(24, 20),
            n_patch_dots=3, registration="none",
        )
        frames = make_frame_batch(state, n_frames=2)
        # 10-bit camera domain
        q10 = np.clip(np.round(frames / 4.0), 0, 1023).astype(np.uint16)
        packed = np.stack(
            [
                np.stack([pack_10bpp(q10[f, c].reshape(-1)) for c in range(q10.shape[1])])
                for f in range(q10.shape[0])
            ]
        )
        fn = make_packed_chunk_processor(
            state, packed_bits=10, lut=LUT_10_TO_12
        )
        got = np.asarray(fn(jnp.asarray(packed)))
        want = np.asarray(
            process_frames(state, jnp.asarray(LUT_10_TO_12[q10].astype(np.uint16)))
        )
        np.testing.assert_array_equal(got, want)


class TestMakeUnpacker:
    """phase1._make_unpacker: (F, C, B) packed bytes -> (F, C, H, W)."""

    @pytest.mark.parametrize(
        "bits,shape",
        [(12, (2, 1, 4, 8)), (12, (3, 2, 6, 10)), (10, (2, 1, 4, 8)),
         (10, (1, 3, 8, 10))],
    )
    def test_shapes_match_host(self, rng, bits, shape):
        from upsp_tpu.io.video.util import pack_10bpp, unpack_10bpp
        from upsp_tpu.pipeline.phase1 import _make_unpacker

        F, C, H, W = shape
        pack, unpack = (
            (pack_12bpp, unpack_12bpp) if bits == 12
            else (pack_10bpp, unpack_10bpp)
        )
        pix = rng.integers(0, 2**bits, (F, C, H * W)).astype(np.uint16)
        packed = np.stack(
            [np.stack([pack(pix[f, c]) for c in range(C)]) for f in range(F)]
        )
        got = np.asarray(_make_unpacker(bits, None, (H, W))(jnp.asarray(packed)))
        assert got.shape == (F, C, H, W) and got.dtype == np.uint16
        want = np.stack(
            [np.stack([unpack(packed[f, c]) for c in range(C)]) for f in range(F)]
        ).reshape(F, C, H, W)
        np.testing.assert_array_equal(got, want)

    def test_lut_applied_on_device(self, rng):
        from upsp_tpu.io.video.cine import LUT_10_TO_12
        from upsp_tpu.io.video.util import pack_10bpp
        from upsp_tpu.pipeline.phase1 import _make_unpacker

        H, W = 4, 8
        pix = rng.integers(0, 1024, (2, 1, H * W)).astype(np.uint16)
        packed = np.stack([pack_10bpp(pix[f, 0])[None] for f in range(2)])
        got = np.asarray(
            _make_unpacker(10, LUT_10_TO_12, (H, W))(jnp.asarray(packed))
        )
        np.testing.assert_array_equal(
            got, LUT_10_TO_12[pix].reshape(2, 1, H, W)
        )

    def test_rejects_other_bit_depths(self):
        from upsp_tpu.pipeline.phase1 import _make_unpacker

        with pytest.raises(ValueError, match="packed_bits"):
            _make_unpacker(8, None, (4, 8))
