"""Phase-1 building blocks on an NVIDIA GPU against CPU and numpy references.

Marked ``gpu``: run with ``pytest -m gpu`` on a machine with a card (the
``gpu_device`` fixture skips them elsewhere).  Small shapes; the full-width
checks are in ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _scene(registration="pixel", n_cameras=2):
    from upsp_tpu.pipeline.synthetic import make_frame_batch, make_synthetic_state

    state = make_synthetic_state(
        n_cameras=n_cameras, image_hw=(96, 128), grid_shape=(40, 32),
        n_patch_dots=4, registration=registration,
    )
    return state, make_frame_batch(state, n_frames=4)


def test_unpack_exact(gpu_device, rng):
    from upsp_tpu.io.video.util import pack_12bpp, unpack_12bpp
    from upsp_tpu.ops.unpack import unpack_12bpp_jnp

    buf = pack_12bpp(rng.integers(0, 4096, 2 * 50000).astype(np.uint16))
    got = np.asarray(unpack_12bpp_jnp(jax.device_put(buf, gpu_device)))
    np.testing.assert_array_equal(got, unpack_12bpp(buf))


def test_gather_exact(gpu_device, rng):
    src = rng.random(200_000).astype(np.float32)
    idx = rng.integers(0, src.size, 50_000).astype(np.int32)
    got = jax.jit(lambda s, i: s[i])(
        jax.device_put(src, gpu_device), jax.device_put(idx, gpu_device)
    )
    np.testing.assert_array_equal(np.asarray(got), np.take(src, idx))


def test_dense_warp_matches_gather_warp_at_highest(gpu_device, rng):
    from upsp_tpu.ops.registration import warp_affine
    from upsp_tpu.ops.warp import warp_affine_mxu

    img = jax.device_put(
        rng.normal(2000, 300, (96, 128)).astype(np.float32), gpu_device
    )
    w = jnp.asarray([[1.0, 0.0, 0.37], [0.0, 1.0, -1.2]], jnp.float32)
    with jax.default_matmul_precision("highest"):
        dense = np.asarray(warp_affine_mxu(img, w))
    gather = np.asarray(warp_affine(img, w))
    inner = (slice(3, -3), slice(3, -3))
    np.testing.assert_allclose(dense[inner], gather[inner], rtol=1e-5, atol=0.05)


@pytest.mark.parametrize("precision,rtol", [("highest", 1e-4), (None, 1e-2)])
def test_chunk_program_matches_cpu(gpu_device, precision, rtol):
    """fft-mode chunk program on the GPU == the same program on the CPU
    backend; "highest" to f32 reduction order, default within TF32."""
    from upsp_tpu.pipeline.phase1 import make_chunk_processor

    state, frames = _scene()
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision(precision):
        fn = make_chunk_processor(state, warm_start="fft", frame_batch=2)
        got = np.asarray(fn(jax.device_put(frames, gpu_device)))
    with jax.default_device(cpu):
        st_cpu = state.to_device(cpu)
        fn_cpu = make_chunk_processor(st_cpu, warm_start="fft", frame_batch=2)
        ref = np.asarray(fn_cpu(jax.device_put(frames, cpu)))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol)
