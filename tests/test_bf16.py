"""Parity of the bfloat16 compute path against the float32 pipeline.

``compute_dtype="bfloat16"`` keeps the inter-stage IMAGES in bf16 (halving
every image pass in device memory) while all reductions, warp parameters,
and solves stay f32.  These tests bound the quantization it introduces on the production
chunk program: warps within a few hundredths of a pixel and node intensities
within a small fraction of the ~sqrt(I) shot noise of real 12-bit data
(the same argument as the reduced-precision warp matmuls — ops/warp.py
precision note).

The f32 path remains the reference-parity mode; bf16 is opt-in
(run_datapoint(compute_dtype=...), upsp-process --compute-dtype bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from upsp_tpu.pipeline.phase1 import make_chunk_processor
from upsp_tpu.pipeline.synthetic import make_frame_batch, make_synthetic_state

HW = (192, 256)
GRID = (40, 32)


@pytest.fixture(scope="module")
def scene():
    state = make_synthetic_state(n_cameras=2, image_hw=HW, grid_shape=GRID)
    frames = make_frame_batch(state, 4)
    return state, frames


def _full_scale(state):
    return float(np.nanmax(np.asarray(state.ref_frames)))


@pytest.mark.slow
class TestChunkParity:
    def test_fft_mode_intensity_parity(self, scene):
        state, frames = scene
        f32 = make_chunk_processor(state, warm_start="fft", frame_batch=2)
        bf16 = make_chunk_processor(
            state, warm_start="fft", frame_batch=2, compute_dtype="bfloat16"
        )
        a = np.asarray(f32(jnp.asarray(frames)))
        b = np.asarray(bf16(jnp.asarray(frames)))
        assert a.shape == b.shape
        assert np.isnan(a).sum() == np.isnan(b).sum()
        m = ~np.isnan(a)
        diff = np.abs(a[m] - b[m])
        scale = _full_scale(state)
        # per-stage bf16 rounding is ~|I| * 2^-9 RMS; ~5 quantizing stages
        # (blur, per-GN warp x2, final warp, filter) stack to well under 1%
        # of full scale.  Mean error is unbiased rounding -> much tighter.
        assert diff.mean() < 2e-3 * scale, diff.mean() / scale
        assert np.quantile(diff, 0.999) < 2e-2 * scale

    def test_warp_parity(self, scene):
        """Oracle-anchored warp accuracy: bf16's distance to the CONVERGED
        f32 ECC fixed point must be comparable to the f32 production mode's
        own distance.  (A pairwise f32-vs-bf16 trajectory comparison is the
        wrong yardstick: on this weak-texture synthetic scene both modes sit
        ~0.2-0.3 px from the fixed point after 2 GN steps, so trajectory
        noise dominates.  Real-imagery parity at tight bounds is locked in
        tests/test_fixture_e2e.py::test_bf16_compute_dtype_vv_parity.)
        """
        state, frames = scene
        f32 = make_chunk_processor(
            state, warm_start="fft", frame_batch=2, with_telemetry=True
        )
        bf16 = make_chunk_processor(
            state, warm_start="fft", frame_batch=2, compute_dtype="bfloat16",
            with_telemetry=True,
        )
        oracle = make_chunk_processor(
            state, warm_start=False, ecc_epsilon=1e-6, ecc_max_iters=200,
            with_telemetry=True,
        )
        _, tele_a = f32(jnp.asarray(frames))
        _, tele_b = bf16(jnp.asarray(frames))
        _, tele_o = oracle(jnp.asarray(frames))
        tele_a, tele_b = np.asarray(tele_a), np.asarray(tele_b)
        tele_o = np.asarray(tele_o)
        # telemetry = [rho, iters, warp_tx, warp_ty] per (frame, camera)
        err_f32 = np.abs(tele_a[..., 2:] - tele_o[..., 2:])
        err_bf16 = np.abs(tele_b[..., 2:] - tele_o[..., 2:])
        assert err_bf16.max() < err_f32.max() + 0.1, (
            f"bf16 max {err_bf16.max():.3f} px vs f32 {err_f32.max():.3f} px"
        )
        assert err_bf16.max() < 0.5
        assert (tele_b[..., 0] > 0.9).all()  # rho still near-converged

    def test_while_loop_mode_runs_bf16(self, scene):
        """Identity-start while-loop ECC also honors compute_dtype."""
        state, frames = scene
        bf16 = make_chunk_processor(
            state, warm_start=False, compute_dtype="bfloat16"
        )
        f32 = make_chunk_processor(state, warm_start=False)
        a = np.asarray(f32(jnp.asarray(frames[:2])))
        b = np.asarray(bf16(jnp.asarray(frames[:2])))
        m = ~np.isnan(a)
        assert np.abs(a[m] - b[m]).mean() < 2e-3 * _full_scale(state)

    def test_rejects_unknown_dtype(self, scene):
        state, _ = scene
        with pytest.raises(ValueError, match="compute_dtype"):
            make_chunk_processor(state, compute_dtype="float16")


class TestOpsPreserveBf16:
    def test_gaussian_blur_dtype_and_value(self):
        from upsp_tpu.ops.image import gaussian_blur

        rng = np.random.default_rng(0)
        img = rng.uniform(0, 4096, (64, 96)).astype(np.float32)
        out32 = np.asarray(gaussian_blur(jnp.asarray(img), 5))
        out16 = gaussian_blur(jnp.asarray(img, jnp.bfloat16), 5)
        assert out16.dtype == jnp.bfloat16
        assert np.abs(np.asarray(out16, np.float32) - out32).max() < 32.0

    def test_warp_affine_mxu_dtype(self):
        from upsp_tpu.ops.warp import warp_affine_mxu

        rng = np.random.default_rng(1)
        img = rng.uniform(0, 4096, (64, 96)).astype(np.float32)
        w = jnp.asarray([[1.001, 1e-4, 0.3], [-1e-4, 0.999, -0.2]])
        out32 = np.asarray(warp_affine_mxu(jnp.asarray(img), w))
        out16 = warp_affine_mxu(jnp.asarray(img, jnp.bfloat16), w)
        assert out16.dtype == jnp.bfloat16
        assert np.abs(np.asarray(out16, np.float32) - out32).max() < 48.0

    def test_apply_patches_dtype(self, scene):
        from upsp_tpu.ops.patching import apply_patches

        state, frames = scene
        op = state.patch_ops[0]
        if op is None:
            pytest.skip("synthetic scene built without patches")
        img = jnp.asarray(frames[0, 0], jnp.bfloat16)
        out = apply_patches(img, op)
        assert out.dtype == jnp.bfloat16
        ref = np.asarray(apply_patches(jnp.asarray(frames[0, 0]), op))
        got = np.asarray(out, np.float32)
        assert np.abs(got - ref).max() < 48.0
