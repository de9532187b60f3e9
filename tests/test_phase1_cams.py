"""Camera-vmapped phase-1 path vs the per-camera Python loop.

``vmap_cameras`` (opt-in) replaces the per-camera loop with a camera-axis
vmap so the warp/tent matmuls batch across cameras.  The loop is the
default; the vmapped path remains a tested capability (its speed on the GPU
is not measured yet).  vmap of the same program must be
numerically equivalent op-for-op; these tests lock that on the multi-camera
synthetic scene for the batchable modes (fft-init unrolled ECC and
no-registration).
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
    state = make_synthetic_state(n_cameras=3, image_hw=HW, grid_shape=GRID)
    frames = make_frame_batch(state, 4)
    return state, frames


def _run(state, frames, **kw):
    fn = make_chunk_processor(state, with_telemetry=True, **kw)
    sol, tele = fn(jnp.asarray(frames))
    return np.asarray(sol), np.asarray(tele)


@pytest.mark.slow
class TestCameraVmapEquivalence:
    def test_fft_mode(self, scene):
        state, frames = scene
        sol_l, tele_l = _run(
            state, frames, warm_start="fft", frame_batch=2, vmap_cameras=False
        )
        sol_v, tele_v = _run(
            state, frames, warm_start="fft", frame_batch=2, vmap_cameras=True
        )
        assert np.isnan(sol_l).sum() == np.isnan(sol_v).sum()
        m = ~np.isnan(sol_l)
        np.testing.assert_allclose(sol_l[m], sol_v[m], rtol=1e-4, atol=1e-2)
        # warps agree to sub-millipixel
        np.testing.assert_allclose(
            tele_l[..., 2:], tele_v[..., 2:], atol=1e-3
        )

    def test_no_registration_mode(self, scene):
        state, frames = scene
        import dataclasses

        cfg = dataclasses.replace(state.config, registration="none")
        state_n = dataclasses.replace(state, config=cfg)
        sol_l, _ = _run(state_n, frames, frame_batch=2, vmap_cameras=False)
        sol_v, _ = _run(state_n, frames, frame_batch=2, vmap_cameras=True)
        m = ~np.isnan(sol_l)
        np.testing.assert_allclose(sol_l[m], sol_v[m], rtol=1e-5, atol=1e-3)

    def test_default_is_loop_path(self, scene):
        """vmap_cameras is opt-in: the default equals the loop path
        bit-for-bit."""
        state, frames = scene
        sol_d, _ = _run(state, frames, warm_start="fft", frame_batch=2)
        sol_l, _ = _run(
            state, frames, warm_start="fft", frame_batch=2, vmap_cameras=False
        )
        m = ~np.isnan(sol_d)
        np.testing.assert_array_equal(sol_d[m], sol_l[m])

    def test_bf16_composes_with_camera_vmap(self, scene):
        state, frames = scene
        sol_l, _ = _run(
            state, frames, warm_start="fft", frame_batch=2,
            vmap_cameras=False, compute_dtype="bfloat16",
        )
        sol_v, _ = _run(
            state, frames, warm_start="fft", frame_batch=2,
            vmap_cameras=True, compute_dtype="bfloat16",
        )
        m = ~np.isnan(sol_l)
        scale = float(np.nanmax(np.asarray(state.ref_frames)))
        assert np.abs(sol_l[m] - sol_v[m]).mean() < 2e-3 * scale
