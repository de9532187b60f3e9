"""Phase-correlation ECC initialization: sign, accuracy, determinism."""

import numpy as np
import pytest

import jax.numpy as jnp

from upsp_tpu.ops.fftreg import make_phase_correlator, translation_warp
from upsp_tpu.ops.registration import ecc_affine, warp_affine


def _textured(rng, h=96, w=128):
    from scipy import ndimage

    img = 2000 + 400 * ndimage.gaussian_filter(rng.normal(size=(h, w)), 2.0)
    return img.astype(np.float32)


class TestPhaseCorrelator:
    @pytest.mark.parametrize("shift", [(3.0, -2.0), (0.4, 0.7), (-11.5, 6.25)])
    def test_recovers_translation(self, shift):
        """Estimated (tx, ty) matches the warp_affine convention: sampling
        the input at (x+tx, y+ty) reproduces the template."""
        from scipy import ndimage

        rng = np.random.default_rng(3)
        ref = _textured(rng)
        dx, dy = shift
        img = ndimage.shift(ref, (dy, dx), order=3, mode="nearest")
        t = np.asarray(make_phase_correlator(jnp.asarray(ref))(jnp.asarray(img)))
        # features moved by +d => warp translation is +d (see test_driver_mesh
        # warm-start analysis); a ~0.3 px error is ample for an ECC init
        np.testing.assert_allclose(t, [dx, dy], atol=0.35)

    def test_warp_convention_closes_loop(self):
        """warp_affine(img, translation_warp(t)) lands back on the template."""
        from scipy import ndimage

        rng = np.random.default_rng(4)
        ref = _textured(rng)
        img = ndimage.shift(ref, (4.0, -6.0), order=3, mode="nearest")
        t = make_phase_correlator(jnp.asarray(ref))(jnp.asarray(img))
        back = np.asarray(warp_affine(jnp.asarray(img), translation_warp(t)))
        interior = (slice(12, -12), slice(12, -12))
        err = np.abs(back[interior] - ref[interior])
        assert np.median(err) < 12.0  # ~0.5% of the 2000-count scale

    def test_extends_ecc_capture_range(self):
        """A 9-px shift is outside identity-start ECC's basin but converges
        from the phase-correlation init."""
        from scipy import ndimage

        rng = np.random.default_rng(5)
        ref = _textured(rng, 128, 160)
        img = ndimage.shift(ref, (9.0, -9.0), order=3, mode="nearest").astype(
            np.float32
        )
        r, i = jnp.asarray(ref), jnp.asarray(img)

        w_cold, _ = ecc_affine(r, i)
        cold_err = max(abs(float(w_cold[0, 2]) + 9.0), abs(float(w_cold[1, 2]) - 9.0))

        t = make_phase_correlator(r)(i)
        w_fft, _ = ecc_affine(r, i, warp_init=translation_warp(t))
        fft_err = max(abs(float(w_fft[0, 2]) + 9.0), abs(float(w_fft[1, 2]) - 9.0))
        assert fft_err < 0.5
        assert fft_err < cold_err

    def test_decimated_estimate(self):
        """4x average-pooled correlation still lands within ECC's basin."""
        from scipy import ndimage

        rng = np.random.default_rng(8)
        ref = _textured(rng, 256, 256)
        img = ndimage.shift(ref, (6.0, -10.0), order=3, mode="nearest")
        t = np.asarray(
            make_phase_correlator(jnp.asarray(ref), decimate=4)(jnp.asarray(img))
        )
        np.testing.assert_allclose(t, [-10.0, 6.0], atol=1.5)

    def test_default_decimate(self):
        from upsp_tpu.ops.fftreg import default_decimate

        assert default_decimate(1024, 1024) == 4
        assert default_decimate(64, 96) == 1
        assert default_decimate(2048, 1024) == 4

    def test_deterministic_vs_batching(self):
        """The estimate depends only on the frame — identical inside any
        chunk split (unlike the scan warm start)."""
        rng = np.random.default_rng(6)
        ref = _textured(rng)
        correlate = make_phase_correlator(jnp.asarray(ref))
        from scipy import ndimage

        img = ndimage.shift(ref, (1.3, 0.8), order=3, mode="nearest")
        t1 = np.asarray(correlate(jnp.asarray(img)))
        t2 = np.asarray(correlate(jnp.asarray(img.copy())))
        np.testing.assert_array_equal(t1, t2)


class TestFixedIterECC:
    def test_unrolled_matches_while_loop(self):
        """3 fixed Gauss-Newton steps from the fft init reach the while_loop
        fixed point (warp within convergence slop, rho not worse)."""
        from scipy import ndimage

        rng = np.random.default_rng(9)
        ref = _textured(rng, 128, 160)
        img = ndimage.shift(ref, (1.1, -2.3), order=3, mode="nearest").astype(
            np.float32
        )
        r, i = jnp.asarray(ref), jnp.asarray(img)
        init = translation_warp(make_phase_correlator(r)(i))
        w_while, rho_w = ecc_affine(r, i, warp_init=init)
        w_fix, rho_f = ecc_affine(r, i, warp_init=init, max_iters=3, unroll=True)
        np.testing.assert_allclose(np.asarray(w_fix), np.asarray(w_while), atol=0.02)
        assert float(rho_f) >= float(rho_w) - 1e-4

    def test_coarse_fine_matches_while_loop(self):
        """1 coarse (2x-decimated) + 1 fine GN step from the fft init reaches
        the while_loop fixed point — the production default (1/4-cost coarse
        step does the bulk correction, the full-res step anchors sub-pixel
        accuracy)."""
        from scipy import ndimage

        rng = np.random.default_rng(9)
        ref = _textured(rng, 128, 160)
        img = ndimage.shift(ref, (1.1, -2.3), order=3, mode="nearest").astype(
            np.float32
        )
        r, i = jnp.asarray(ref), jnp.asarray(img)
        init = translation_warp(make_phase_correlator(r)(i))
        w_while, rho_w = ecc_affine(r, i, warp_init=init)
        w_cf, rho_cf = ecc_affine(
            r, i, warp_init=init, max_iters=1, unroll=True, coarse_iters=1
        )
        np.testing.assert_allclose(np.asarray(w_cf), np.asarray(w_while), atol=0.02)
        assert float(rho_cf) >= float(rho_w) - 1e-4

    def test_vmappable(self):
        """The unrolled solve vmaps over a frame batch (while_loop doesn't)."""
        import jax
        from scipy import ndimage

        rng = np.random.default_rng(10)
        ref = _textured(rng, 96, 128)
        imgs = np.stack(
            [
                ndimage.shift(ref, (dy, dx), order=3, mode="nearest")
                for dx, dy in [(0.5, -0.3), (1.2, 0.8), (-0.7, 1.5), (2.0, -1.0)]
            ]
        ).astype(np.float32)
        r = jnp.asarray(ref)

        def solve(i):
            return ecc_affine(r, i, max_iters=3, unroll=True)[0]

        warps = jax.vmap(solve)(jnp.asarray(imgs))
        singles = np.stack([np.asarray(solve(jnp.asarray(i))) for i in imgs])
        np.testing.assert_allclose(np.asarray(warps), singles, atol=1e-5)


class TestChunkProcessorFFT:
    def test_frame_batch_matches_single(self, tmp_path):
        """map(vmap(4)) fft chunk == per-frame fft chunk within GN slop."""
        import sys

        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        import jax.numpy as jnp2
        from test_driver_mesh import _config, _frames

        from upsp_tpu.pipeline.phase0 import run_phase0
        from upsp_tpu.pipeline.phase1 import make_chunk_processor

        rng = np.random.default_rng(2)
        shifts = np.cumsum(rng.normal(0, 0.2, size=(10, 2)), axis=0)
        shifts[0] = 0
        frames = _frames(10, shifts=shifts)
        cfg = _config(tmp_path, registration="pixel")
        state = run_phase0(cfg, [frames[0, 0]], [12])
        single = make_chunk_processor(state, warm_start="fft", ecc_iters=3)
        batched = make_chunk_processor(
            state, warm_start="fft", frame_batch=4, ecc_iters=3
        )
        i1 = np.asarray(single(jnp2.asarray(frames)))
        i2 = np.asarray(batched(jnp2.asarray(frames)))  # 10 pads to 12
        v = np.isfinite(i1)
        # batched matmul layouts reassociate reductions: sub-count slop only
        np.testing.assert_allclose(i2[v], i1[v], rtol=1e-5, atol=0.05)
        assert i2.shape == i1.shape
    def test_fft_mode_sharding_invariant(self, tmp_path):
        """warm_start='fft' intensities are identical mesh vs single device."""
        import sys

        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from test_driver_mesh import _config, _frames

        from upsp_tpu.parallel.mesh import make_mesh
        from upsp_tpu.pipeline.run import run_datapoint

        rng = np.random.default_rng(0)
        shifts = np.cumsum(rng.normal(0, 0.15, size=(16, 2)), axis=0)
        shifts[0] = 0
        frames = _frames(16, shifts=shifts)
        out1 = run_datapoint(
            _config(tmp_path, out="o1", registration="pixel"),
            frames_array=frames, write_outputs=False, warm_start="fft",
        )
        out2 = run_datapoint(
            _config(tmp_path, out="o2", registration="pixel"),
            frames_array=frames, write_outputs=False, warm_start="fft",
            mesh=make_mesh(),
        )
        v = np.isfinite(out1.intensity)
        np.testing.assert_allclose(
            out2.intensity[v], out1.intensity[v], rtol=1e-5, atol=1e-3
        )


class TestBandedWarpPath:
    def test_integer_shift_matches_warp(self):
        """integer_shift == the warp convention for a pure integer t."""
        from upsp_tpu.ops.warp import integer_shift, warp_affine_mxu

        rng = np.random.default_rng(3)
        img = jnp.asarray(rng.normal(size=(40, 56)).astype(np.float32))
        for tx, ty in [(3, -2), (-7, 5), (0, 0)]:
            w = jnp.asarray(
                np.array([[1, 0, tx], [0, 1, ty]], np.float32)
            )
            a = np.asarray(warp_affine_mxu(img, w))
            b = np.asarray(
                integer_shift(img, jnp.asarray([tx, ty], jnp.float32))
            )
            np.testing.assert_allclose(a, b, atol=1e-5)

    def test_banded_equals_dense_warp(self):
        """Banded separable resample == dense tent matmuls within band."""
        from upsp_tpu.ops.warp import warp_affine_mxu

        rng = np.random.default_rng(4)
        img = jnp.asarray(rng.normal(size=(48, 64)).astype(np.float32))
        w = jnp.asarray(
            np.array([[1.001, 3e-4, 2.3], [-2e-4, 0.9993, -3.7]], np.float32)
        )
        d = np.asarray(warp_affine_mxu(img, w))
        b = np.asarray(warp_affine_mxu(img, w, band=8))
        np.testing.assert_allclose(b, d, atol=1e-4)


class TestPreShiftPipeline:
    """fft-mode integer pre-shift (phase1.make_chunk_processor)."""

    def _setup(self, tmp_path, shift_scale=0.8, F=8):
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).parent))
        from test_driver_mesh import _config, _frames

        from upsp_tpu.pipeline.phase0 import run_phase0

        rng = np.random.default_rng(3)
        shifts = np.cumsum(rng.normal(0, shift_scale, size=(F, 2)), axis=0)
        shifts[0] = 0
        frames = _frames(F, shifts=shifts)
        cfg = _config(tmp_path, registration="pixel")
        state = run_phase0(cfg, [frames[0, 0]], [12])
        return state, frames

    def test_pre_shift_matches_plain_fft(self, tmp_path):
        """Pre-shifted solve == full-warp solve (same optimum, same borders
        up to the sub-pixel boundary blend) — multi-pixel shifts included."""
        from upsp_tpu.pipeline.phase1 import make_chunk_processor

        state, frames = self._setup(tmp_path)
        plain = make_chunk_processor(
            state, warm_start="fft", ecc_iters=3, pre_shift=False
        )
        pre = make_chunk_processor(
            state, warm_start="fft", ecc_iters=3, pre_shift=True
        )
        i1 = np.asarray(plain(jnp.asarray(frames)))
        i2 = np.asarray(pre(jnp.asarray(frames)))
        v = np.isfinite(i1)
        assert np.isfinite(i2).sum() >= v.sum() - frames.shape[0]
        both = v & np.isfinite(i2)
        np.testing.assert_allclose(i2[both], i1[both], rtol=1e-4, atol=0.2)

    def test_telemetry_total_translation(self, tmp_path):
        """Pre-shift mode telemetry reports the composed (total) shift.

        Analytic multi-pixel shifts (no wrap artifacts): the phase
        correlator captures the integer part, so t_int is genuinely nonzero
        and the composed record must match the plain (no-pre-shift) path's
        total translation.
        """
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).parent))
        from test_driver_mesh import _config, _frames

        from upsp_tpu.pipeline.phase0 import run_phase0
        from upsp_tpu.pipeline.phase1 import make_chunk_processor

        shifts = [(0.0, 0.0), (2.3, -1.6), (-1.8, 2.2), (3.1, 0.4)]
        frames = _frames(4, shifts=shifts)
        cfg = _config(tmp_path, registration="pixel")
        state = run_phase0(cfg, [frames[0, 0]], [12])
        plain = make_chunk_processor(
            state, warm_start="fft", ecc_iters=3, pre_shift=False,
            with_telemetry=True,
        )
        pre = make_chunk_processor(
            state, warm_start="fft", ecc_iters=3, pre_shift=True,
            with_telemetry=True,
        )
        _, t1 = plain(jnp.asarray(frames))
        _, t2 = pre(jnp.asarray(frames))
        t1, t2 = np.asarray(t1), np.asarray(t2)
        assert np.abs(t2[:, :, 2:]).max() > 1.5  # total, not residual
        np.testing.assert_allclose(t2[:, :, 2:], t1[:, :, 2:], atol=0.1)
        np.testing.assert_allclose(t2[:, :, 0], t1[:, :, 0], atol=1e-3)


class TestPeriodicSceneRobustness:
    def test_prior_rejects_aliased_peaks(self):
        """Strongly periodic texture + small true shift: pure phase
        correlation locks onto an aliased peak a texture period away
        (regression: a 2000-frame production run produced garbage warps on
        half its frames); the displacement prior keeps the estimate at the
        true small shift."""
        yy, xx = np.mgrid[0:384, 0:512].astype(np.float32)
        base = 2000 + 300 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
        img = np.roll(base, (2, -1), (0, 1)).astype(np.float32)

        from upsp_tpu.ops.fftreg import correlate, prepare_template

        t_prior = np.asarray(
            correlate(prepare_template(jnp.asarray(base)), jnp.asarray(img))
        )
        assert np.abs(t_prior).max() < 4.0, t_prior
        # the unweighted estimate demonstrates the hazard on this scene
        t_raw = np.asarray(
            correlate(
                prepare_template(jnp.asarray(base), prior_sigma_px=None),
                jnp.asarray(img),
            )
        )
        # (raw may or may not alias depending on peak heights; the guarantee
        # under test is only the prior-weighted behavior above)
        assert t_prior.shape == t_raw.shape
