"""Patching operator and detrend tests (fit-then-eval oracle parity)."""

import numpy as np
import pytest

import jax.numpy as jnp

from upsp_tpu.ops.patching import (
    apply_patches,
    build_patch_clusters,
    build_patch_operator,
    cluster_targets,
    polyfit2d,
    polyval2d,
    threshold_bounds,
)
from upsp_tpu.ops.polyfit import (
    detrend,
    eval_fit,
    fit_coeffs,
    make_detrender,
    polyfit_1d,
    read_coeffs,
    write_coeffs,
)


class TestClustering:
    def test_far_targets_separate(self):
        uv = np.array([[10.0, 10.0], [50.0, 50.0]])
        d = np.array([4.0, 4.0])
        groups = cluster_targets(uv, d, bound_pts=4)
        assert len(groups) == 2

    def test_close_targets_merge(self):
        uv = np.array([[10.0, 10.0], [16.0, 10.0], [80.0, 80.0]])
        d = np.array([4.0, 4.0, 4.0])
        groups = cluster_targets(uv, d, bound_pts=4)
        assert len(groups) == 2
        assert sorted(len(g) for g in groups) == [1, 2]

    def test_chain_merging(self):
        # a-b close, b-c close, a-c far: all one cluster via BFS
        uv = np.array([[10.0, 10.0], [17.0, 10.0], [24.0, 10.0]])
        d = np.array([4.0, 4.0, 4.0])
        groups = cluster_targets(uv, d, bound_pts=4)
        assert len(groups) == 1


class TestPoly2D:
    def test_fit_exact_polynomial(self, rng):
        x = rng.uniform(0, 50, 80)
        y = rng.uniform(0, 50, 80)
        z = 3.0 + 0.5 * x - 0.2 * y + 0.01 * x * y + 0.003 * x**2
        coeffs = polyfit2d(x, y, z, degree=3)
        z_hat = polyval2d(x, y, coeffs, degree=3)
        np.testing.assert_allclose(z_hat, z, rtol=1e-6, atol=1e-6)


class TestPatchOperator:
    def _frame_with_dots(self, rng, h=64, w=96):
        yy, xx = np.mgrid[0:h, 0:w]
        frame = (
            2000
            + 3.0 * xx
            + 2.0 * yy
            + 0.01 * xx * yy
            + rng.normal(0, 1.0, (h, w))
        ).astype(np.float32)
        dots = np.array([[30.0, 20.0], [70.0, 45.0]])  # (x, y)
        for cx, cy in dots:
            r2 = (xx - cx) ** 2 + (yy - cy) ** 2
            frame[r2 < 9] = 100.0  # dark dots
        return frame, dots

    def test_patch_fills_dots(self, rng):
        frame, dots = self._frame_with_dots(rng)
        clusters = build_patch_clusters(
            dots, np.array([6.0, 6.0]), frame.shape, bound_pts=3, buffer=2
        )
        op = build_patch_operator(clusters, frame.shape)
        out = np.array(apply_patches(jnp.asarray(frame), op))
        yy, xx = np.mgrid[0 : frame.shape[0], 0 : frame.shape[1]]
        for cx, cy in dots:
            sel = ((xx - cx) ** 2 + (yy - cy) ** 2) < 9
            # dark dots replaced with values close to the background surface
            bg = 2000 + 3.0 * xx[sel] + 2.0 * yy[sel] + 0.01 * xx[sel] * yy[sel]
            assert np.abs(out[sel] - bg).max() < 25.0
        # pixels away from the patches untouched
        far = ((xx - dots[0][0]) ** 2 + (yy - dots[0][1]) ** 2 > 400) & (
            (xx - dots[1][0]) ** 2 + (yy - dots[1][1]) ** 2 > 400
        )
        np.testing.assert_allclose(out[far], frame[far], atol=1e-4)

    def test_matches_fit_then_eval_oracle(self, rng):
        """Composed M @ z must equal explicit polyfit2d -> polyval2d."""
        frame, dots = self._frame_with_dots(rng)
        clusters = build_patch_clusters(
            dots, np.array([6.0, 6.0]), frame.shape, bound_pts=3, buffer=2
        )
        op = build_patch_operator(clusters, frame.shape)
        out = np.array(apply_patches(jnp.asarray(frame), op))
        for c in clusters:
            bx, by = c.bounds_xy[:, 0], c.bounds_xy[:, 1]
            z = frame[by, bx]
            coeffs = polyfit2d(bx, by, z, degree=3)
            ix, iy = c.internal_xy[:, 0], c.internal_xy[:, 1]
            expect = polyval2d(ix, iy, coeffs, degree=3)
            np.testing.assert_allclose(out[iy, ix], expect, rtol=1e-3, atol=0.5)

    def test_threshold_bounds_drops_dark(self, rng):
        frame, dots = self._frame_with_dots(rng)
        clusters = build_patch_clusters(
            dots, np.array([6.0, 6.0]), frame.shape, bound_pts=3, buffer=0
        )
        n_before = sum(c.bounds_xy.shape[0] for c in clusters)
        thr = threshold_bounds(clusters, frame, thresh=1500, offset=2)
        n_after = sum(c.bounds_xy.shape[0] for c in thr)
        assert n_after < n_before  # boundary pixels near the dark dots culled
        assert n_after > 0

    def test_small_cluster_skipped(self):
        # a cluster with < 15 boundary points is dropped by the operator
        from upsp_tpu.ops.patching import PatchCluster

        c = PatchCluster(
            bounds_xy=np.array([[1, 1], [2, 1], [3, 1]]),
            internal_xy=np.array([[2, 2]]),
        )
        assert build_patch_operator([c], (16, 16)) is None

    def test_matmul_runs_at_highest_precision(self, rng):
        """The fill matmul asks for full f32 whatever the default, so a
        GPU's TF32 passes never round M or the boundary values."""
        import jax

        frame, dots = self._frame_with_dots(rng)
        clusters = build_patch_clusters(
            dots, np.array([6.0, 6.0]), frame.shape, bound_pts=3, buffer=2
        )
        op = build_patch_operator(clusters, frame.shape)
        hlo = jax.jit(apply_patches).lower(jnp.asarray(frame), op).as_text()
        assert "precision = [HIGHEST, HIGHEST]" in hlo

    def test_fill_gain(self, rng):
        """~3 for a whole boundary ring; a ring cut to one side
        extrapolates, and its gain grows by orders of magnitude."""
        from upsp_tpu.ops.patching import PatchCluster, fill_gain

        frame, dots = self._frame_with_dots(rng)
        (whole,) = build_patch_clusters(
            dots[:1], np.array([6.0]), frame.shape, bound_pts=3, buffer=2
        )
        gain = fill_gain(build_patch_operator([whole], frame.shape))
        assert 1.0 < gain < 10.0
        left = whole.bounds_xy[:, 0] < dots[0][0] - 2
        cut = PatchCluster(bounds_xy=whole.bounds_xy[left],
                           internal_xy=whole.internal_xy)
        assert fill_gain(build_patch_operator([cut], frame.shape)) > 10 * gain
        assert fill_gain(None) == 0.0


class TestSyntheticTargets:
    def test_paint_targets_darkens_inside_the_box(self):
        from upsp_tpu.pipeline.synthetic import paint_targets

        img = np.full((40, 50), 3000.0, np.float32)
        out = paint_targets(img, np.array([[20.3, 15.6]]), 8.0)
        assert out[16, 20] == pytest.approx(300.0)  # the dot's centre
        changed = np.argwhere(out != img)
        # inside the patch box floor/ceil(uv -+ d/2) that phase 0 sizes
        assert changed[:, 1].min() >= 16 and changed[:, 1].max() <= 25
        assert changed[:, 0].min() >= 11 and changed[:, 0].max() <= 20
        assert np.array_equal(img, np.full((40, 50), 3000.0))  # a copy

    def test_datapoint_rings_stay_whole(self, tmp_path):
        """The deck's dots give the threshold a dark mode to find, so every
        cluster keeps its boundary ring and its fill gain stays ~3."""
        from upsp_tpu.ops.patching import fill_gain
        from upsp_tpu.pipeline.config import read_input_deck
        from upsp_tpu.pipeline.phase0 import FILL_GAIN_WARN, run_phase0
        from upsp_tpu.pipeline.run import open_videos
        from upsp_tpu.pipeline.synthetic import write_datapoint

        cfg = read_input_deck(write_datapoint(
            str(tmp_path), 2, (480, 720), (32, 32), n_cameras=2, n_targets=6,
        ))
        readers, _, _ = open_videos(cfg)
        first = [r.read_frame(0) for r in readers]
        for r in readers:
            r.close()
        # the dots are in the video: a dot's centre is a tenth of the paint
        for f in first:
            assert f.min() < 0.2 * np.median(f)
        state = run_phase0(cfg, first, [12, 12])
        for op in state.patch_ops:
            assert op is not None and op.n_clusters == 6
            assert fill_gain(op) < FILL_GAIN_WARN

    def test_phase0_warns_of_a_high_fill_gain(self, tmp_path, monkeypatch,
                                              caplog):
        import logging

        from upsp_tpu.pipeline import phase0
        from upsp_tpu.pipeline.config import read_input_deck
        from upsp_tpu.pipeline.run import open_videos
        from upsp_tpu.pipeline.synthetic import write_datapoint

        cfg = read_input_deck(write_datapoint(
            str(tmp_path), 2, (48, 64), (21, 17), n_cameras=1, n_targets=3,
        ))
        readers, _, _ = open_videos(cfg)
        first = [readers[0].read_frame(0)]
        readers[0].close()
        monkeypatch.setattr(phase0, "FILL_GAIN_WARN", 1.0)
        with caplog.at_level(logging.WARNING, logger="upsp_tpu"):
            phase0.run_phase0(cfg, first, [12])
        assert any("amplifies boundary-pixel error" in r.getMessage()
                   for r in caplog.records)


class TestDetrend:
    def test_matches_numpy_lstsq(self, rng):
        F, N, deg = 400, 32, 6
        det = make_detrender(F, deg)
        f = np.arange(F) / F
        series = np.stack(
            [
                np.polyval(rng.normal(size=deg + 1) * 0.2, f)
                + rng.normal(0, 0.01, F)
                for _ in range(N)
            ]
        ).astype(np.float32)
        ours_fit = np.array(eval_fit(det, fit_coeffs(det, jnp.asarray(series))))
        for i in range(0, N, 7):
            coeffs = polyfit_1d(f, series[i], deg)
            expect = np.polyval(coeffs[::-1], f)
            np.testing.assert_allclose(ours_fit[i], expect, rtol=1e-3, atol=1e-4)

    def test_detrend_removes_polynomial(self, rng):
        F = 256
        det = make_detrender(F, 6)
        f = np.arange(F) / F
        trend = 2.0 + 0.5 * f - 3.0 * f**3
        noise = rng.normal(0, 0.1, F).astype(np.float32)
        series = (trend + noise).astype(np.float32)[None, :]
        resid = np.array(detrend(det, jnp.asarray(series)))[0]
        # residual should be noise-sized, not trend-sized
        assert np.abs(resid).std() < 0.15

    def test_coeffs_roundtrip(self, tmp_path, rng):
        c = rng.normal(size=(7, 12)).astype(np.float32)
        p = str(tmp_path / "fits.dat")
        write_coeffs(p, c)
        back = read_coeffs(p)
        np.testing.assert_array_equal(back, c)
