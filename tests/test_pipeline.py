"""End-to-end pipeline test: synthetic flat plate, 1 camera, full phase 0/1/2."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from upsp_tpu.io.paint import PaintCalibration
from upsp_tpu.io.plot3d import StructGrid, write_p3d_grid
from upsp_tpu.io.wtd import TunnelConditions
from upsp_tpu.pipeline.config import CameraInputs, ProcessingConfig
from upsp_tpu.pipeline.phase0 import run_phase0
from upsp_tpu.pipeline.phase1 import make_frame_processor, phase1_statistics, process_frames
from upsp_tpu.pipeline.phase2 import run_phase2
from upsp_tpu.ops.projection import coverage as proj_coverage

H, W = 96, 128
FX = 200.0
CAM_Z = 20.0


def make_plate_grid():
    """Flat plate z=0, x in [0,10] (21 nodes), y in [0,8] (17 nodes)."""
    imax, jmax = 21, 17
    xs = np.linspace(0, 10, imax)
    ys = np.linspace(0, 8, jmax)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")  # j slow, i fast
    g = StructGrid()
    g.sz = [np.array([imax, jmax, 1], np.int32)]
    g.x = gx.ravel().astype(np.float32)
    g.y = gy.ravel().astype(np.float32)
    g.z = np.zeros(imax * jmax, np.float32)
    g.zones = np.zeros(imax * jmax, np.int32)
    return g


def camera_json_dict():
    """Camera at (5,4,20) looking straight down at the plate."""
    return {
        "uPSP_cameraMatrix": [[FX, 0.0, 0.0], [0.0, FX, 0.0], [0.0, 0.0, 1.0]],
        "distCoeffs": [[0.0, 0.0, 0.0, 0.0, 0.0]],
        "rmat": [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
        "tvec": [-5.0, 4.0, 20.0],
    }


def node_pixels(grid):
    """Ground-truth pixel coords of each node under the synthetic camera."""
    x, y = grid.x, grid.y
    u = W / 2 + FX * (x - 5.0) / CAM_Z
    v = H / 2 - FX * (y - 4.0) / CAM_Z
    return u, v


def render_frame(base, scale):
    return (base * scale).astype(np.float32)


def base_image():
    """Smooth, well-lit intensity field (no zeros: ECC needs gradients)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 2000 + 6.0 * xx + 4.0 * yy + 400 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    return img.astype(np.float32)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scene")
    grid = make_plate_grid()
    grid_path = str(tmp / "plate.grid")
    write_p3d_grid(grid_path, grid)

    cam_path = str(tmp / "cam01.json")
    with open(cam_path, "w") as f:
        json.dump(camera_json_dict(), f)

    # two dot targets on the plate
    tgts_path = str(tmp / "plate.tgts")
    with open(tgts_path, "w") as f:
        f.write("*Targets\n")
        f.write(
            "   1    3.0000   2.0000    0.0000   0.0  0.0  1.0   0.30   1  1  1 st01\n"
        )
        f.write(
            "   2    7.0000   5.0000    0.0000   0.0  0.0  1.0   0.30   1  1  1 st02\n"
        )

    cfg = ProcessingConfig(
        test_id="synthetic",
        cameras=[CameraInputs(number=1, calibration=cam_path, targets=tgts_path)],
        grid=grid_path,
        oblique_angle=70.0,
        registration="none",
        filter="gaussian",
        filter_size=3,
        grid_tol=0.0,
    )
    base = base_image()
    state = run_phase0(cfg, [base])
    return {"cfg": cfg, "grid": grid, "state": state, "base": base}


class TestPhase0:
    def test_most_nodes_projected(self, scene):
        state = scene["state"]
        vis = np.array(state.projections[0].visible)
        assert vis.mean() > 0.9  # flat plate fully visible from above

    def test_pixel_assignment_correct(self, scene):
        state, grid = scene["state"], scene["grid"]
        u, v = node_pixels(grid)
        vis = np.array(state.projections[0].visible)
        pix = np.array(state.projections[0].pixel_index)
        rows = pix[vis] // W
        cols = pix[vis] % W
        np.testing.assert_allclose(cols, np.rint(u[vis]), atol=1.0)
        np.testing.assert_allclose(rows, np.rint(v[vis]), atol=1.0)

    def test_single_camera_weights_one(self, scene):
        state = scene["state"]
        w = np.array(state.projections[0].weight)
        vis = np.array(state.projections[0].visible)
        np.testing.assert_allclose(w[vis], 1.0)
        np.testing.assert_allclose(w[~vis], 0.0)

    def test_patcher_built(self, scene):
        assert scene["state"].patch_ops[0] is not None
        assert scene["state"].patch_ops[0].n_clusters >= 1


class TestPhase1:
    def test_projection_matches_image(self, scene):
        """With registration off, node intensity == blurred image at its pixel."""
        state, base = scene["state"], scene["base"]
        fn = make_frame_processor(state)
        sol = np.array(fn(jnp.asarray(base[None])))
        from upsp_tpu.ops.image import gaussian_blur
        from upsp_tpu.ops.patching import apply_patches

        img = np.array(
            gaussian_blur(apply_patches(jnp.asarray(base), state.patch_ops[0]), 3)
        )
        vis = np.array(state.projections[0].visible)
        pix = np.array(state.projections[0].pixel_index)
        np.testing.assert_allclose(sol[vis], img.ravel()[pix[vis]], rtol=1e-5)
        assert np.isnan(sol[~vis]).all()

    def test_process_frames_batch(self, scene):
        state, base = scene["state"], scene["base"]
        frames = jnp.asarray(
            np.stack([base[None] * s for s in (1.0, 1.01, 0.99)])
        )  # (3, 1, H, W)
        out = np.array(process_frames(state, frames))
        assert out.shape == (3, state.n_nodes)
        vis = np.array(state.projections[0].visible)
        np.testing.assert_allclose(out[1][vis], out[0][vis] * 1.01, rtol=1e-5)

    def test_registration_recovers_shift(self, scene):
        """A translated frame must project like the untranslated one."""
        import dataclasses as dc

        cfg = dc.replace(scene["cfg"], registration="pixel")
        state = dc.replace(scene["state"], config=cfg)
        base = scene["base"]
        shifted = np.roll(base, (2, 3), axis=(0, 1)).astype(np.float32)
        fn = make_frame_processor(state)
        sol_ref = np.array(fn(jnp.asarray(base[None])))
        sol_shift = np.array(fn(jnp.asarray(shifted[None])))
        vis = np.array(state.projections[0].visible)
        # interior nodes (away from the rolled-over border)
        u, v = node_pixels(scene["grid"])
        interior = vis & (u > 8) & (u < W - 8) & (v > 8) & (v < H - 8)
        err = np.abs(sol_shift[interior] - sol_ref[interior])
        err_unregistered = np.abs(
            np.array(fn(jnp.asarray(base[None]))) * 0
            + np.array(
                make_frame_processor(
                    dc.replace(state, config=dc.replace(cfg, registration="none"))
                )(jnp.asarray(shifted[None]))
            )
            - sol_ref
        )[interior]
        assert np.median(err) < 0.2 * np.median(err_unregistered)


class TestPhase2:
    def test_recovers_sinusoid_amplitude(self, scene):
        state, base = scene["state"], scene["base"]
        F = 64
        amp = 0.02
        s = amp * np.sin(2 * np.pi * 8 * np.arange(F) / F)  # 8 cycles
        frames = jnp.asarray(
            np.stack([base[None] * (1.0 + s[f]) for f in range(F)])
        )
        intensity = process_frames(state, frames)  # (F, N)
        avg, _ = phase1_statistics(intensity)
        cov = proj_coverage(state.projections, *state.image_hw)
        cond = TunnelConditions(mach=0.8, qbar=144.0, ps=500.0, ttot=80.0)
        pcal = PaintCalibration(a=1.0)  # gain == 1 psi
        out = run_phase2(
            scene["cfg"],
            jnp.asarray(np.array(intensity).T),  # (N, F)
            avg,
            cov,
            cond,
            pcal,
        )
        dcp = np.array(out.pressure_transpose)
        vis = np.array(state.projections[0].visible)
        node = np.nonzero(vis)[0][len(vis) // 3]
        series = dcp[node]
        # ratio = 1/(1+s) - detrended ~ -s; gain=1, qbar=144 -> dCp ~ -s
        expect_amp = amp
        got_amp = np.sqrt(2) * series.std()
        assert got_amp == pytest.approx(expect_amp, rel=0.15)
        # rms/avg sane
        assert np.isfinite(np.array(out.rms)[vis]).all()
        assert np.isnan(np.array(out.rms)[~vis]).all()

    def test_gain_formula_applied(self, scene):
        state, base = scene["state"], scene["base"]
        F = 16
        frames = jnp.asarray(np.stack([base[None]] * F))
        intensity = process_frames(state, frames)
        avg, _ = phase1_statistics(intensity)
        cov = proj_coverage(state.projections, *state.image_hw)
        cond = TunnelConditions(mach=0.8, qbar=100.0, ps=500.0, ttot=80.0, tcavg=75.0)
        pcal = PaintCalibration(a=0.5, b=0.01, d=0.001)
        out = run_phase2(
            scene["cfg"], jnp.asarray(np.array(intensity).T), avg, cov, cond, pcal
        )
        vis = np.array(state.projections[0].visible)
        gain = np.array(out.gain)
        # steady=0 (no file) -> Pss = ps; T = tcavg
        expect = 0.5 + 0.01 * 75.0 + 0.001 * 500.0
        np.testing.assert_allclose(gain[vis], expect, rtol=1e-5)


class TestStatisticsAccumulation:
    def test_f32_tree_reduction_bound_50k_frames(self):
        """Measured bound for the x64-off (f32) path of phase1_statistics:
        XLA's tree-shaped f32 reduction stays within 5e-7 relative of the
        f64 oracle at the reference's 50k-frame campaign scale
        (psp_process.cpp:1722-1730 uses f64 partials for the same reason).
        """
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(0)
        F, N = 50000, 64
        x = (2000 + 300 * rng.standard_normal((F, N))).astype(np.float32)

        # force the f32 path regardless of the test-suite x64 default
        avg32 = np.asarray(
            jax.jit(lambda a: jnp.mean(a, axis=0))(jnp.asarray(x))
        )
        rms32 = np.asarray(
            jax.jit(lambda a: jnp.sqrt(jnp.mean(a * a, axis=0)))(
                jnp.asarray(x)
            )
        )
        avg64 = x.astype(np.float64).mean(axis=0)
        rms64 = np.sqrt((x.astype(np.float64) ** 2).mean(axis=0))
        scale = np.abs(avg64).max()
        assert np.abs(avg32 - avg64).max() / scale < 5e-7
        assert np.abs(rms32 - rms64).max() / scale < 5e-7
