"""Mesh-sharded production driver + deck parity tail.

Covers the integration the reference gets from MPI (psp_process.cpp:1520-1529
apportion, :707-771 global transpose — studied, not copied): run_datapoint
over the 8-device virtual mesh must match the single-device oracle, the ECC
warm-start scan must match the stateless solve while converging faster, and
the input-deck tail (start_frame, active_comps) plus the steady_state /
model_temp output files must demonstrably change behavior.
"""

import numpy as np
import pytest

from upsp_tpu.io.plot3d import StructGrid
from upsp_tpu.parallel.mesh import make_mesh
from upsp_tpu.pipeline.config import CameraInputs, ProcessingConfig
from upsp_tpu.pipeline.run import run_datapoint
from upsp_tpu.pipeline.synthetic import make_plate_grid, write_inputs


def _write_inputs(tmp_path, grid=None):
    p = write_inputs(str(tmp_path), grid=grid)
    return p["grid"], p["cameras"][0], p["wtd"], p["paint"]


def _config(tmp_path, out="out", registration="none", grid=None, **kw):
    grid_path, cam_path, wtd_path, paint_path = _write_inputs(tmp_path, grid)
    return ProcessingConfig(
        test_id="synth",
        run=1,
        sequence=1,
        cameras=[CameraInputs(number=1, calibration=cam_path)],
        grid=grid_path,
        sds=wtd_path,
        paint_cal=paint_path,
        registration=registration,
        target_patcher="none",
        out_dir=str(tmp_path / out),
        **kw,
    )


def _frames(F=16, H=64, W=96, shifts=None):
    """Smooth plate images; optional per-frame (dx, dy) subpixel shifts."""
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.empty((F, 1, H, W), np.float32)
    for f in range(F):
        dx, dy = (0.0, 0.0) if shifts is None else shifts[f]
        img = (
            2000
            + 5.0 * (xx - dx)
            + 3.0 * (yy - dy)
            + 300 * np.exp(-(((xx - dx - 40) ** 2 + (yy - dy - 30) ** 2) / 120))
            + 200 * np.exp(-(((xx - dx - 70) ** 2 + (yy - dy - 20) ** 2) / 80))
        )
        frames[f, 0] = img * (1 + 0.01 * np.sin(2 * np.pi * f / 7))
    return frames


class TestMeshDriver:
    def test_matches_single_device(self, tmp_path):
        """run_datapoint over the 8-device mesh == single-device oracle."""
        frames = _frames(16)
        cfg1 = _config(tmp_path, out="out1")
        out1 = run_datapoint(cfg1, frames_array=frames)
        cfg2 = _config(tmp_path, out="out2")
        out2 = run_datapoint(cfg2, frames_array=frames, mesh=make_mesh())
        np.testing.assert_allclose(out2.intensity, out1.intensity, rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(out2.phase2.pressure_transpose),
            np.asarray(out1.phase2.pressure_transpose),
            rtol=2e-5, atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(out2.phase2.rms), np.asarray(out1.phase2.rms),
            rtol=2e-5, atol=1e-7,
        )

    def test_uneven_frames_pad(self, tmp_path):
        """Frame counts that don't divide the 8-device mesh still match."""
        frames = _frames(13)
        out1 = run_datapoint(
            _config(tmp_path, out="o1"), frames_array=frames, write_outputs=False
        )
        out2 = run_datapoint(
            _config(tmp_path, out="o2"), frames_array=frames,
            write_outputs=False, mesh=make_mesh(),
        )
        assert out2.n_frames == 13
        np.testing.assert_allclose(out2.intensity, out1.intensity, rtol=1e-6)

    def test_registration_pixel_mesh(self, tmp_path):
        """ECC registration under shard_map matches the single-device path."""
        rng = np.random.default_rng(0)
        shifts = np.cumsum(rng.normal(0, 0.15, size=(16, 2)), axis=0)
        shifts[0] = 0
        frames = _frames(16, shifts=shifts)
        out1 = run_datapoint(
            _config(tmp_path, out="o1", registration="pixel"),
            frames_array=frames, write_outputs=False, warm_start=False,
        )
        out2 = run_datapoint(
            _config(tmp_path, out="o2", registration="pixel"),
            frames_array=frames, write_outputs=False, warm_start=False,
            mesh=make_mesh(),
        )
        v = np.isfinite(out1.intensity)
        np.testing.assert_allclose(
            out2.intensity[v], out1.intensity[v], rtol=1e-4, atol=0.05
        )


class TestMeshDriverVideo:
    def test_packed_video_four_devices_match_one(self, tmp_path):
        """The seeded packed-video deck over a 4-device mesh == one device.

        The CPU witness for ``chip_smoke.py --four-gpus``: 4 cameras,
        polynomial patching, fft ECC init, two chunks of 16 frames, in core
        and streaming.  Each device runs the one-device per-frame program
        on its frames, so intensities match bitwise; delta-Cp may differ
        only by phase 2's summation order over node blocks.
        """
        import os

        import jax

        from upsp_tpu.io.flatfile import read_flat
        from upsp_tpu.pipeline.config import read_input_deck
        from upsp_tpu.pipeline.run import run_datapoint_streaming
        from upsp_tpu.pipeline.synthetic import write_datapoint

        F = 32
        cfg = read_input_deck(write_datapoint(
            str(tmp_path), F, (120, 180), (48, 48), n_cameras=4, n_targets=8,
        ))
        mesh = make_mesh(jax.devices()[:4])
        one = run_datapoint(cfg, frames_per_chunk=16, write_outputs=False)
        four = run_datapoint(cfg, frames_per_chunk=16, write_outputs=False,
                             mesh=mesh)
        run_datapoint_streaming(cfg, frames_per_chunk=16, mesh=mesh,
                                write_hdf5=False)
        streamed = read_flat(os.path.join(cfg.out_dir, "intensity"))
        assert np.isfinite(one.intensity).mean() > 0.5
        np.testing.assert_array_equal(four.intensity, one.intensity)
        np.testing.assert_array_equal(streamed.reshape(F, -1), one.intensity)
        p1 = np.asarray(one.phase2.pressure_transpose)
        p_streamed = read_flat(os.path.join(cfg.out_dir, "pressure_transpose"))
        # paint gain 1 and qbar 144: delta-Cp is in units of the intensity
        # ratio, whose f32 rounding is ~1e-7
        for p in (np.asarray(four.phase2.pressure_transpose),
                  p_streamed.reshape(p1.shape)):
            np.testing.assert_allclose(p, p1, rtol=0, atol=1e-5)


class TestWarmStart:
    def test_fewer_iterations_same_quality(self, tmp_path):
        """Warm-started ECC: fewer iterations, final correlation not degraded.

        The reference identity-starts every frame with the same
        |drho| < epsilon stopping rule (registration.cpp:53-64), so on a
        drifting scene neither path converges to the exact ground truth —
        the contract of the warm start is iteration count down with the
        achieved ECC objective (final rho) at least as good.
        """
        import jax.numpy as jnp
        from scipy import ndimage

        from upsp_tpu.pipeline.phase0 import run_phase0
        from upsp_tpu.pipeline.phase1 import make_chunk_processor

        rng = np.random.default_rng(7)
        H, W, F = 64, 96, 12
        base = 2000 + 400 * ndimage.gaussian_filter(
            rng.normal(size=(H, W)), 2.5
        ).astype(np.float32)
        shifts = np.cumsum(0.3 + 0.3 * rng.random((F, 2)), axis=0)
        shifts[0] = 0
        frames = np.stack(
            [
                ndimage.shift(base, (dy, dx), order=3, mode="nearest")[None]
                for dx, dy in shifts
            ]
        ).astype(np.float32)
        cfg = _config(tmp_path, registration="pixel")
        state = run_phase0(cfg, [frames[0, 0]], [12])

        cold = make_chunk_processor(state, warm_start=False, with_telemetry=True)
        warm = make_chunk_processor(state, warm_start=True, with_telemetry=True)
        batch = jnp.asarray(frames)
        _, t_cold = cold(batch)
        _, t_warm = warm(batch)
        t_cold, t_warm = np.asarray(t_cold), np.asarray(t_warm)
        iters_cold = float(t_cold[1:, :, 1].mean())
        iters_warm = float(t_warm[1:, :, 1].mean())
        assert iters_warm < iters_cold, (iters_warm, iters_cold)
        # achieved correlation after the warm-started solve is not worse
        assert t_warm[:, :, 0].min() >= t_cold[:, :, 0].min() - 1e-3

    def test_warm_start_driver_telemetry(self, tmp_path):
        """Driver writes the registration flat file; warm path converges."""
        rng = np.random.default_rng(2)
        shifts = np.cumsum(rng.normal(0, 0.15, size=(16, 2)), axis=0)
        shifts[0] = 0
        frames = _frames(16, shifts=shifts)
        cfg = _config(tmp_path, registration="pixel")
        out = run_datapoint(
            cfg, frames_array=frames, registration_telemetry=True
        )
        reg = np.fromfile(
            str(tmp_path / "out" / "registration"), "<f4"
        ).reshape(16, 1, 5)
        assert (reg[:, :, 0] > 0.9).all()  # rho: converged correlation
        assert out.phase2 is not None


class TestStartFrame:
    def test_start_frame_window(self, tmp_path):
        """start_frame K: processing starts at 1-based frame K."""
        frames = _frames(12)
        full = run_datapoint(
            _config(tmp_path, out="of"), frames_array=frames, write_outputs=False
        )
        part = run_datapoint(
            _config(tmp_path, out="op", start_frame=5),
            frames_array=frames, write_outputs=False,
        )
        assert part.n_frames == 8
        np.testing.assert_allclose(part.intensity, full.intensity[4:], rtol=1e-6)

    def test_start_frame_plus_count(self, tmp_path):
        frames = _frames(12)
        out = run_datapoint(
            _config(tmp_path, start_frame=3, frames=4),
            frames_array=frames, write_outputs=False,
        )
        assert out.n_frames == 4

    def test_start_frame_past_end_errors(self, tmp_path):
        frames = _frames(4)
        with pytest.raises(ValueError):
            run_datapoint(
                _config(tmp_path, start_frame=99),
                frames_array=frames, write_outputs=False,
            )


def _two_zone_grid():
    """Two plates side by side, both inside the camera frustum
    (x in [5, 10], y in [0, 4] for the test calibration) -> components {0, 1}."""
    a = make_plate_grid(9, 7, lx=2.2, ly=3.5)
    b = make_plate_grid(9, 7, lx=2.2, ly=3.5)
    g = StructGrid()
    g.sz = [a.sz[0], b.sz[0]]
    g.x = np.concatenate([a.x + 5.5, b.x + 8.0]).astype(np.float32)
    g.y = np.concatenate([a.y, b.y]).astype(np.float32)
    g.z = np.concatenate([a.z, b.z]).astype(np.float32)
    g.zones = np.concatenate(
        [np.zeros(a.size, np.int32), np.ones(b.size, np.int32)]
    )
    return g


class TestActiveComps:
    def test_csv_parse(self, tmp_path):
        from upsp_tpu.io.comps import read_active_comp_file

        p = str(tmp_path / "comps.csv")
        with open(p, "w") as fh:
            fh.write("component,active\n0,1\n1,0\n")
        comps = read_active_comp_file(p)
        assert comps == {0: True, 1: False}

    def test_csv_bad_row_errors(self, tmp_path):
        from upsp_tpu.io.comps import read_active_comp_file

        p = str(tmp_path / "comps.csv")
        with open(p, "w") as fh:
            fh.write("component,active\nnope\n")
        with pytest.raises(ValueError):
            read_active_comp_file(p)

    def test_too_many_comps_errors(self, tmp_path):
        from upsp_tpu.io.comps import apply_active_comps
        from upsp_tpu.geometry.grids import from_struct_grid

        model = from_struct_grid(make_plate_grid(5, 5))
        p = str(tmp_path / "comps.csv")
        with open(p, "w") as fh:
            fh.write("component,active\n0,1\n1,0\n2,1\n")
        with pytest.raises(ValueError):
            apply_active_comps(model, p)

    def test_inactive_component_masked_e2e(self, tmp_path):
        """Nodes of an inactive component come out NaN end to end."""
        grid = _two_zone_grid()
        comps_csv = str(tmp_path / "comps.csv")
        with open(comps_csv, "w") as fh:
            fh.write("component,active\n0,1\n1,0\n")
        frames = _frames(8, H=64, W=96)

        base = run_datapoint(
            _config(tmp_path, out="ob", grid=grid),
            frames_array=frames, write_outputs=False,
        )
        masked = run_datapoint(
            _config(tmp_path, out="om", grid=grid, active_comps=comps_csv),
            frames_array=frames, write_outputs=False,
        )
        comp = np.asarray(base.state.model.components)
        vis = np.isfinite(base.intensity[0])
        # zone-1 nodes that were visible must become NaN when inactive
        hit = vis & (comp == 1)
        assert hit.any()
        assert np.isnan(masked.intensity[0][hit]).all()
        # zone-0 intensities unchanged
        keep = vis & (comp == 0)
        np.testing.assert_allclose(
            masked.intensity[0][keep], base.intensity[0][keep], rtol=1e-6
        )


class TestSteadyModelTempOutputs:
    def test_all_fifteen_files(self, tmp_path):
        """The full 15-file flat set (incl steady_state / model_temp) exists."""
        from upsp_tpu.io.flatfile import FLAT_FILES

        frames = _frames(12)
        cfg = _config(tmp_path)
        run_datapoint(cfg, frames_array=frames)
        missing = [
            n for n in FLAT_FILES
            if not (tmp_path / "out" / n).exists()
        ]
        assert not missing, f"missing flat files: {missing}"

    def test_steady_nan_rule(self, tmp_path):
        """Steady Cp values > 3.0 write as NaN (psp_process.cpp:2567-2572)."""
        from upsp_tpu.pipeline.run import _steady_for_output

        s = np.array([0.5, 3.0, 3.01, 100.0], np.float32)
        out = _steady_for_output(s)
        assert out[0] == np.float32(0.5) and out[1] == np.float32(3.0)
        assert np.isnan(out[2:]).all()

    def test_model_temp_flat_value(self, tmp_path):
        """model_temp file carries the recovery temperature for every node."""
        from upsp_tpu.io.flatfile import read_flat

        frames = _frames(8)
        cfg = _config(tmp_path)
        out = run_datapoint(cfg, frames_array=frames)
        mt = read_flat(str(tmp_path / "out" / "model_temp"))
        assert mt.shape[0] == out.state.model.size
        assert np.isfinite(mt).all() and (mt > 0).all()
        np.testing.assert_allclose(mt, np.asarray(out.phase2.model_temp))


class Test2DMesh:
    def test_hosts_by_devices_mesh_matches_oracle(self, tmp_path):
        """run_datapoint over a 2-D (hosts, frames) mesh == single device.

        Validates that both phases block-decompose over the COMBINED axes
        (hosts-major) and the phase-2 all-to-all reshard works on a 2-D
        mesh — the multi-host layout with host-contiguous frame ranges.
        """
        import jax

        frames = _frames(16, shifts=np.cumsum(
            np.random.default_rng(3).normal(0, 0.1, size=(16, 2)), axis=0))
        out1 = run_datapoint(
            _config(tmp_path, out="o1", registration="pixel"),
            frames_array=frames, write_outputs=False,
        )
        mesh2d = make_mesh(jax.devices()[:8], n_hosts=2)
        assert mesh2d.devices.shape == (2, 4)
        out2 = run_datapoint(
            _config(tmp_path, out="o2", registration="pixel"),
            frames_array=frames, write_outputs=False, mesh=mesh2d,
        )
        np.testing.assert_allclose(out2.intensity, out1.intensity, rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(
            np.asarray(out2.phase2.pressure_transpose),
            np.asarray(out1.phase2.pressure_transpose),
            rtol=2e-5, atol=1e-6,
        )


class TestUnstructuredGrid:
    def test_component_assignment_vectorized(self):
        """First-triangle-wins per-node component matches the loop oracle."""
        from upsp_tpu.geometry.grids import from_tri_mesh
        from upsp_tpu.io.cart3d import TriMesh

        rng = np.random.default_rng(11)
        n, t = 40, 120
        verts = rng.normal(size=(n, 3)).astype(np.float32)
        tris = rng.integers(0, n, size=(t, 3)).astype(np.int32)
        comps = rng.integers(1, 5, size=t).astype(np.int32)
        model = from_tri_mesh(TriMesh(vertices=verts, triangles=tris,
                                      components=comps))
        oracle = np.zeros(n, np.int32)
        seen = np.zeros(n, bool)
        for ti in range(t):
            for k in range(3):
                v = tris[ti, k]
                if not seen[v]:
                    oracle[v] = comps[ti]
                    seen[v] = True
        np.testing.assert_array_equal(model.components, oracle)

    def _tri_plate(self):
        """Triangulated two-component plate inside the camera frustum."""
        from upsp_tpu.io.cart3d import TriMesh

        grid = make_plate_grid(17, 13, lx=4.5, ly=3.8)
        verts = np.stack([grid.x + 5.2, grid.y, grid.z], axis=1).astype(
            np.float32
        )
        tris = grid.triangles()
        centers = verts[tris].mean(axis=1)
        comps = np.where(centers[:, 0] > 7.5, 2, 1).astype(np.int32)
        return TriMesh(vertices=verts, triangles=tris, components=comps)

    def test_triq_datapoint_e2e(self, tmp_path):
        """Full run_datapoint on an unstructured .triq grid, mesh-sharded."""
        from upsp_tpu.io.cart3d import write_triq
        from upsp_tpu.io.flatfile import read_flat

        mesh_tri = self._tri_plate()
        tri_path = str(tmp_path / "model.triq")
        write_triq(tri_path, mesh_tri)

        _, cam_path, wtd_path, paint_path = _write_inputs(tmp_path)
        from upsp_tpu.pipeline.config import CameraInputs, ProcessingConfig

        cfg = ProcessingConfig(
            test_id="tri", run=1, sequence=1,
            cameras=[CameraInputs(number=1, calibration=cam_path)],
            grid=tri_path, sds=wtd_path, paint_cal=paint_path,
            registration="none", target_patcher="none",
            out_dir=str(tmp_path / "out"),
        )
        frames = _frames(10)
        out = run_datapoint(cfg, frames_array=frames, mesh=make_mesh())
        assert out.state.model.size == mesh_tri.size
        assert set(np.unique(out.state.model.components)) == {1, 2}
        vis = np.array(out.state.projections[0].visible)
        assert vis.sum() > 50
        dcp = np.asarray(out.phase2.pressure_transpose)
        assert np.isfinite(dcp[vis]).all()
        assert (tmp_path / "out" / "pressure_transpose").exists()
        # X flat file carries the tri vertices
        np.testing.assert_allclose(
            read_flat(str(tmp_path / "out" / "X")), mesh_tri.vertices[:, 0]
        )

    def test_triq_active_comps(self, tmp_path):
        """active_comps masks tri-grid components end to end."""
        from upsp_tpu.io.cart3d import write_triq

        mesh_tri = self._tri_plate()
        tri_path = str(tmp_path / "model.triq")
        write_triq(tri_path, mesh_tri)
        comps_csv = str(tmp_path / "comps.csv")
        with open(comps_csv, "w") as fh:
            fh.write("component,active\n1,1\n2,0\n")
        _, cam_path, wtd_path, paint_path = _write_inputs(tmp_path)
        from upsp_tpu.pipeline.config import CameraInputs, ProcessingConfig

        cfg = ProcessingConfig(
            test_id="tri", run=1, sequence=1,
            cameras=[CameraInputs(number=1, calibration=cam_path)],
            grid=tri_path, sds=wtd_path, paint_cal=paint_path,
            registration="none", target_patcher="none",
            active_comps=comps_csv,
        )
        frames = _frames(6)
        out = run_datapoint(cfg, frames_array=frames, write_outputs=False)
        comp2 = np.asarray(out.state.model.components) == 2
        assert comp2.any()
        assert np.isnan(out.intensity[0][comp2]).all()


class TestCameraSettings:
    def test_from_reader_properties(self):
        from upsp_tpu.pipeline.run import _camera_settings

        class FakeReader:
            frame_rate = 10000
            aperture = 2.8
            exposure_us = 34.5

        class FakeParams:
            fx = 900.0

        class FakeState:
            cam_params = [FakeParams()]

        class FakeCam:
            number = 7

        class FakeCfg:
            cameras = [FakeCam()]

        cs = _camera_settings([FakeReader()], FakeCfg(), FakeState())
        assert cs["framerate"] == 10000
        assert cs["fstop"] == pytest.approx(2.8)
        assert cs["exposure"] == pytest.approx(34.5)
        assert cs["focal_lengths"] == [900.0]
        assert cs["cam_nums"] == [7]

    def test_mraw_reader_exposes_settings(self, ref_data):
        """The fixture .mraw/.cih reader surfaces the recording settings."""
        import glob

        from upsp_tpu.io.video import video_reader

        # the mraw fixture lives under cpp/test/mraw, not test/data
        # (same path tests/test_video.py uses) — search both, fail loudly
        # if neither exists so this can't silently skip again
        roots = [ref_data, ref_data.parent.parent / "cpp" / "test" / "mraw"]
        mraws = sorted(
            m
            for root in roots
            for m in glob.glob(str(root / "**/*.mraw"), recursive=True)
        )
        assert mraws, f"no .mraw fixture found under {roots}"
        r = video_reader(mraws[0])
        r.open()
        try:
            assert getattr(r, "frame_rate", 0) > 0
        finally:
            r.close()
