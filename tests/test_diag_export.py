"""Diagnostics, p3d export, internal calibration bounds tests."""

import json
import os

import numpy as np
import pytest

from upsp_tpu.camera.internal import (
    AlphaShape,
    incal_from_calibio,
    points_inside_incal,
)
from upsp_tpu.pipeline.diagnostics import (
    nodes_per_pixel_counts,
    nodes_per_pixel_image,
)
from upsp_tpu.processing.p3d_export import p3d_to_gltf, p3d_to_obj
from upsp_tpu.pipeline.synthetic import make_plate_grid


class TestNodecount:
    def test_counts(self):
        pix = np.array([0, 0, 5, 9])
        vis = np.array([True, True, True, False])
        counts = nodes_per_pixel_counts(pix, vis, (2, 5))
        assert counts[0, 0] == 2 and counts[1, 0] == 1 and counts.sum() == 3

    def test_colormap(self):
        img = nodes_per_pixel_image(np.array([[0, 1], [4, 9]]))
        assert tuple(img[0, 0]) == (0, 0, 0)
        assert tuple(img[0, 1]) == (0, 255, 0)
        assert tuple(img[1, 1]) == (255, 255, 255)


class TestExport:
    def test_obj(self, tmp_path):
        g = make_plate_grid(4, 3)
        p = str(tmp_path / "m.obj")
        p3d_to_obj(g, p)
        text = open(p).read()
        assert text.count("v ") == g.size
        assert text.count("f ") == g.num_faces()

    def test_gltf_valid(self, tmp_path):
        g = make_plate_grid(4, 3)
        p = str(tmp_path / "m.gltf")
        p3d_to_gltf(g, p)
        doc = json.load(open(p))
        assert doc["asset"]["version"] == "2.0"
        assert doc["accessors"][0]["count"] == g.size
        assert doc["accessors"][1]["count"] == g.num_faces() * 3


class TestIncal:
    def test_calibio_parse(self, tmp_path):
        params = {
            "f": {"val": 1380.0}, "cx": {"val": 530.0},
            "cy": {"val": 250.0}, "k1": {"val": -0.09},
            "k2": {"val": 0.0}, "p1": {"val": 0.0},
            "p2": {"val": 0.0}, "k3": {"val": 0.0},
        }
        data = {
            "CameraModelCRT": {
                "CameraModelBase": {
                    "imageSize": {"height": 512, "width": 1024}
                }
            },
            "parameters": params,
        }
        doc = {
            "calibration": {
                "cameras": [{"model": {"ptr_wrapper": {"data": data}}}]
            }
        }
        p = tmp_path / "calibio.json"
        p.write_text(json.dumps(doc))
        img_size, cm, dist = incal_from_calibio(str(p))
        assert tuple(img_size) == (512, 1024)
        assert cm[0, 2] == pytest.approx(530.0 - 512.0)  # center-relative
        assert cm[1, 2] == pytest.approx(250.0 - 256.0)
        assert dist[0, 0] == pytest.approx(-0.09)

    def test_alpha_shape_concave(self, rng):
        # L-shaped point cloud: convex hull would wrongly include the notch
        pts = []
        for x in np.linspace(0, 10, 24):
            for y in np.linspace(0, 10, 24):
                if x <= 5 or y <= 5:
                    pts.append((x, y))
        shape = AlphaShape(np.array(pts), alpha=0.5)
        assert shape.contains(np.array([[2.0, 2.0]]))[0]
        assert shape.contains(np.array([[2.0, 8.0]]))[0]
        assert not shape.contains(np.array([[8.0, 8.0]]))[0]  # notch

    def test_points_inside_incal_fallback(self):
        pts = np.array([[5.0, 5.0], [2000.0, 5.0]])
        ok = points_inside_incal(None, pts, (512, 1024))
        assert ok[0] and not ok[1]


class TestPhase0Diagnostics:
    def test_writes_full_set(self, tmp_path):
        pytest.importorskip("cv2")
        import numpy as np

        from upsp_tpu.pipeline.diagnostics import write_phase0_diagnostics
        from upsp_tpu.pipeline.synthetic import make_synthetic_state

        state = make_synthetic_state(
            n_cameras=2, image_hw=(64, 96), grid_shape=(24, 20),
            n_patch_dots=3, registration="none",
        )
        write_phase0_diagnostics(state, str(tmp_path))
        for c in (1, 2):
            assert (tmp_path / f"cam{c:02d}-8bit-raw.png").exists()
            assert (tmp_path / f"cam{c:02d}-nodecount.png").exists()
            uv = np.fromfile(tmp_path / f"cam{c:02d}-uv", "<f4")
            assert uv.size == 2 * state.model.size
            cov = np.fromfile(tmp_path / f"cam{c:02d}-coverage", "<f4")
            assert cov.size == state.model.size
            assert cov.max() > 0  # some nodes covered by this camera
            # float raw image present as exr or f32 fallback
            assert (tmp_path / f"cam{c:02d}-raw.exr").exists() or (
                tmp_path / f"cam{c:02d}-raw.f32"
            ).exists()


class TestRegistrationTelemetryAnalysis:
    def _tele(self, iters, rho=None, F=100):
        t = np.zeros((F, 1, 4), np.float32)
        t[:, 0, 0] = 0.99 if rho is None else rho
        t[:, 0, 1] = iters
        t[:, 0, 2] = 0.3
        t[:, 0, 3] = -0.2
        return t

    def test_budget_bound_relaxes_epsilon(self):
        from upsp_tpu.pipeline.diagnostics import analyze_registration_telemetry

        rep = analyze_registration_telemetry(self._tele(50), max_iters=50)
        cam = rep["cameras"][0]
        assert cam["recommended_epsilon"] == pytest.approx(3e-3)
        assert cam["recommended_max_iters"] == 50

    def test_instant_convergence_tightens(self):
        from upsp_tpu.pipeline.diagnostics import analyze_registration_telemetry

        rep = analyze_registration_telemetry(self._tele(1))
        cam = rep["cameras"][0]
        assert cam["recommended_epsilon"] == pytest.approx(1e-3 / 3)
        assert cam["recommended_max_iters"] == 5

    def test_suspect_frames_flagged(self):
        from upsp_tpu.pipeline.diagnostics import analyze_registration_telemetry

        rho = np.full(100, 0.99)
        rho[[17, 63]] = 0.5  # dropped frames
        rep = analyze_registration_telemetry(self._tele(8, rho=rho))
        assert rep["cameras"][0]["suspect_frames"] == [17, 63]

    def test_roundtrip_file(self, tmp_path):
        from upsp_tpu.pipeline.diagnostics import read_registration_telemetry

        t = self._tele(5, F=12)
        t.astype("<f4").tofile(tmp_path / "registration")
        back = read_registration_telemetry(str(tmp_path / "registration"), 1)
        np.testing.assert_array_equal(back, t)

    def test_drho_semantics(self):
        """fft/unrolled mode: column 1 is the final |drho|, not a count."""
        from upsp_tpu.pipeline.diagnostics import analyze_registration_telemetry

        t = self._tele(0, F=100)
        t[:, 0, 1] = 1e-5
        t[:5, 0, 1] = 5e-3  # 5% of frames end above epsilon
        rep = analyze_registration_telemetry(t, conv_semantics="drho")
        cam = rep["cameras"][0]
        assert cam["conv_semantics"] == "drho"
        assert cam["unconverged_frac"] == pytest.approx(0.05)
        assert cam["recommend_extra_unroll_step"]
        assert "recommended_max_iters" not in cam
        # all-converged: no extra step recommended
        t[:, 0, 1] = 1e-5
        cam = analyze_registration_telemetry(t, conv_semantics="drho")["cameras"][0]
        assert not cam["recommend_extra_unroll_step"]
        assert cam["unconverged_frac"] == 0.0

    def test_meta_sidecar_roundtrip(self, tmp_path):
        from upsp_tpu.pipeline.diagnostics import (
            read_registration_meta,
            write_registration_meta,
        )

        # absent sidecar -> the legacy while-loop contract
        meta = read_registration_meta(str(tmp_path / "registration"))
        assert meta["conv_semantics"] == "iters"
        write_registration_meta(str(tmp_path), "drho", ecc_iters=2)
        meta = read_registration_meta(str(tmp_path / "registration"))
        assert meta["conv_semantics"] == "drho"
        assert meta["ecc_unroll_iters"] == 2
        assert meta["columns"][1] == "drho"
        assert "device_peak_bytes_in_use" not in meta

    def test_meta_sidecar_device_peaks(self, tmp_path):
        from upsp_tpu.pipeline.diagnostics import (
            read_registration_meta,
            write_registration_meta,
        )

        peaks = [3 * 2**30, 2**30, 2**30 + 7, 2**30]
        write_registration_meta(str(tmp_path), "drho",
                                device_peak_bytes=peaks)
        meta = read_registration_meta(str(tmp_path / "registration"))
        assert meta["device_peak_bytes_in_use"] == peaks
