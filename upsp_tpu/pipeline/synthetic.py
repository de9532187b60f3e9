"""Synthetic scenes for benchmarks, the graft entry point, and dry runs.

Two forms of the same flat-plate scene viewed by overhead pinhole cameras:

- :func:`make_synthetic_state` builds a deterministic Phase0State without
  file IO or BVH work, with analytically computed node->pixel projections and
  a handful of patch clusters.  The per-frame compute exercised is exactly
  the production phase-1 program; only the phase-0 *construction* is
  shortcut.
- :func:`write_inputs` / :func:`write_datapoint` write the files a user
  hands ``scripts/upsp-process`` — PLOT3D grid, camera JSONs, WTD, paint
  calibration, fiducial targets, packed 12-bit ``.mraw`` + ``.cih`` video
  and the input deck — so the whole entry point (phase 0 from files
  included) runs on a seeded datapoint of any size.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Tuple

import jax.numpy as jnp
import numpy as np

from upsp_tpu.camera.model import CameraParams, make_camera_params
from upsp_tpu.io.camera_json import read_camera_json
from upsp_tpu.io.plot3d import StructGrid
from upsp_tpu.geometry.grids import from_struct_grid
from upsp_tpu.ops.patching import build_patch_clusters, build_patch_operator
from upsp_tpu.ops.projection import (
    NodeProjection,
    identify_skipped_nodes,
)
from upsp_tpu.pipeline.config import CameraInputs, ProcessingConfig
from upsp_tpu.pipeline.phase0 import Phase0State


def make_plate_grid(imax: int, jmax: int, lx: float = 10.0, ly: float = 8.0):
    xs = np.linspace(0, lx, imax)
    ys = np.linspace(0, ly, jmax)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    g = StructGrid()
    g.sz = [np.array([imax, jmax, 1], np.int32)]
    g.x = gx.ravel().astype(np.float32)
    g.y = gy.ravel().astype(np.float32)
    g.z = np.zeros(imax * jmax, np.float32)
    g.zones = np.zeros(imax * jmax, np.int32)
    return g


def make_synthetic_state(
    n_cameras: int = 1,
    image_hw: Tuple[int, int] = (1024, 1024),
    grid_shape: Tuple[int, int] = (160, 128),
    n_patch_dots: int = 12,
    registration: str = "pixel",
    filter_type: str = "gaussian",
    seed: int = 0,
    overlap: str = "best_view",
) -> Phase0State:
    """Deterministic flagship scene: plate grid + overhead camera(s).

    ``overlap`` mirrors the deck option (reference default BestView,
    upsp_inputs.h: each node sources from exactly ONE camera — the one
    viewing it least obliquely).  "best_view" assigns each node to the
    camera whose projection lands nearest its principal point (the
    synthetic analog of the obliqueness criterion), which is what the
    production phase-1 fast path (one combined gather) keys on;
    "average_view" keeps every camera's weight positive (the reference's
    AverageViews functor), exercising the per-camera gather-and-sum
    path."""
    H, W = image_hw
    imax, jmax = grid_shape
    rng = np.random.default_rng(seed)
    grid = make_plate_grid(imax, jmax)
    model = from_struct_grid(grid, tolerance=0.0)
    n = model.size

    cam_z = 20.0
    margin = 0.86
    fx = min(W, H) * cam_z / 12.0 * margin

    cfg = ProcessingConfig(
        test_id="synthetic-bench",
        cameras=[CameraInputs(number=c + 1) for c in range(n_cameras)],
        registration=registration,
        filter=filter_type,
        filter_size=3,
        target_patcher="polynomial",
    )

    cam_params: List[CameraParams] = []
    projections: List[NodeProjection] = []
    patch_ops = []
    ref_frames = []
    for c in range(n_cameras):
        # cameras slightly offset so multi-camera runs differ per camera
        cx_world = 5.0 + 0.4 * c
        rmat = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
        tvec = np.array([-cx_world, 4.0, cam_z])
        K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
        params = make_camera_params(rmat, tvec, K, np.zeros(5), dtype=jnp.float32)
        cam_params.append(params)

        u = W / 2 + fx * (grid.x - cx_world) / cam_z
        v = H / 2 - fx * (grid.y - 4.0) / cam_z
        visible = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        col = np.clip(np.rint(u), 0, W - 1).astype(np.int32)
        row = np.clip(np.rint(v), 0, H - 1).astype(np.int32)
        projections.append(
            NodeProjection(
                pixel_index=jnp.asarray(np.where(visible, row * W + col, 0)),
                # provisional equal weights; resolved to the overlap policy
                # below once every camera's projection exists
                weight=jnp.asarray(
                    (visible / max(n_cameras, 1)).astype(np.float32)
                ),
                u=jnp.asarray((u / W).astype(np.float32)),
                v=jnp.asarray((v / H).astype(np.float32)),
                visible=jnp.asarray(visible),
            )
        )

        dots = rng.uniform([0.08 * W, 0.08 * H], [0.92 * W, 0.92 * H],
                           size=(n_patch_dots, 2))
        diam = rng.uniform(4.0, 8.0, n_patch_dots)
        clusters = build_patch_clusters(dots, diam, image_hw, 3, 2)
        patch_ops.append(build_patch_operator(clusters, image_hw))

        ref = make_reference_frame(image_hw, seed=seed + c)
        ref_frames.append(ref)

    if overlap == "best_view" and n_cameras > 1:
        # BestView: each node's weight concentrates on the camera seeing it
        # most centrally (stand-in for the reference's obliqueness rule);
        # exactly one positive weight per node — the production fast-path
        # contract (phase1.phase1_params combined gather)
        uu = np.stack([np.asarray(p.u) for p in projections])  # (C, N)
        vv = np.stack([np.asarray(p.v) for p in projections])
        vis = np.stack([np.asarray(p.visible) for p in projections])
        offc = np.hypot(uu - 0.5, vv - 0.5)
        offc[~vis] = np.inf
        best = offc.argmin(axis=0)  # (N,)
        any_vis = vis.any(axis=0)
        for c in range(n_cameras):
            w = ((best == c) & any_vis).astype(np.float32)
            projections[c] = projections[c]._replace(weight=jnp.asarray(w))
    cfg.overlap = overlap
    skipped = identify_skipped_nodes(projections)
    return Phase0State(
        model=model,
        bvh=None,
        bvh_dev=None,
        cam_params=cam_params,
        projections=projections,
        skipped=skipped,
        patch_ops=patch_ops,
        ref_frames=jnp.asarray(np.stack(ref_frames)),
        superseded_by=jnp.asarray(model.superseded_by),
        image_hw=image_hw,
        config=cfg,
    )


def make_reference_frame(
    image_hw: Tuple[int, int], seed: int = 0, peak: float | None = None
) -> np.ndarray:
    """Textured, well-lit 12-bit-ish frame (ECC needs gradients everywhere).

    ``peak``: scale the scene so its brightest pixel is ``peak`` counts.
    Without it, large frames clip at 4095 over a fifth of their area, and
    a saturated plateau whose edge moves with the frame's gain is not a
    translated copy of the template (see :func:`write_datapoint`).
    """
    H, W = image_hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 1800 + 0.9 * xx + 0.7 * yy
    for _ in range(24):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        s = rng.uniform(W / 40, W / 8)
        img += rng.uniform(120, 600) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)
        )
    img += rng.normal(0, 6.0, (H, W))
    if peak is not None:
        img *= peak / img.max()
    return np.clip(img, 0, 4095).astype(np.float32)


def _subpixel_shift(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Bilinear sub-pixel translation with edge replication (host-side)."""
    H, W = img.shape
    ix, fx = int(np.floor(dx)), dx - np.floor(dx)
    iy, fy = int(np.floor(dy)), dy - np.floor(dy)
    pad = max(abs(ix) + 1, abs(iy) + 1)
    p = np.pad(img, pad, mode="edge")
    y0 = pad + iy
    x0 = pad + ix
    a = p[y0 : y0 + H, x0 : x0 + W]
    b = p[y0 : y0 + H, x0 + 1 : x0 + 1 + W]
    c = p[y0 + 1 : y0 + 1 + H, x0 : x0 + W]
    d = p[y0 + 1 : y0 + 1 + H, x0 + 1 : x0 + 1 + W]
    return (
        a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx)
        + d * fy * fx
    ).astype(np.float32)


def make_frame_batch(
    state: Phase0State, n_frames: int, jitter_px: float = 0.6, seed: int = 1
) -> np.ndarray:
    """(F, C, H, W) stack: reference frame with *sub-pixel* shifts + gain wobble.

    True sub-pixel translations (bilinear resample) make the registration work
    honest — integer rolls would let ECC converge in one step.
    """
    H, W = state.image_hw
    rng = np.random.default_rng(seed)
    ref = np.array(state.ref_frames)  # (C, H, W)
    frames = np.empty((n_frames, ref.shape[0], H, W), np.float32)
    for f in range(n_frames):
        for c in range(ref.shape[0]):
            dx, dy = rng.normal(0, jitter_px, 2)
            shifted = _subpixel_shift(ref[c], dx, dy)
            frames[f, c] = shifted * (1.0 + 0.01 * np.sin(2 * np.pi * f / 37))
    return frames


# ---- file-based datapoint (the scripts/upsp-process input set) -------------

PLATE_LX, PLATE_LY = 10.0, 8.0  # make_plate_grid extent
CAMERA_Z = 20.0  # overhead camera height above the plate
# brightest pixel of the video scene, counts: under the 12-bit full scale
# with room for the 1% gain wobble
VIDEO_PEAK = 4000.0
TARGET_DIAMETER = 0.06  # plate units, the targets file's diameter column


def camera_x(c: int) -> float:
    """Plate x under camera ``c``'s optical axis (cameras step 0.4 in x)."""
    return 0.5 * PLATE_LX + 0.4 * c


def plate_focal_px(image_hw: Tuple[int, int], margin: float = 0.95) -> float:
    """Focal length (px) at which the whole plate fills ``margin`` of the
    frame from :data:`CAMERA_Z`."""
    H, W = image_hw
    return margin * CAMERA_Z * min(W / PLATE_LX, H / PLATE_LY)


def write_inputs(
    out_dir: str,
    grid=None,
    grid_shape: Tuple[int, int] = (21, 17),
    n_cameras: int = 1,
    focal_px: float = 200.0,
    n_targets: int = 0,
    seed: int = 0,
) -> Dict:
    """Write the phase-0 input files of a plate datapoint into ``out_dir``.

    PLOT3D plate grid (``grid`` or :func:`make_plate_grid` at
    ``grid_shape``), one camera JSON per camera (overhead at
    :func:`camera_x`, center-relative principal point 0), a WTD file, a
    linear paint calibration and, with ``n_targets > 0``, a targets file of
    seeded sharpie dots inside the plate (polynomial patching input).
    Returns the paths: ``{"grid", "cameras": [...], "wtd", "paint",
    "targets"}`` (``targets`` is "" without targets) and the targets'
    plate coordinates under ``"target_xy"`` ((n_targets, 2)).
    """
    os.makedirs(out_dir, exist_ok=True)
    from upsp_tpu.io.plot3d import write_p3d_grid

    grid_path = os.path.join(out_dir, "plate.grid")
    write_p3d_grid(
        grid_path, grid if grid is not None else make_plate_grid(*grid_shape)
    )
    cam_paths = []
    for c in range(n_cameras):
        path = os.path.join(out_dir, f"cam{c + 1:02d}.json")
        with open(path, "w") as fh:
            json.dump(
                {
                    "uPSP_cameraMatrix": [
                        [focal_px, 0, 0], [0, focal_px, 0], [0, 0, 1]
                    ],
                    "distCoeffs": [[0, 0, 0, 0, 0]],
                    "rmat": [[1, 0, 0], [0, -1, 0], [0, 0, -1]],
                    "tvec": [-camera_x(c), 0.5 * PLATE_LY, CAMERA_Z],
                },
                fh,
            )
        cam_paths.append(path)
    wtd_path = os.path.join(out_dir, "t.wtd")
    with open(wtd_path, "w") as fh:
        fh.write("RUN 1 1\n#\tMACH\tALPHA\tBETA\tPHI\tQ\tPS\tTTF\tSTRUTZ\n")
        fh.write("0.80\t0.00\t0.00\t0.00\t144.00\t500.00\t80.00\t0.00\n")
    paint_path = os.path.join(out_dir, "paint.cal")
    with open(paint_path, "w") as fh:
        fh.write("a = 1.0\nb = 0.0\nc = 0\nd = 0\ne = 0\nf = 0\n")
    tgts_path = ""
    xy = np.zeros((0, 2))
    if n_targets:
        rng = np.random.default_rng(seed)
        xy = rng.uniform(
            [0.1 * PLATE_LX, 0.1 * PLATE_LY], [0.9 * PLATE_LX, 0.9 * PLATE_LY],
            size=(n_targets, 2),
        )
        tgts_path = os.path.join(out_dir, "plate.tgts")
        with open(tgts_path, "w") as fh:
            fh.write("*Targets\n")
            for i, (x, y) in enumerate(xy):
                fh.write(
                    f"{i + 1:4d} {x:10.4f} {y:10.4f} 0.0000 0.0 0.0 1.0 "
                    f"{TARGET_DIAMETER} 1 1 1 st{i + 1:02d}\n"
                )
    return {
        "grid": grid_path, "cameras": cam_paths, "wtd": wtd_path,
        "paint": paint_path, "targets": tgts_path, "target_xy": xy,
    }


def paint_targets(img: np.ndarray, uv: np.ndarray, diameter_px: float,
                  reflectance: float = 0.1) -> np.ndarray:
    """Darken ``img`` inside a dot of ``diameter_px`` at each ``uv`` (x, y
    pixel coordinates): the sharpie dots a targets file describes, at
    ``reflectance`` times the paint, with a one-pixel anti-aliased rim.

    The dot is drawn at 0.9 of the diameter so it stays inside the patch
    box phase 0 sizes from that diameter.
    """
    out = img.copy()
    H, W = img.shape
    r = 0.45 * diameter_px
    reach = int(np.ceil(r + 1))
    for u, v in uv:
        x0, x1 = max(int(u) - reach, 0), min(int(u) + reach + 2, W)
        y0, y1 = max(int(v) - reach, 0), min(int(v) + reach + 2, H)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        cover = np.clip(r + 0.5 - np.hypot(xx - u, yy - v), 0.0, 1.0)
        out[y0:y1, x0:x1] *= 1.0 - (1.0 - reflectance) * cover
    return out


def write_mraw(
    path: str, n_frames: int, frame_fn: Callable[[int], np.ndarray]
) -> None:
    """Write a packed 12-bit Photron ``.mraw`` + ``.cih`` pair, frame by frame.

    ``frame_fn(f)`` returns frame ``f`` as (H, W) counts in [0, 4095];
    frames stream to disk, so the video never sits whole in host memory.
    """
    from upsp_tpu.io.video.util import pack_12bpp

    H = W = None
    with open(path, "wb") as fh:
        for f in range(n_frames):
            img = np.asarray(frame_fn(f))
            H, W = img.shape
            fh.write(pack_12bpp(np.rint(img).reshape(-1)).tobytes())
    cih = os.path.splitext(path)[0] + ".cih"
    with open(cih, "w") as fh:
        fh.write(
            "Record Rate(fps) : 10000\nShutter Speed(s) : 1/20000\n"
            f"Total Frame : {n_frames}\nImage Width : {W}\n"
            f"Image Height : {H}\nColor Bit : 12\nEffectiveBit Depth : 12\n"
            "EffectiveBit Side : Lower\nFile Format : Mraw\n"
        )


def write_datapoint(
    out_dir: str,
    n_frames: int,
    image_hw: Tuple[int, int],
    grid_shape: Tuple[int, int],
    n_cameras: int = 1,
    n_targets: int = 0,
    seed: int = 0,
) -> str:
    """Write a complete seeded datapoint and its input deck; returns the deck.

    Video: per camera, :func:`make_reference_frame` shifted by seeded
    sub-pixel jitter (sigma 0.6 px) with a slow gain wobble (the
    :func:`make_frame_batch` recipe), written as packed 12-bit ``.mraw``.
    The scene peaks at :data:`VIDEO_PEAK` counts, so no frame saturates:
    clipped at 4095, a fifth of a 1200x1800 frame would be a plateau whose
    edge moves ~30 px with a 1% gain change, which ECC reads as motion
    (rho down to 0.84 after two Gauss-Newton steps, warps pixels off).
    Each target is a dark dot in the scene (:func:`paint_targets`): without
    the dots, phase 0's histogram threshold, which looks for the dots' dark
    mode, falls inside the paint's own brightness range and drops most of
    some clusters' boundary rings, leaving patch operators that amplify
    any rounding of their input a thousandfold.
    Registration is pixel (ECC), the filter a 3x3 Gaussian, and patching
    polynomial when ``n_targets > 0``; outputs go to ``<out_dir>/out``.
    """
    paths = write_inputs(
        out_dir, grid_shape=grid_shape, n_cameras=n_cameras,
        focal_px=plate_focal_px(image_hw), n_targets=n_targets, seed=seed,
    )
    rng = np.random.default_rng(seed + 1)
    shifts = rng.normal(0.0, 0.6, size=(n_cameras, n_frames, 2))
    shifts[:, 0] = 0.0  # frame 0 is the registration template
    xyz = np.concatenate(
        [paths["target_xy"], np.zeros((len(paths["target_xy"]), 1))], axis=1
    )
    videos = []
    for c in range(n_cameras):
        ref = make_reference_frame(image_hw, seed=seed + c, peak=VIDEO_PEAK)
        cal = read_camera_json(paths["cameras"][c], dims_hw=image_hw)
        K = cal.camera_matrix
        xc = xyz @ cal.rmat.T + cal.tvec
        uv = xc[:, :2] / xc[:, 2:3] * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]
        ref = paint_targets(ref, uv, TARGET_DIAMETER * K[0, 0] / CAMERA_Z)

        def frame(f, ref=ref, c=c):
            gain = 1.0 + 0.01 * np.sin(2 * np.pi * f / 37)
            return _subpixel_shift(ref, *shifts[c, f]) * gain

        video = os.path.join(out_dir, f"cam{c + 1:02d}.mraw")
        write_mraw(video, n_frames, frame)
        videos.append(video)
    cams = "".join(
        f"@camera\n\tnumber = {c + 1}\n\tcine = {videos[c]}\n"
        f"\tcalibration = {paths['cameras'][c]}\n"
        for c in range(n_cameras)
    )
    targets = f"\ttargets = {paths['targets']}\n" if n_targets else ""
    deck = os.path.join(out_dir, "deck.inp")
    with open(deck, "w") as fh:
        fh.write(
            "@general\n\ttest = synth\n\trun = 1\n\tsequence = 1\n"
            f"@all\n\tsds = {paths['wtd']}\n\tgrid = {paths['grid']}\n"
            f"\tpaint_calibration = {paths['paint']}\n{targets}"
            f"{cams}"
            "@options\n"
            f"\ttarget_patcher = {'polynomial' if n_targets else 'none'}\n"
            "\tregistration = pixel\n\tfilter = gaussian\n"
            f"\tfilter_size = 3\n\tnumber_frames = {n_frames}\n"
            f"@output\n\tdir = {os.path.join(out_dir, 'out')}\n"
        )
    return deck
