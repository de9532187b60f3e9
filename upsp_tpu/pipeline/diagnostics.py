"""Phase-0 diagnostic images (per camera), matching the reference's outputs.

Table parity: docs/md/upsp-user-manual.md:827-836 / psp_process.cpp
InitializeCameraCalibration + InitializeImagePatches diagnostics:

  camNN-8bit-raw.png                scaled first frame
  camNN-raw.exr                     float32 first frame
  camNN-8bit-projected-fiducials.png  visible fiducials overlay
  camNN-8bit-fiducial-clusters.png    clusters colored
  camNN-8bit-cluster-boundaries.png   boundary rings overlay
  camNN-nodecount.png               nodes-per-pixel colormap
  camNN-uv                          per-node normalized (u,v) flat file
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from upsp_tpu.ops.image import convert_to_8u

# nodes-per-pixel colormap (BGR like the reference's cv_extras.cpp:277-289):
# 0=black, 1=green, 2=yellow, 3=orange, 4=light orange, >=5 white
_NODECOUNT_COLORS = np.array(
    [
        [0, 0, 0],
        [0, 255, 0],
        [0, 255, 255],
        [51, 153, 255],
        [153, 204, 255],
    ],
    np.uint8,
)


def nodes_per_pixel_image(counts: np.ndarray) -> np.ndarray:
    """uint8 BGR colormap of node counts per pixel."""
    c = np.clip(np.asarray(counts), 0, 255).astype(np.int64)
    out = np.full(c.shape + (3,), 255, np.uint8)
    for v in range(_NODECOUNT_COLORS.shape[0]):
        out[c == v] = _NODECOUNT_COLORS[v]
    return out


def nodes_per_pixel_counts(pixel_index: np.ndarray, visible: np.ndarray,
                           image_hw) -> np.ndarray:
    H, W = image_hw
    counts = np.zeros(H * W, np.int64)
    np.add.at(counts, np.asarray(pixel_index)[np.asarray(visible)], 1)
    return counts.reshape(H, W)


def add_targets_overlay(
    img8: np.ndarray,
    centers: np.ndarray,
    color=(0, 255, 0),
    labels: Optional[Sequence[str]] = None,
    radius: int = 4,
) -> np.ndarray:
    """Draw circles (+ optional labels) over a grayscale/BGR image -> BGR."""
    import cv2

    img8 = np.asarray(img8, np.uint8)
    out = (
        img8.copy()
        if img8.ndim == 3
        else cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
    )
    for i, (x, y) in enumerate(np.atleast_2d(centers)):
        cv2.circle(out, (int(round(x)), int(round(y))), radius, color, 1)
        if labels is not None:
            cv2.putText(
                out, str(labels[i]), (int(x) + 5, int(y) - 5),
                cv2.FONT_HERSHEY_PLAIN, 0.8, color, 1,
            )
    return out


def write_phase0_diagnostics(state, out_dir: str) -> None:
    """Emit the standard per-camera diagnostic set from a Phase0State."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    ref = np.asarray(state.ref_frames)
    for c in range(state.n_cameras):
        prefix = os.path.join(out_dir, f"cam{c + 1:02d}-")
        img8 = convert_to_8u(ref[c])
        cv2.imwrite(prefix + "8bit-raw.png", img8)
        try:
            cv2.imwrite(prefix + "raw.exr", ref[c].astype(np.float32))
        except cv2.error:
            # OpenCV built without OpenEXR: keep the float image as raw f32
            ref[c].astype("<f4").tofile(prefix + "raw.f32")

        proj = state.projections[c]
        counts = nodes_per_pixel_counts(
            np.asarray(proj.pixel_index), np.asarray(proj.visible), state.image_hw
        )
        cv2.imwrite(prefix + "nodecount.png", nodes_per_pixel_image(counts))

        uv = np.stack([np.asarray(proj.u), np.asarray(proj.v)], axis=1)
        uv.astype("<f4").ravel().tofile(prefix + "uv")

        # per-camera coverage: this camera's projection weight per node
        # (the reference sketches these datasets but leaves them commented
        # out; cheap here — one all-ones projection per camera)
        from upsp_tpu.ops.projection import coverage as _coverage

        cam_cov = np.asarray(_coverage([proj], *state.image_hw))
        cam_cov.astype("<f4").tofile(prefix + "coverage")

        diag = (
            state.patch_diags[c]
            if getattr(state, "patch_diags", None) is not None
            else None
        )
        if diag is not None:
            # projected fiducial positions, labeled green (psp_process.cpp:
            # 2113-2116)
            fid_img = add_targets_overlay(
                img8, diag["uv"], color=(0, 255, 0), labels=diag["names"]
            )
            cv2.imwrite(prefix + "8bit-projected-fiducials.png", fid_img)
            # clusters in distinct colors, unlabeled (:2136-2145)
            cl = np.asarray(diag["cluster_of"])
            n_cl = int(cl.max()) + 1 if cl.size else 0
            cimg = cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
            rng_colors = [
                tuple(int(v) for v in col)
                for col in np.random.default_rng(0).integers(
                    64, 255, size=(max(n_cl, 1), 3)
                )
            ]
            for gi in range(n_cl):
                cimg = add_targets_overlay(
                    cimg, diag["uv"][cl == gi], color=rng_colors[gi]
                )
            cv2.imwrite(prefix + "8bit-fiducial-clusters.png", cimg)

        op = state.patch_ops[c]
        if op is not None:
            H, W = state.image_hw
            bimg = cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
            b_idx = np.asarray(op.boundary_idx).ravel()
            i_idx = np.asarray(op.internal_idx).ravel()
            i_idx = i_idx[i_idx < H * W]
            bimg[i_idx // W, i_idx % W] = (0, 255, 255)
            bimg[b_idx // W, b_idx % W] = (255, 0, 0)
            cv2.imwrite(prefix + "8bit-cluster-boundaries.png", bimg)


# -- registration telemetry analysis ------------------------------------------

def write_registration_meta(
    out_dir: str, conv_semantics: str, ecc_iters=None,
    max_iters: int = 50, epsilon: float = 1e-3, device_peak_bytes=None,
) -> None:
    """Record what telemetry column 1 MEANS next to the flat file.

    ``conv_semantics``: ``"iters"`` (while-loop ECC: iteration count) or
    ``"drho"`` (fixed-iteration/fft ECC: the final |drho| of the last GN
    step — the convergence certificate there, since the step count is a
    compile-time constant).  The sidecar makes the flat-file contract
    self-describing so downstream analysis never guesses the mode.
    ``device_peak_bytes``: peak bytes in use on each device by the end of
    phase 1 (one entry per device of the run), for sizing chunks and for
    checking that a sharded run spreads its data.
    """
    import json

    meta = {
        # column 4 is always 0: it keeps the flat file's (F, C, 5) layout
        # that existing readers of the format expect
        "columns": ["rho", conv_semantics, "warp_tx", "warp_ty",
                    "zero"],
        "conv_semantics": conv_semantics,
        "epsilon": epsilon,
        "max_iters": max_iters,
    }
    if ecc_iters is not None:
        meta["ecc_unroll_iters"] = int(ecc_iters)
    if device_peak_bytes is not None:
        meta["device_peak_bytes_in_use"] = [int(b) for b in device_peak_bytes]
    with open(os.path.join(out_dir, "registration.json"), "w") as f:
        json.dump(meta, f, indent=1)


def read_registration_meta(path: str) -> dict:
    """Sidecar for a ``registration`` flat file (default if absent: the
    while-loop "iters" contract, which predates the sidecar)."""
    import json

    mpath = os.path.join(os.path.dirname(path), "registration.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            return json.load(f)
    return {"conv_semantics": "iters", "epsilon": 1e-3, "max_iters": 50}


def read_registration_telemetry(path: str, n_cameras: int) -> np.ndarray:
    """Load the ``registration`` flat file written by run_datapoint
    (registration_telemetry=True) back into (F, C, K)
    [rho, conv, warp_tx, warp_ty, 0].  Column 1 (``conv``) is the
    ECC iteration count in while-loop modes and the final |drho| in
    fixed-iteration (fft) mode; K comes from the sidecar's ``columns`` list
    (4 for files written before the sidecar listed columns) —
    :func:`read_registration_meta`."""
    meta = read_registration_meta(path)
    k = len(meta.get("columns", [])) or 4
    raw = np.fromfile(path, "<f4")
    return raw.reshape(-1, n_cameras, k)


def analyze_registration_telemetry(
    telemetry: np.ndarray,
    max_iters: int = 50,
    epsilon: float = 1e-3,
    conv_semantics: str = "iters",
) -> dict:
    """Per-camera ECC convergence report + tuning recommendations.

    Turns the free per-frame record into the adaptive-parameter policy the
    reference leaves to the operator.  ``conv_semantics`` selects the meaning
    of telemetry column 1 (read it from :func:`read_registration_meta`):

    - ``"iters"`` (while-loop ECC): if the iteration budget saturates, relax
      epsilon (the sequence is noisy and late iterations buy nothing); if
      convergence is immediate, tighten epsilon to bank accuracy headroom.
    - ``"drho"`` (fixed-iteration/fft ECC): column 1 is the final |drho|; a
      frame converged when it is below epsilon.  If the non-converged
      fraction is material, recommend one more unrolled GN step.

    Frames whose correlation drops far below the sequence trend are flagged
    for inspection (lamp flicker, a skipped frame, model strike) in both
    modes.
    """
    if conv_semantics not in ("iters", "drho"):
        raise ValueError(f"conv_semantics must be iters|drho, got {conv_semantics!r}")
    tele = np.asarray(telemetry, np.float64)
    F, C, _ = tele.shape
    cameras = []
    for c in range(C):
        rho = tele[:, c, 0]
        conv = tele[:, c, 1]
        shift = np.hypot(tele[:, c, 2], tele[:, c, 3])
        mu, sd = float(rho.mean()), float(rho.std())
        suspect = np.nonzero(rho < mu - 4.0 * max(sd, 1e-6))[0]
        rec = {
            "rho_min": float(rho.min()),
            "rho_mean": mu,
            "shift_max_px": float(shift.max()),
            "conv_semantics": conv_semantics,
            "suspect_frames": suspect.tolist(),
        }
        if conv_semantics == "iters":
            p95 = float(np.percentile(conv, 95))
            rec_iters = int(np.clip(np.ceil(p95 * 1.25), 5, max_iters))
            if p95 >= max_iters:
                rec_eps = epsilon * 3.0  # budget-bound: stop earlier
            elif float(conv.mean()) <= 2.0:
                rec_eps = epsilon / 3.0  # converges instantly: ask for more
            else:
                rec_eps = epsilon
            rec.update(
                iters_mean=float(conv.mean()),
                iters_p95=p95,
                iters_max=int(conv.max()),
                recommended_max_iters=rec_iters,
                recommended_epsilon=float(rec_eps),
            )
        else:
            unconverged = float((conv >= epsilon).mean())
            rec.update(
                drho_mean=float(conv.mean()),
                drho_p95=float(np.percentile(conv, 95)),
                drho_max=float(conv.max()),
                unconverged_frac=unconverged,
                # GN converges quadratically inside the basin: one more
                # unrolled step when >2% of frames end above epsilon
                recommend_extra_unroll_step=bool(unconverged > 0.02),
            )
        cameras.append(rec)
    return {"n_frames": F, "cameras": cameras}
