"""Phase 0: one-time setup — model, BVH, camera cals, projections, patches.

The reference replicates this identically on every MPI rank
(docs/md/upsp-swdd.md:325-327); here it runs once per host and the resulting
state is a pytree of device arrays consumed by the fused phase-1 program.

Behavior parity (studied, not copied): psp_process.cpp phase0 (:2200),
InitializeModel (:2185), InitializeCameraCalibration (:2046),
InitializeImagePatches (:2088), getTargets (:56), get_target_diameters (:117).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from upsp_tpu.camera.model import CameraParams, cam_center, make_camera_params, project_points
from upsp_tpu.geometry.bvh import FlatBVH
from upsp_tpu.native import build_bvh  # native when built, numpy fallback
from upsp_tpu.geometry.grids import SurfaceModel, load_model
from upsp_tpu.io.camera_json import read_camera_json
from upsp_tpu.io.tgts import Target, read_tgts, targets_as_arrays
from upsp_tpu.ops.image import patch_threshold_from_frame
from upsp_tpu.ops.patching import (
    PatchOperator,
    build_patch_clusters,
    build_patch_operator,
    fill_gain,
    threshold_bounds,
)
from upsp_tpu.ops.projection import (
    NodeProjection,
    adjust_projection_for_weights,
    build_node_projection,
    build_node_projection_host,
    identify_skipped_nodes,
)
from upsp_tpu.ops.raycast import BVHArrays, bvh_intersect, bvh_to_device
from upsp_tpu.pipeline.config import ProcessingConfig

# patch-operator fill gain (ops/patching.fill_gain) above which phase 0
# warns: the fill then magnifies camera noise and rounding tenfold or more
FILL_GAIN_WARN = 10.0


@dataclasses.dataclass
class Phase0State:
    """Everything phase 1 needs, ready to ship to devices."""

    model: SurfaceModel
    bvh: FlatBVH
    bvh_dev: BVHArrays
    cam_params: List[CameraParams]
    projections: List[NodeProjection]  # weight-adjusted
    skipped: jax.Array  # (N,) bool
    patch_ops: List[Optional[PatchOperator]]
    ref_frames: jax.Array  # (C, H, W) float32 first frames (ECC templates)
    superseded_by: jax.Array  # (N,) int32 overlap-adjustment gather
    image_hw: Tuple[int, int]
    config: ProcessingConfig
    # per-camera fiducial diagnostics: {"uv": (M,2), "cluster_of": (M,),
    # "names": [str]} or None — feeds the projected-fiducials / clusters
    # overlay images (psp_process.cpp:2113-2145)
    patch_diags: Optional[List[Optional[dict]]] = None

    @property
    def n_nodes(self) -> int:
        return self.model.size

    @property
    def n_cameras(self) -> int:
        return len(self.cam_params)

    def to_device(self, device) -> "Phase0State":
        """Copy whose phase-1 arrays live on ``device`` (e.g. the CPU
        backend, to run the same program there as a reference).  The
        device BVH is dropped; phase 1 does not use it."""

        def put(tree):
            return jax.tree.map(
                lambda a: jax.device_put(a, device)
                if isinstance(a, jax.Array) else a,
                tree,
            )

        return dataclasses.replace(
            self,
            projections=[put(p) for p in self.projections],
            skipped=put(self.skipped),
            patch_ops=[put(op) for op in self.patch_ops],
            ref_frames=put(self.ref_frames),
            superseded_by=put(self.superseded_by),
            bvh_dev=None,
        )


def visible_targets(
    targets: Sequence[Target],
    params: CameraParams,
    bvh_dev: BVHArrays,
    model: SurfaceModel,
    oblique_angle_deg: float,
    image_hw: Tuple[int, int],
    max_leaf: int = 4,
    flat_bvh: Optional[FlatBVH] = None,
) -> List[Target]:
    """getTargets parity: in-frame, unoccluded, facing within the oblique limit.

    The surface normal used for the angle test is the *nearest model node's*
    normal at the ray hit point (psp_process.cpp:92-106).
    """
    if not targets:
        return []
    H, W = image_hw
    xyz, _, _ = targets_as_arrays(targets)
    uv = np.array(project_points(params, jnp.asarray(xyz)))
    in_frame = (
        (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    )
    center = np.array(cam_center(params))
    d = xyz - center
    dist = np.linalg.norm(d, axis=1)
    dirs = d / dist[:, None]
    from upsp_tpu import native as _native

    if flat_bvh is not None and _native.available():
        t, prim, hit = _native.bvh_intersect(
            flat_bvh,
            np.broadcast_to(center, xyz.shape).astype(np.float32),
            dirs.astype(np.float32),
        )
    else:
        t, prim, hit = bvh_intersect(
            bvh_dev,
            jnp.asarray(np.broadcast_to(center, xyz.shape), jnp.float32),
            jnp.asarray(dirs, jnp.float32),
            max_leaf=max_leaf,
        )
        t = np.array(t)
        hit = np.array(hit)
    occluded = hit & (t < dist - 1e-3)
    # normal at hit point: nearest node to the hit position (misses keep the
    # target's own position so the kd query stays in range; they're culled by
    # the `hit` mask anyway)
    hit_pos = np.where(hit[:, None], center + np.array(dirs) * t[:, None], xyz)
    nearest = model.nearest_node(hit_pos)
    normals = model.normals[nearest]
    cos_theta = np.sum(normals * dirs, axis=1)
    ang = np.arccos(np.clip(cos_theta, -1, 1))
    thresh = np.deg2rad(180.0 - oblique_angle_deg)
    forward = ang > thresh
    keep = in_frame & hit & (~occluded) & forward
    out = []
    for i, tg in enumerate(targets):
        if keep[i]:
            tg2 = dataclasses.replace(tg)
            tg2.uv = uv[i]
            out.append(tg2)
    return out


def target_image_diameters(
    targets: Sequence[Target],
    params: CameraParams,
    model: SurfaceModel,
    image_hw: Tuple[int, int],
) -> np.ndarray:
    """Projected diameter (pixels) via a 4-point circle in the surface plane.

    get_target_diameters parity (psp_process.cpp:117-165): circle of the
    physical diameter in the plane normal to the nearest node's normal,
    projected; diameter = mean over 4 samples of 2*|proj - uv|.
    """
    H, W = image_hw
    diams = np.zeros(len(targets))
    for i, tg in enumerate(targets):
        if tg.diameter == 0.0 or tg.uv is None:
            continue
        if not (0 <= tg.uv[0] < W and 0 <= tg.uv[1] < H):
            continue
        nearest = model.nearest_node(tg.xyz[None, :])[0]
        n = model.normals[nearest].astype(np.float64)
        # perpendicular basis in the circle plane
        a = np.cross(n, [1.0, 0.0, 0.0])
        if np.linalg.norm(a) < 1e-8:
            a = np.cross(n, [0.0, 1.0, 0.0])
        a /= np.linalg.norm(a)
        b = np.cross(a, n)
        total = 0.0
        for k in range(4):
            theta = 2 * np.pi * k / 4
            pt = tg.xyz + 0.5 * tg.diameter * (np.cos(theta) * a + np.sin(theta) * b)
            proj = np.array(project_points(params, jnp.asarray(pt[None, :])))[0]
            total += 2.0 * np.linalg.norm(proj - tg.uv)
        diams[i] = total / 4.0
    return diams


def build_patcher_for_camera(
    cfg: ProcessingConfig,
    params: CameraParams,
    bvh_dev: BVHArrays,
    model: SurfaceModel,
    first_frame: np.ndarray,
    targets_file: str,
    image_hw: Tuple[int, int],
    bit_depth: int = 12,
    max_leaf: int = 4,
    flat_bvh: Optional[FlatBVH] = None,
):
    """InitializeImagePatches parity: visible targets+fiducials -> clusters ->
    boundary threshold -> composed patch operator.

    Returns (PatchOperator | None, diagnostics | None); diagnostics carries
    the projected fiducial positions + cluster assignment for the overlay
    images (psp_process.cpp:2113-2145)."""
    targs = read_tgts(targets_file)
    fids = read_tgts(targets_file, section="*Fiducials")
    all_t = targs + fids
    if not all_t:
        return None, None
    # patching visibility uses a slightly wider oblique threshold
    oblique = min(cfg.oblique_angle + 5.0, 90.0)
    vis = visible_targets(all_t, params, bvh_dev, model, oblique, image_hw,
                          max_leaf=max_leaf, flat_bvh=flat_bvh)
    if not vis:
        return None, None
    diams = target_image_diameters(vis, params, model, image_hw)
    diams = diams * cfg.target_diam_sf
    keep = diams > 0
    vis_kept = [t for t, k in zip(vis, keep) if k]
    uv = np.stack([t.uv for t in vis])[keep]
    diams = diams[keep]
    if uv.shape[0] == 0:
        return None, None
    from upsp_tpu.ops.patching import cluster_targets

    groups = cluster_targets(
        uv, diams, cfg.bound_thickness + cfg.buffer_thickness
    )
    cluster_of = np.zeros(uv.shape[0], np.int32)
    for gi, g in enumerate(groups):
        cluster_of[g] = gi
    diag = {
        "uv": uv,
        "cluster_of": cluster_of,
        "names": [str(getattr(t, "idx", i)) for i, t in enumerate(vis_kept)],
    }
    clusters = build_patch_clusters(
        uv, diams, image_hw, bound_pts=cfg.bound_thickness,
        buffer=cfg.buffer_thickness,
    )
    thresh = patch_threshold_from_frame(first_frame, bit_depth)
    clusters = threshold_bounds(clusters, first_frame, thresh, offset=2)
    op = build_patch_operator(clusters, image_hw)
    gain = fill_gain(op)
    if gain > FILL_GAIN_WARN:
        import logging

        logging.getLogger("upsp_tpu").warning(
            "patching: a cluster's fill amplifies boundary-pixel error "
            "%.0fx (a whole ring gives ~3); the threshold %d or the frame "
            "edge left it few boundary pixels", gain, thresh,
        )
    return op, diag


def run_phase0(
    cfg: ProcessingConfig,
    first_frames: Sequence[np.ndarray],
    bit_depths: Optional[Sequence[int]] = None,
    model: Optional[SurfaceModel] = None,
    max_leaf: int = 4,
) -> Phase0State:
    """Build the full phase-0 state from config + per-camera first frames."""
    if model is None:
        model = load_model(cfg.grid, tolerance=cfg.grid_tol)
    if cfg.x_max is not None:
        model.mark_nondata_x_max(cfg.x_max)
    if cfg.active_comps:
        from upsp_tpu.io.comps import apply_active_comps

        n_masked = apply_active_comps(model, cfg.active_comps)
        if n_masked:
            import logging

            logging.getLogger("upsp_tpu").info(
                "active_comps: masked %d nodes of inactive components", n_masked
            )
    if cfg.normals:
        _apply_normals_file(model, cfg.normals)

    H, W = first_frames[0].shape
    image_hw = (H, W)
    bit_depths = bit_depths or [12] * len(first_frames)

    # SAH-bucket splits when the ray budget dominates the build (campaign-
    # scale meshes; the reference always builds SAH, pspRT.cpp:499-525 —
    # below the threshold the median build's lower constant wins on the
    # phase-0 wall clock).  UPSP_BVH_METHOD=median|sah overrides.
    bvh_method = os.environ.get(
        "UPSP_BVH_METHOD",
        "sah" if model.triangles.shape[0] >= 2_000_000 else "median",
    )
    bvh = build_bvh(
        model.vertices, model.triangles, leaf_size=max_leaf,
        method=bvh_method,
    )
    from upsp_tpu import native as _native

    # the device-resident BVH is only needed for the JAX traversal fallback
    # (virtual-mesh tests); with the native walker it would waste HBM at scale
    bvh_dev = None if _native.available() else bvh_to_device(bvh)

    cam_params: List[CameraParams] = []
    raw_projs: List[NodeProjection] = []
    patch_ops: List[Optional[PatchOperator]] = []
    patch_diags: List[Optional[dict]] = []
    tris_dev = jnp.asarray(model.triangles)
    verts_dev = jnp.asarray(model.vertices)
    norms_dev = jnp.asarray(model.normals)
    datanode_dev = jnp.asarray(model.is_datanode)

    for c, cam in enumerate(cfg.cameras):
        cal = read_camera_json(cam.calibration, dims_hw=image_hw)
        params = make_camera_params(
            cal.rmat, cal.tvec, cal.camera_matrix, cal.dist_coeffs,
            dtype=jnp.float32,
        )
        cam_params.append(params)
        from upsp_tpu import native as _native

        if _native.available():
            # phase-0 visibility rays walk the BVH in native code (the
            # vmapped while_loop traversal is the fallback without it)
            raw_projs.append(
                build_node_projection_host(
                    params, bvh, model.triangles, model.vertices,
                    model.normals, model.is_datanode,
                    cfg.oblique_angle, H, W,
                )
            )
        else:
            raw_projs.append(
                build_node_projection(
                    params, bvh_dev, tris_dev, verts_dev, norms_dev,
                    datanode_dev, cfg.oblique_angle, H, W, max_leaf=max_leaf,
                )
            )
        if cfg.target_patcher == "polynomial" and cam.targets:
            op, diag = build_patcher_for_camera(
                cfg, params, bvh_dev, model, first_frames[c], cam.targets,
                image_hw, bit_depths[c], max_leaf=max_leaf, flat_bvh=bvh,
            )
            patch_ops.append(op)
            patch_diags.append(diag)
        else:
            patch_ops.append(None)
            patch_diags.append(None)

    centers = [cam_center(p) for p in cam_params]
    projs = adjust_projection_for_weights(
        raw_projs, centers, verts_dev, norms_dev, overlap=cfg.overlap
    )
    skipped = identify_skipped_nodes(projs)

    # The ECC template is the hot-pixel-FIXED first frame: the reference's
    # read-ahead repairs frame 1 before it becomes the registration template
    # (psp_process.cpp:880), and phase 1 repairs every input frame — template
    # and input must see the same pixels at hot-pixel sites.
    from upsp_tpu.ops.image import fix_hot_pixels

    ref_frames = jnp.stack(
        [
            fix_hot_pixels(jnp.asarray(f)).astype(jnp.float32)
            for f in first_frames
        ]
    )
    return Phase0State(
        model=model,
        bvh=bvh,
        bvh_dev=bvh_dev,
        cam_params=cam_params,
        projections=projs,
        skipped=skipped,
        patch_ops=patch_ops,
        patch_diags=patch_diags,
        ref_frames=ref_frames,
        superseded_by=jnp.asarray(model.superseded_by),
        image_hw=image_hw,
        config=cfg,
    )


def _apply_normals_file(model: SurfaceModel, path: str) -> None:
    """Normals-override file: 'nidx nx ny nz' rows (set_surface_normals)."""
    data = np.loadtxt(path, ndmin=2)
    if data.size == 0:
        return
    idx = data[:, 0].astype(np.int64)
    model.set_normals(idx, data[:, 1:4])
