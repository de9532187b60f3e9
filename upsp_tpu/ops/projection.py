"""Pixel -> grid-node projection as static-index device gathers.

Phase 0 of the reference builds an Eigen sparse matrix with exactly one entry
per visible node (nearest pixel, weight 1), later rescaled by multi-camera
weights; each frame is then a sparse SpMV (cpp/exec/psp_process.cpp:167-355,
cpp/lib/projection.ipp:884-1080 — behavior studied, not copied).

One-entry-per-row sparsity means SpMV is really a *gather*: per camera we carry
``pixel_index (N,)`` + ``weight (N,)`` and per-frame projection is
``frame.ravel()[pixel_index] * weight`` — one fused gather/FMA that XLA folds
into the per-frame program.  Multi-camera combination is a weighted sum over
the camera axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from upsp_tpu.camera.model import CameraParams, cam_center, project_points
from upsp_tpu.ops.raycast import BVHArrays, bvh_intersect, oblique_cos_filter


class NodeProjection(NamedTuple):
    """Per-camera node->pixel map (all (N,) arrays)."""

    pixel_index: jax.Array  # int32 flat pixel index (row * W + col); 0 if invalid
    weight: jax.Array  # float32 combined visibility/overlap weight
    u: jax.Array  # float32 normalized image u in [0,1] (0 if invalid)
    v: jax.Array  # float32 normalized v
    visible: jax.Array  # bool raw visibility before multi-camera weighting


@functools.partial(jax.jit, static_argnames=("height", "width", "max_leaf", "n_jitter"))
def build_node_projection(
    params: CameraParams,
    bvh: BVHArrays,
    triangles: jax.Array,  # (T, 3) original node ids per tri
    vertices: jax.Array,  # (N, 3)
    normals: jax.Array,  # (N, 3)
    is_datanode: jax.Array,  # (N,) bool
    oblique_angle_deg: float,
    height: int,
    width: int,
    max_leaf: int = 4,
    n_jitter: int = 6,
    jitter: float = 1e-4,
) -> NodeProjection:
    """Visibility-tested nearest-pixel assignment for every model node.

    Semantics mirror create_projection_mat (psp_process.cpp:167-355): in-frame
    test, closest-hit ray camera->node must land on a triangle incident to the
    node (with 6 jittered retries), then the oblique-angle cull.
    """
    n = vertices.shape[0]
    center = cam_center(params).astype(vertices.dtype)

    pix = project_points(params, vertices)  # (N, 2) float
    # reference: cv::Point2i(round(x), round(y)) must lie inside the frame;
    # upsp::contains(f_sz, pt) checks the float point in [0, W)x[0, H)
    in_frame = (
        (pix[:, 0] >= 0)
        & (pix[:, 0] < width)
        & (pix[:, 1] >= 0)
        & (pix[:, 1] < height)
    )

    d = vertices - center
    dist = jnp.linalg.norm(d, axis=1, keepdims=True)
    dirs = d / jnp.maximum(dist, 1e-30)
    origins = jnp.broadcast_to(center, vertices.shape)

    _, prim, hit = bvh_intersect(bvh, origins, dirs, max_leaf=max_leaf)
    tri_nodes = triangles[jnp.maximum(prim, 0)]
    node_ids = jnp.arange(n, dtype=tri_nodes.dtype)
    own = hit & jnp.any(tri_nodes == node_ids[:, None], axis=1)

    offsets = jnp.array(
        [
            [-jitter, 0, 0],
            [jitter, 0, 0],
            [0, -jitter, 0],
            [0, jitter, 0],
            [0, 0, -jitter],
            [0, 0, jitter],
        ],
        vertices.dtype,
    )
    for k in range(n_jitter):
        pk = vertices + offsets[k]
        dk = pk - center
        dk = dk / jnp.maximum(jnp.linalg.norm(dk, axis=1, keepdims=True), 1e-30)
        _, prim_k, hit_k = bvh_intersect(bvh, origins, dk, max_leaf=max_leaf)
        trik = triangles[jnp.maximum(prim_k, 0)]
        own = own | (hit_k & jnp.any(trik == node_ids[:, None], axis=1))

    forward = oblique_cos_filter(normals, dirs.astype(normals.dtype), oblique_angle_deg)

    visible = is_datanode & in_frame & own & forward

    col = jnp.clip(jnp.rint(pix[:, 0]).astype(jnp.int32), 0, width - 1)
    row = jnp.clip(jnp.rint(pix[:, 1]).astype(jnp.int32), 0, height - 1)
    flat = row * width + col
    zero = jnp.zeros((), jnp.float32)
    return NodeProjection(
        pixel_index=jnp.where(visible, flat, 0),
        weight=jnp.where(visible, 1.0, zero),
        u=jnp.where(visible, (pix[:, 0] / width).astype(jnp.float32), zero),
        v=jnp.where(visible, (pix[:, 1] / height).astype(jnp.float32), zero),
        visible=visible,
    )


def build_node_projection_host(
    params: CameraParams,
    flat_bvh,  # FlatBVH (host arrays)
    triangles: np.ndarray,
    vertices: np.ndarray,
    normals: np.ndarray,
    is_datanode: np.ndarray,
    oblique_angle_deg: float,
    height: int,
    width: int,
    n_jitter: int = 6,
    jitter: float = 1e-4,
) -> NodeProjection:
    """Host/native-raycast version of build_node_projection (same semantics).

    Phase 0's visibility rays traverse the BVH on the host through the
    multithreaded C++ walker (a vmapped while_loop traversal runs every
    lane to the longest ray's depth); everything else is vectorized numpy.
    """
    from upsp_tpu import native

    n = vertices.shape[0]
    center = np.array(cam_center(params), np.float64)
    # f64 projection when x64 is live (tests/host); otherwise request f32
    # explicitly rather than triggering the x64 truncation warning
    pdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    pix = np.array(project_points(params, jnp.asarray(vertices, pdtype)))
    in_frame = (
        (pix[:, 0] >= 0) & (pix[:, 0] < width)
        & (pix[:, 1] >= 0) & (pix[:, 1] < height)
    )

    d = vertices.astype(np.float64) - center
    dist = np.linalg.norm(d, axis=1, keepdims=True)
    dirs = (d / np.maximum(dist, 1e-30)).astype(np.float32)
    origins = np.broadcast_to(center.astype(np.float32), vertices.shape)

    node_ids = np.arange(n)
    _, prim, hit = native.bvh_intersect(flat_bvh, origins, dirs)
    tri_nodes = triangles[np.maximum(prim, 0)]
    own = hit & np.any(tri_nodes == node_ids[:, None], axis=1)

    offsets = np.array(
        [[-jitter, 0, 0], [jitter, 0, 0], [0, -jitter, 0],
         [0, jitter, 0], [0, 0, -jitter], [0, 0, jitter]], np.float64,
    )
    for k in range(n_jitter):
        missing = ~own
        if not missing.any():
            break
        pk = vertices[missing].astype(np.float64) + offsets[k]
        dk = pk - center
        dk = (dk / np.linalg.norm(dk, axis=1, keepdims=True)).astype(np.float32)
        _, prim_k, hit_k = native.bvh_intersect(
            flat_bvh, origins[missing], dk
        )
        trik = triangles[np.maximum(prim_k, 0)]
        own_k = hit_k & np.any(trik == node_ids[missing][:, None], axis=1)
        own[missing] |= own_k

    thresh = np.cos(np.deg2rad(180.0 - oblique_angle_deg))
    cos_theta = np.sum(normals * dirs, axis=-1)
    forward = cos_theta < thresh

    visible = np.asarray(is_datanode, bool) & in_frame & own & forward
    col = np.clip(np.rint(pix[:, 0]), 0, width - 1).astype(np.int32)
    row = np.clip(np.rint(pix[:, 1]), 0, height - 1).astype(np.int32)
    flat = row * width + col
    return NodeProjection(
        pixel_index=jnp.asarray(np.where(visible, flat, 0)),
        weight=jnp.asarray(visible.astype(np.float32)),
        u=jnp.asarray(np.where(visible, pix[:, 0] / width, 0).astype(np.float32)),
        v=jnp.asarray(np.where(visible, pix[:, 1] / height, 0).astype(np.float32)),
        visible=jnp.asarray(visible),
    )


def view_angles_deg(
    vertices: jax.Array, normals: jax.Array, center: jax.Array
) -> jax.Array:
    """Angle (degrees) between camera->node direction and the node normal.

    Larger is better (a facing surface scores ~180 deg) — the quantity both
    BestView and AverageViews rank on (projection.ipp:228-268 semantics).
    """
    d = vertices - center
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
    cos_t = jnp.clip(jnp.sum(d * normals, axis=-1), -1.0, 1.0)
    return jnp.degrees(jnp.arccos(cos_t))


def adjust_projection_for_weights(
    projections: Sequence[NodeProjection],
    cam_centers: Sequence[jax.Array],
    vertices: jax.Array,
    normals: jax.Array,
    overlap: str = "best_view",
) -> list:
    """Rescale per-camera weights where several cameras see the same node.

    - best_view: the camera with the largest view angle gets weight 1 (first
      camera wins ties), the rest 0.
    - average_views: weight_i = angle_i / sum(angles) over seeing cameras.

    Nodes seen by a single camera keep weight 1 (the reference only touches
    rows present in multiple matrices).
    """
    C = len(projections)
    vis = jnp.stack([p.visible for p in projections])  # (C, N)
    angles = jnp.stack(
        [view_angles_deg(vertices, normals, c) for c in cam_centers]
    )  # (C, N)
    angles = jnp.where(vis, angles, -jnp.inf)
    n_seen = vis.sum(axis=0)  # (N,)
    multi = n_seen > 1

    if overlap == "best_view":
        best = jnp.argmax(angles, axis=0)  # first max wins ties (C small)
        w = (jnp.arange(C)[:, None] == best[None, :]).astype(jnp.float32)
    elif overlap in ("average_views", "average_view"):
        pos = jnp.where(vis, angles, 0.0)
        s = jnp.maximum(pos.sum(axis=0), 1e-30)
        w = (pos / s).astype(jnp.float32)
    else:
        raise ValueError(f"unknown overlap type: {overlap}")

    new_w = jnp.where(multi[None, :], w * vis, vis.astype(jnp.float32))
    return [
        NodeProjection(p.pixel_index, new_w[c], p.u, p.v, p.visible)
        for c, p in enumerate(projections)
    ]


def identify_skipped_nodes(projections: Sequence[NodeProjection]) -> jax.Array:
    """(N,) bool — nodes no camera covers (NaN-filled downstream)."""
    vis = jnp.stack([p.visible for p in projections])
    return ~jnp.any(vis, axis=0)


def project_frame(frame: jax.Array, proj: NodeProjection) -> jax.Array:
    """One camera's frame -> per-node intensities: gather + weight."""
    return frame.reshape(-1)[proj.pixel_index] * proj.weight


def project_frames_multicam(
    frames: jax.Array, projections: Sequence[NodeProjection], skipped: jax.Array
) -> jax.Array:
    """Combine cameras: sum of weighted gathers; skipped nodes -> NaN.

    ``frames``: (C, H, W) processed (registered/patched/filtered) images.
    """
    total = None
    for c, proj in enumerate(projections):
        sol = project_frame(frames[c], proj)
        total = sol if total is None else total + sol
    return jnp.where(skipped, jnp.nan, total)


def coverage(projections: Sequence[NodeProjection], height: int, width: int):
    """Project an all-ones frame through every camera (coverage dataset)."""
    ones = jnp.ones((len(projections), height, width), jnp.float32)
    skipped = identify_skipped_nodes(projections)
    cov = project_frames_multicam(ones, projections, skipped)
    return jnp.where(jnp.isnan(cov), 0.0, cov)


def projections_to_arrays(projections: Sequence[NodeProjection]):
    """Stack per-camera NodeProjections into (C, N) arrays for the pipeline."""
    return NodeProjection(
        pixel_index=jnp.stack([p.pixel_index for p in projections]),
        weight=jnp.stack([p.weight for p in projections]),
        u=jnp.stack([p.u for p in projections]),
        v=jnp.stack([p.v for p in projections]),
        visible=jnp.stack([p.visible for p in projections]),
    )
