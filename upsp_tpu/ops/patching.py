"""Fiducial patching: cover marker dots with a smooth local polynomial fill.

The reference fits a 3rd-order 2D polynomial to each cluster's boundary-ring
pixels and overwrites the interior, every frame (cpp/lib/patches.ipp — studied,
not copied).  The fit+eval is *linear* in the boundary values, so Phase 0
precomputes, per cluster, the composed operator

    M = A_internal @ pinv(A_boundary)        (I x B)

and the per-frame patch application becomes: gather boundary pixels -> one
batched (clusters, I, B) matmul -> scatter interiors.  Bit-identical
math to fit-then-eval, at a fraction of the cost, and fully fused into the
per-frame XLA program.

Cluster construction (host, Phase 0 only — data-dependent):
- per-target bounding boxes from image-plane diameter,
- BFS clustering of overlapping boxes (patches.ipp:cluster_points semantics),
- row/column convex fill of the cluster mask, boundary ring of thickness
  ``bound_pts`` offset by ``buffer`` (patches.ipp:get_cluster_boundary),
- boundary pixels darker than a histogram threshold are dropped
  (PatchClusters::threshold_bounds).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# host-side cluster construction


@dataclasses.dataclass
class PatchCluster:
    bounds_xy: np.ndarray  # (B, 2) int boundary pixel coords (x, y)
    internal_xy: np.ndarray  # (I, 2) int interior pixel coords


def _target_box(uv: np.ndarray, diameter: float) -> Tuple[np.ndarray, np.ndarray]:
    t_min = np.floor(uv - 0.5 * diameter).astype(np.int64)
    t_max = np.ceil(uv + 0.5 * diameter).astype(np.int64)
    return t_min, t_max


def cluster_targets(
    uv: np.ndarray, diameters: np.ndarray, bound_pts: int = 4
) -> List[np.ndarray]:
    """Group targets whose patch regions would touch (BFS, brute force)."""
    n = uv.shape[0]
    unvisited = set(range(n))
    clusters = []
    while unvisited:
        seed = min(unvisited)
        unvisited.discard(seed)
        members = [seed]
        queue = [seed]
        while queue:
            ref = queue.pop()
            close = []
            for j in list(unvisited):
                lim = bound_pts + 0.5 * (diameters[ref] + diameters[j])
                if np.linalg.norm(uv[ref] - uv[j]) <= lim:
                    close.append(j)
            for j in close:
                unvisited.discard(j)
                members.append(j)
                queue.append(j)
        clusters.append(np.array(members, np.int64))
    return clusters


def _single_target_boundary(
    uv: np.ndarray, diameter: float, bound_pts: int, buffer: int
) -> PatchCluster:
    t_min, t_max = _target_box(uv, diameter)
    xs = np.arange(t_min[0], t_max[0] + 1)
    ys = np.arange(t_min[1], t_max[1] + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    internal = np.stack([gx.ravel(), gy.ravel()], axis=1)

    pad = bound_pts + buffer
    bxs = np.arange(t_min[0] - pad, t_max[0] + pad + 1)
    bys = np.arange(t_min[1] - pad, t_max[1] + pad + 1)
    gx, gy = np.meshgrid(bxs, bys, indexing="ij")
    outside = (
        (gx < t_min[0] - buffer)
        | (gx > t_max[0] + buffer)
        | (gy < t_min[1] - buffer)
        | (gy > t_max[1] + buffer)
    )
    bounds = np.stack([gx[outside], gy[outside]], axis=1)
    return PatchCluster(bounds_xy=bounds, internal_xy=internal)


def _multi_target_boundary(
    uvs: np.ndarray, diameters: np.ndarray, bound_pts: int, buffer: int
) -> PatchCluster:
    mins, maxs = [], []
    for k in range(uvs.shape[0]):
        lo, hi = _target_box(uvs[k], diameters[k])
        mins.append(lo)
        maxs.append(hi)
    mins = np.stack(mins)
    maxs = np.stack(maxs)
    t_min = mins.min(axis=0) - (bound_pts + buffer)
    t_max = maxs.max(axis=0) + (bound_pts + buffer)
    dx = int(t_max[0] - t_min[0] + 1)
    dy = int(t_max[1] - t_min[1] + 1)
    mask = np.zeros((dx, dy), np.int8)
    for k in range(uvs.shape[0]):
        lo = mins[k] - t_min
        hi = maxs[k] - t_min
        mask[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1] = 2

    # row/column fill between extreme marked cells (convex-ish hull fill)
    for x in range(dx):
        idx = np.nonzero(mask[x] == 2)[0]
        if idx.size:
            mask[x, idx[0] : idx[-1] + 1] = 2
    for y in range(dy):
        idx = np.nonzero(mask[:, y] == 2)[0]
        if idx.size:
            mask[idx[0] : idx[-1] + 1, y] = 2

    filled = mask == 2
    internal_idx = np.argwhere(filled)

    # boundary: cells not in the region, with a region cell within
    # bound_pts+buffer, but none within buffer (the buffer gap stays empty)
    from scipy.ndimage import maximum_filter

    reach = maximum_filter(filled, size=2 * (bound_pts + buffer) + 1)
    if buffer > 0:
        near = maximum_filter(filled, size=2 * buffer + 1)
    else:
        near = filled
    bound_mask = reach & (~near) & (~filled)
    bounds_idx = np.argwhere(bound_mask)

    return PatchCluster(
        bounds_xy=bounds_idx + t_min[None, :],
        internal_xy=internal_idx + t_min[None, :],
    )


def build_patch_clusters(
    uv: np.ndarray,
    diameters: np.ndarray,
    image_hw: Tuple[int, int],
    bound_pts: int = 3,
    buffer: int = 2,
) -> List[PatchCluster]:
    """Cluster targets and compute in-frame boundary/interior pixel sets."""
    H, W = image_hw
    groups = cluster_targets(uv, diameters, bound_pts + buffer)
    out = []
    for g in groups:
        if len(g) == 1:
            pc = _single_target_boundary(uv[g[0]], diameters[g[0]], bound_pts, buffer)
        else:
            pc = _multi_target_boundary(uv[g], diameters[g], bound_pts, buffer)
        keep_b = (
            (pc.bounds_xy[:, 0] >= 0)
            & (pc.bounds_xy[:, 0] < W)
            & (pc.bounds_xy[:, 1] >= 0)
            & (pc.bounds_xy[:, 1] < H)
        )
        keep_i = (
            (pc.internal_xy[:, 0] >= 0)
            & (pc.internal_xy[:, 0] < W)
            & (pc.internal_xy[:, 1] >= 0)
            & (pc.internal_xy[:, 1] < H)
        )
        out.append(
            PatchCluster(bounds_xy=pc.bounds_xy[keep_b], internal_xy=pc.internal_xy[keep_i])
        )
    return out


def threshold_bounds(
    clusters: Sequence[PatchCluster],
    ref_frame: np.ndarray,
    thresh: float,
    offset: int = 2,
) -> List[PatchCluster]:
    """Drop boundary pixels whose (offset-box) neighborhood dips below thresh."""
    from scipy.ndimage import minimum_filter

    local_min = minimum_filter(
        np.asarray(ref_frame, np.float64), size=2 * offset + 1, mode="nearest"
    )
    out = []
    for c in clusters:
        vals = local_min[c.bounds_xy[:, 1], c.bounds_xy[:, 0]]
        keep = vals >= thresh
        out.append(PatchCluster(bounds_xy=c.bounds_xy[keep], internal_xy=c.internal_xy))
    return out


# ---------------------------------------------------------------------------
# polynomial basis + composed patch operator


def poly2d_basis(x: np.ndarray, y: np.ndarray, degree: int = 3) -> np.ndarray:
    """Columns y^i * x^j for i+j <= degree, (i outer, j inner) ordering."""
    cols = []
    for i in range(degree + 1):
        for j in range(degree + 1):
            if i + j <= degree:
                cols.append((y.astype(np.float64) ** i) * (x.astype(np.float64) ** j))
    return np.stack(cols, axis=1)


def polyfit2d(x, y, z, degree: int = 3) -> np.ndarray:
    """Least-squares 2D polynomial fit (reference polyfit2D semantics)."""
    A = poly2d_basis(np.asarray(x), np.asarray(y), degree)
    coeffs, *_ = np.linalg.lstsq(A, np.asarray(z, np.float64), rcond=None)
    return coeffs


def polyval2d(x, y, coeffs, degree: int = 3) -> np.ndarray:
    return poly2d_basis(np.asarray(x), np.asarray(y), degree) @ np.asarray(coeffs)


class PatchOperator(NamedTuple):
    """Padded, batched patch operator for the fused per-frame path."""

    M: jax.Array  # (K, I_max, B_max) float32 — composed fill operator
    boundary_idx: jax.Array  # (K, B_max) int32 flat pixel indices (0 where pad)
    internal_idx: jax.Array  # (K, I_max) int32 flat indices (H*W where pad -> drop)
    n_clusters: int

    @property
    def empty(self) -> bool:
        return self.n_clusters == 0


def build_patch_operator(
    clusters: Sequence[PatchCluster],
    image_hw: Tuple[int, int],
    degree: int = 3,
) -> Optional[PatchOperator]:
    """Compose fit+eval into one matrix per cluster; pad and batch."""
    H, W = image_hw
    n_coef = (degree + 2) * (degree + 1) // 2
    keep = [
        c
        for c in clusters
        if c.bounds_xy.shape[0] >= n_coef and c.internal_xy.shape[0] > 0
    ]
    if not keep:
        return None
    B_max = max(c.bounds_xy.shape[0] for c in keep)
    I_max = max(c.internal_xy.shape[0] for c in keep)
    K = len(keep)
    M = np.zeros((K, I_max, B_max), np.float32)
    b_idx = np.zeros((K, B_max), np.int64)
    i_idx = np.full((K, I_max), H * W, np.int64)  # out-of-range -> dropped scatter
    for k, c in enumerate(keep):
        bx, by = c.bounds_xy[:, 0], c.bounds_xy[:, 1]
        ix, iy = c.internal_xy[:, 0], c.internal_xy[:, 1]
        A_b = poly2d_basis(bx, by, degree)
        A_i = poly2d_basis(ix, iy, degree)
        Mk = A_i @ np.linalg.pinv(A_b)
        M[k, : Mk.shape[0], : Mk.shape[1]] = Mk
        b_idx[k, : bx.shape[0]] = by * W + bx
        i_idx[k, : ix.shape[0]] = iy * W + ix
    return PatchOperator(
        M=jnp.asarray(M),
        boundary_idx=jnp.asarray(b_idx, jnp.int32),
        internal_idx=jnp.asarray(i_idx, jnp.int32),
        n_clusters=K,
    )


def fill_gain(op: Optional[PatchOperator]) -> float:
    """Largest absolute row sum of the operator: the most a fill value can
    move per count of error in the boundary pixels (0 without clusters).

    About 3.4 for a cubic filled from a whole boundary ring; a ring that
    lost most of its pixels gives hundreds or thousands.
    """
    if op is None:
        return 0.0
    return float(np.abs(np.asarray(op.M, np.float64)).sum(axis=2).max())


def apply_patches(frame: jax.Array, op: Optional[PatchOperator]) -> jax.Array:
    """Patch all clusters in one batched matmul + scatter (jit/vmap-safe).

    bfloat16 frames stay bfloat16 (the scatter rewrites the full image, so
    the dtype sets the pass cost); the cluster matmul itself always runs on
    gathered values promoted through the f32 operator.

    The matmul runs at "highest" precision whatever the default: a cluster
    whose boundary ring lost most of its pixels to the threshold (or to the
    frame edge) extrapolates a cubic from a few pixels, and its operator
    rows can sum to thousands in absolute value.  A GPU's TF32 passes
    round M and z to 10-bit mantissas, and such a row turns that rounding
    into hundreds of counts of fill error.  The matmul is a few MFLOP per
    frame, so full f32 costs nothing measurable.
    """
    dtype = frame.dtype if frame.dtype == jnp.bfloat16 else jnp.float32
    if op is None:
        return frame.astype(dtype)
    flat = frame.reshape(-1).astype(dtype)
    z = flat[op.boundary_idx]  # (K, B_max); padded slots gather pixel 0 but
    # their M columns are zero, so they contribute nothing
    fill = jnp.einsum(  # batched matmul
        "kib,kb->ki", op.M, z, precision=jax.lax.Precision.HIGHEST
    )
    out = flat.at[op.internal_idx.reshape(-1)].set(
        fill.reshape(-1).astype(dtype), mode="drop"
    )
    return out.reshape(frame.shape)
