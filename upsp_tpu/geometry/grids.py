"""Unified surface-model geometry: triangle soup, normals, overlap handling.

This engine flattens both grid families of the reference into one
array-of-structs-free representation:

- vertices   (N, 3) float32
- triangles  (T, 3) int32                (winding: outward normal, right-hand)
- normals    (N, 3) float32 node normals (area-weighted adjacent-face normals)
- components (N,)   int32   primary component / zone id per node

P3DModel_-specific behavior reproduced (cpp/include/P3DModel.h:71-358,
cpp/lib/P3DModel.ipp:1685-1699 — studied, not copied):

- overlapping-node detection within a spatial tolerance; the lowest-index node
  of an overlap set is primary, the rest are "superseded" and excluded from
  projection (non-data), and :func:`adjust_solution` copies the primary's value
  back onto them,
- node normals = normalized area-weighted sum of adjacent face normals, where a
  quad face's normal is its first triangle's unit normal weighted by the full
  quad area.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

from upsp_tpu.io.cart3d import TriMesh
from upsp_tpu.io.plot3d import StructGrid


def triangle_normals_areas(vertices: np.ndarray, triangles: np.ndarray):
    """Unit normals (T,3) and areas (T,) of a triangle soup."""
    a = vertices[triangles[:, 0]]
    b = vertices[triangles[:, 1]]
    c = vertices[triangles[:, 2]]
    cr = np.cross(b - a, c - a)
    norm = np.linalg.norm(cr, axis=1)
    areas = 0.5 * norm
    unit = np.zeros_like(cr)
    nz = norm > 0
    unit[nz] = cr[nz] / norm[nz][:, None]
    return unit.astype(np.float32), areas.astype(np.float32)


@dataclasses.dataclass
class SurfaceModel:
    """Triangle-soup surface model with uPSP node semantics."""

    vertices: np.ndarray  # (N, 3) float32
    triangles: np.ndarray  # (T, 3) int32
    normals: np.ndarray  # (N, 3) float32 unit node normals
    components: np.ndarray  # (N,) int32
    is_datanode: np.ndarray  # (N,) bool — excluded: superseded overlaps, x>x_max...
    superseded_by: np.ndarray  # (N,) int32 — primary node index (self if primary)
    grid: Optional[StructGrid] = None  # source structured grid, if any
    _kdtree: Optional[cKDTree] = dataclasses.field(default=None, repr=False)

    @property
    def size(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def kdtree(self) -> cKDTree:
        if self._kdtree is None:
            self._kdtree = cKDTree(self.vertices)
        return self._kdtree

    def nearest_node(self, points: np.ndarray) -> np.ndarray:
        """Indices of the nearest model node for each query point (Q,3)."""
        _, idx = self.kdtree.query(np.atleast_2d(points))
        return idx

    def set_node_nondata(self, mask_or_indices) -> None:
        self.is_datanode[mask_or_indices] = False

    def mark_nondata_x_max(self, x_max: float) -> None:
        """Exclude nodes with x > x_max (sting/support hardware)."""
        self.is_datanode[self.vertices[:, 0] > x_max] = False

    def adjust_solution(self, sol: np.ndarray) -> np.ndarray:
        """Copy each overlap-primary node's value onto its superseded nodes."""
        return sol[..., self.superseded_by]

    def set_normals(self, indices: np.ndarray, directions: np.ndarray) -> None:
        """Override node normals (normals-file support, upsp_inputs 'normals')."""
        d = np.asarray(directions, np.float32)
        n = np.linalg.norm(d, axis=-1, keepdims=True)
        self.normals[indices] = d / np.maximum(n, 1e-30)


def _node_normals_from_quads(
    vertices: np.ndarray, grid: StructGrid
) -> np.ndarray:
    """Area-weighted quad-face normals accumulated at the 4 corner nodes."""
    accum = np.zeros((vertices.shape[0], 3), np.float64)
    idx0 = 0
    for dims in grid.sz:
        imax, jmax = int(dims[0]), int(dims[1])
        kmax = int(dims[2]) if len(dims) > 2 else 1
        if imax >= 2 and jmax >= 2:
            ii = np.arange(imax - 1)
            jj = np.arange(jmax - 1)
            jjg, iig = np.meshgrid(jj, ii, indexing="ij")
            p0 = (idx0 + jjg * imax + iig).ravel()
            p1 = p0 + 1
            p2 = (idx0 + (jjg + 1) * imax + iig + 1).ravel()
            p3 = p2 - 1
            a, b, c, d = vertices[p0], vertices[p1], vertices[p2], vertices[p3]
            n1 = np.cross(b - a, c - a)
            n2 = np.cross(c - a, d - a)
            a1 = 0.5 * np.linalg.norm(n1, axis=1)
            a2 = 0.5 * np.linalg.norm(n2, axis=1)
            n1u = np.where(
                (np.linalg.norm(n1, axis=1) > 0)[:, None],
                n1 / np.maximum(np.linalg.norm(n1, axis=1), 1e-30)[:, None],
                0.0,
            )
            w = (a1 + a2)[:, None] * n1u
            for p in (p0, p1, p2, p3):
                np.add.at(accum, p, w)
        idx0 += imax * jmax * max(kmax, 1)
    norms = np.linalg.norm(accum, axis=1, keepdims=True)
    out = np.where(norms > 0, accum / np.maximum(norms, 1e-30), 0.0)
    return out.astype(np.float32)


def _node_normals_from_tris(vertices: np.ndarray, triangles: np.ndarray):
    unit, areas = triangle_normals_areas(vertices, triangles)
    accum = np.zeros((vertices.shape[0], 3), np.float64)
    w = unit * areas[:, None]
    for k in range(3):
        np.add.at(accum, triangles[:, k], w)
    norms = np.linalg.norm(accum, axis=1, keepdims=True)
    return np.where(norms > 0, accum / np.maximum(norms, 1e-30), 0.0).astype(
        np.float32
    )


def find_overlapping_nodes(grid: StructGrid, tolerance: float) -> np.ndarray:
    """Zone-boundary overlap detection (P3DModel_::identifyOverlap semantics).

    Only nodes on a zone's edge rows/columns participate; a pair within
    ``tolerance`` overlaps only if the nodes come from *different* zones, or
    from the same zone when it wraps onto itself (equal fast index with slow
    indices 0 and max, or vice versa).  Supersession is by the lowest *direct*
    partner, not transitive union (P3DModel.ipp:1346-1354); chains resolve in
    ascending order exactly like the reference's adjust_solution loop.

    Returns superseded_by (N,) int32: for each node, the node whose value it
    mirrors (itself if primary / not overlapping).
    """
    n = grid.size
    superseded_by = np.arange(n, dtype=np.int64)
    if n == 0:
        return superseded_by.astype(np.int32)
    tol = max(tolerance, 1e-12)

    # gather edge nodes of every zone with their (zone, fast j, slow k) index
    edge_idx, edge_zone, edge_j, edge_k, zone_dims = [], [], [], [], []
    base = 0
    for z, dims in enumerate(grid.sz):
        jmax, kmax = int(dims[0]), int(dims[1])  # j = fast dimension
        zone_dims.append((jmax, kmax))
        jj, kk = np.meshgrid(np.arange(jmax), np.arange(kmax), indexing="ij")
        edge = (jj == 0) | (jj == jmax - 1) | (kk == 0) | (kk == kmax - 1)
        j_e, k_e = jj[edge], kk[edge]
        edge_idx.append(base + k_e * jmax + j_e)
        edge_zone.append(np.full(j_e.shape, z))
        edge_j.append(j_e)
        edge_k.append(k_e)
        base += jmax * kmax
    edge_idx = np.concatenate(edge_idx)
    edge_zone = np.concatenate(edge_zone)
    edge_j = np.concatenate(edge_j)
    edge_k = np.concatenate(edge_k)
    pts = grid.xyz()[edge_idx]

    tree = cKDTree(pts)
    pairs = tree.query_pairs(r=tol, output_type="ndarray")
    if pairs.size == 0:
        return superseded_by.astype(np.int32)
    a, b = pairs[:, 0], pairs[:, 1]
    same_zone = edge_zone[a] == edge_zone[b]
    jmaxs = np.array([d[0] for d in zone_dims])
    kmaxs = np.array([d[1] for d in zone_dims])
    zja, zka = jmaxs[edge_zone[a]], kmaxs[edge_zone[a]]
    wrap_k = (
        (edge_j[a] == edge_j[b])
        & (np.minimum(edge_k[a], edge_k[b]) == 0)
        & (np.maximum(edge_k[a], edge_k[b]) == zka - 1)
    )
    wrap_j = (
        (edge_k[a] == edge_k[b])
        & (np.minimum(edge_j[a], edge_j[b]) == 0)
        & (np.maximum(edge_j[a], edge_j[b]) == zja - 1)
    )
    ok = (~same_zone) | wrap_k | wrap_j
    na, nb = edge_idx[a[ok]], edge_idx[b[ok]]

    # lowest direct partner per node
    lo = np.minimum(na, nb)
    hi = np.maximum(na, nb)
    partner_min = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(partner_min, hi, lo)
    np.minimum.at(partner_min, lo, hi)  # partners are symmetric
    has_partner = partner_min < np.iinfo(np.int64).max
    direct = np.where(
        has_partner & (partner_min < superseded_by), partner_min, superseded_by
    )

    # resolve chains (sol[alt] = sol[curr] applied in ascending key order):
    # iterate pointer-jumping until fixed point; superseded_by always points
    # to a strictly lower index so this terminates quickly
    prev = None
    cur = direct
    while prev is None or not np.array_equal(prev, cur):
        prev = cur
        cur = cur[cur]
    return cur.astype(np.int32)


def from_struct_grid(
    grid: StructGrid, tolerance: float = 0.0
) -> SurfaceModel:
    """Build a SurfaceModel from a PLOT3D structured grid.

    ``tolerance`` is the overlap tolerance (GRID_TOLERANCE from the tgts
    header); nodes closer than this collapse into one data node.
    """
    vertices = grid.xyz()
    triangles = grid.triangles()
    normals = _node_normals_from_quads(vertices, grid)
    superseded_by = find_overlapping_nodes(grid, tolerance)
    is_datanode = superseded_by == np.arange(vertices.shape[0], dtype=np.int32)
    return SurfaceModel(
        vertices=vertices,
        triangles=triangles,
        normals=normals,
        components=grid.zones.astype(np.int32),
        is_datanode=is_datanode,
        superseded_by=superseded_by,
        grid=grid,
    )


def from_tri_mesh(mesh: TriMesh) -> SurfaceModel:
    """Build a SurfaceModel from a Cart3D unstructured mesh."""
    vertices = mesh.vertices.astype(np.float32)
    triangles = mesh.triangles.astype(np.int32)
    normals = _node_normals_from_tris(vertices, triangles)
    n = vertices.shape[0]
    if mesh.components is not None:
        # per-node primary component: first triangle touching the node wins.
        # Vectorized: write slots in reverse (t, k) order so the earliest
        # occurrence lands last — O(T) instead of a 20M-iteration Python loop
        # at campaign scale.
        comp = np.zeros(n, np.int32)
        flat_nodes = triangles.reshape(-1)[::-1]
        comp[flat_nodes] = np.repeat(
            np.asarray(mesh.components, np.int32), 3
        )[::-1]
    else:
        comp = np.zeros(n, np.int32)
    return SurfaceModel(
        vertices=vertices,
        triangles=triangles,
        normals=normals,
        components=comp,
        is_datanode=np.ones(n, bool),
        superseded_by=np.arange(n, dtype=np.int32),
    )


def load_model(path: str, tolerance: float = 0.0) -> SurfaceModel:
    """Load a surface model from a .grid/.g/.x (PLOT3D) or .tri/.triq file."""
    lower = path.lower()
    if lower.endswith(".triq"):
        from upsp_tpu.io.cart3d import read_triq

        return from_tri_mesh(read_triq(path))
    if lower.endswith((".tri", ".i.tri")):
        from upsp_tpu.io.cart3d import read_tri

        return from_tri_mesh(read_tri(path))
    from upsp_tpu.io.plot3d import read_p3d_grid

    return from_struct_grid(read_p3d_grid(path), tolerance)
