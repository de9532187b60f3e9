"""Ray-triangle intersection against the flattened BVH — pure JAX, vmappable.

The reference traverses a pointer BVH per ray on the CPU
(cpp/raycast/pspRT.cpp — studied, not copied).  Here rays are a *batch*: a
stackless escape-link walk runs inside ``lax.while_loop``, vmapped over rays, so
XLA executes all rays in lockstep with gathers instead of pointer chasing.
Möller–Trumbore triangle intersection; leaf triangles are tested in a masked
fixed-size block.

Raycasting only runs in Phase 0 / calibration, so the throughput target is
modest; correctness and batch-friendliness dominate the design.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from upsp_tpu.geometry.bvh import FlatBVH


class BVHArrays(NamedTuple):
    """Device-resident flattened BVH.

    Leaf triangles are stored *per node*, padded to the max leaf size, so the
    traversal loop only ever gathers with the scalar node index — the same
    access pattern as the bbox arrays.  (A vector-indexed gather of the global
    triangle table inside the vmapped while_loop can lower to a
    rays x tris x 3 intermediate.)  Memory cost: ~2x the triangle soup.
    """

    bbox_min: jax.Array  # (M, 3)
    bbox_max: jax.Array  # (M, 3)
    escape: jax.Array  # (M,)
    leaf_count: jax.Array  # (M,) 0 for internal nodes
    leaf_v0: jax.Array  # (M, L, 3)
    leaf_e1: jax.Array  # (M, L, 3)
    leaf_e2: jax.Array  # (M, L, 3)
    leaf_tri_id: jax.Array  # (M, L) original triangle ids (-1 padding)

    @property
    def max_leaf(self) -> int:
        return int(self.leaf_v0.shape[1])


def bvh_to_device(bvh: FlatBVH, dtype=jnp.float32) -> BVHArrays:
    M = bvh.n_nodes
    L = max(bvh.max_leaf_count, 1)
    leaf_v0 = np.zeros((M, L, 3), np.float32)
    leaf_e1 = np.zeros((M, L, 3), np.float32)
    leaf_e2 = np.zeros((M, L, 3), np.float32)
    leaf_tri_id = np.full((M, L), -1, np.int32)
    counts = np.where(bvh.leaf_start >= 0, bvh.leaf_count, 0).astype(np.int64)
    leaves = np.nonzero(bvh.leaf_start >= 0)[0]
    slots = bvh.leaf_start[leaves][:, None] + np.arange(L)[None, :]  # (K, L)
    valid = np.arange(L)[None, :] < counts[leaves][:, None]
    safe = np.where(valid, slots, 0)
    leaf_v0[leaves] = bvh.tri_v0[safe] * valid[..., None]
    leaf_e1[leaves] = bvh.tri_e1[safe] * valid[..., None]
    leaf_e2[leaves] = bvh.tri_e2[safe] * valid[..., None]
    leaf_tri_id[leaves] = np.where(valid, bvh.tri_id[safe], -1)
    return BVHArrays(
        bbox_min=jnp.asarray(bvh.bbox_min, dtype),
        bbox_max=jnp.asarray(bvh.bbox_max, dtype),
        escape=jnp.asarray(bvh.escape),
        leaf_count=jnp.asarray(counts.astype(np.int32)),
        leaf_v0=jnp.asarray(leaf_v0, dtype),
        leaf_e1=jnp.asarray(leaf_e1, dtype),
        leaf_e2=jnp.asarray(leaf_e2, dtype),
        leaf_tri_id=jnp.asarray(leaf_tri_id),
    )


def watertight_intersect(origin, direction, v0, e1, e2, eps=1e-9):
    """Watertight ray-triangle intersection (Woop/Benthin/Wald scheme).

    The reference deliberately uses this formulation
    (cpp/raycast/pspRT.cpp:48-100, pbrt-v3 derived — behavior reimplemented,
    not copied): the ray is transformed so it travels +z, triangle vertices
    are sheared into that frame, and the 2-D edge functions are evaluated
    with consistent orientation.  A shared edge yields edge-function values
    of equal magnitude and opposite sign in its two triangles, so a ray
    through the edge registers in at least one of them — plain
    Möller–Trumbore can miss in BOTH (the `u >= 0 && v >= 0` tests fail on
    opposite sides by rounding), flipping a node invisible.  Boundary values
    (edge function exactly 0) count as hits.

    Batched over triangle rows: ``v0/e1/e2`` are (L, 3) with ``e1/e2`` the
    edge vectors (v1-v0, v2-v0) as stored in :class:`BVHArrays`.  Returns
    (t, valid) per row.  (pbrt re-evaluates exact-zero edge functions in
    double precision; at f32 the zero already counts as a hit here, which
    preserves the no-leak guarantee — only multi-hit tie-breaking differs.)
    """
    # permute so the dominant direction component becomes z
    ad = jnp.abs(direction)
    kz = jnp.argmax(ad)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    # preserve winding: swap x/y when the dominant component is negative
    neg = direction[kz] < 0.0
    kx, ky = (
        jnp.where(neg, ky, kx),
        jnp.where(neg, kx, ky),
    )
    perm = jnp.stack([kx, ky, kz])
    d = jnp.take(direction, perm)
    # translate to ray origin, permute
    A = jnp.take(v0 - origin, perm, axis=-1)
    B = jnp.take(v0 + e1 - origin, perm, axis=-1)
    C = jnp.take(v0 + e2 - origin, perm, axis=-1)
    # shear to make the ray (0, 0, 1)
    sz = 1.0 / d[2]
    sx = d[0] * sz
    sy = d[1] * sz
    ax = A[..., 0] - sx * A[..., 2]
    ay = A[..., 1] - sy * A[..., 2]
    bx = B[..., 0] - sx * B[..., 2]
    by = B[..., 1] - sy * B[..., 2]
    cx = C[..., 0] - sx * C[..., 2]
    cy = C[..., 1] - sy * C[..., 2]
    # 2-D edge functions; shared edges see the same values with opposite
    # sign in the neighboring triangle — the watertightness invariant.
    # CAVEAT: that negation is only bitwise when a*b - c*d is correctly
    # rounded; XLA contracts these into FMAs (measured: the same ray gives
    # exact 0 eagerly and ±1 ulp-of-product under jit), which can flip a
    # boundary value's sign differently in the two triangles and leak the
    # ray through BOTH.  A conservative tolerance of a few ulps of the
    # edge-function magnitude restores the no-leak guarantee for any
    # contraction the compiler picks; rays within the tolerance band may
    # hit both triangles instead of exactly one (harmless for closest-hit
    # and occlusion queries — same t).
    e0 = cx * by - cy * bx
    e1f = ax * cy - ay * cx
    e2f = bx * ay - by * ax
    tol = 4e-7 * (jnp.abs(e0) + jnp.abs(e1f) + jnp.abs(e2f))
    inside = ((e0 >= -tol) & (e1f >= -tol) & (e2f >= -tol)) | (
        (e0 <= tol) & (e1f <= tol) & (e2f <= tol)
    )
    det = e0 + e1f + e2f
    az = sz * A[..., 2]
    bz = sz * B[..., 2]
    cz = sz * C[..., 2]
    t_scaled = e0 * az + e1f * bz + e2f * cz
    # t and det must agree in sign (hit in front of the origin)
    sign = jnp.sign(det)
    valid = inside & (det != 0.0) & (t_scaled * sign > eps * jnp.abs(det))
    t = t_scaled / jnp.where(det == 0.0, 1.0, det)
    return t, valid


def moller_trumbore(origin, direction, v0, e1, e2, eps=1e-9):
    """Batched Möller–Trumbore: returns (t, valid) per triangle row."""
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > eps)
    )
    return t, valid


@functools.partial(jax.jit, static_argnames=("max_leaf", "intersector"))
def bvh_intersect(bvh: BVHArrays, origins, directions, max_leaf: int = 4,
                  intersector: str = "watertight"):
    """Closest-hit query for a batch of rays.

    origins/directions: (R, 3).  Returns (t (R,), prim_id (R,) original triangle
    index or -1, hit (R,) bool).

    ``intersector``: "watertight" (default — the reference's deliberate
    choice, pspRT.cpp:48-100: edge-grazing rays cannot leak between shared
    triangles) or "mt" (plain Möller–Trumbore — fewer ops per test, kept as
    the fast option for throughput-bound sweeps where leaks are absorbed by
    jittered retries).
    """
    tri_test = (
        watertight_intersect if intersector == "watertight" else moller_trumbore
    )
    M = bvh.bbox_min.shape[0]
    inf = jnp.asarray(jnp.inf, bvh.leaf_v0.dtype)
    origins = jnp.asarray(origins, bvh.leaf_v0.dtype)
    directions = jnp.asarray(directions, bvh.leaf_v0.dtype)

    def one_ray(origin, direction):
        inv_dir = jnp.where(
            jnp.abs(direction) > 1e-30, 1.0 / direction, jnp.sign(direction) * 1e30
        )
        inv_dir = jnp.where(direction == 0.0, 1e30, inv_dir)

        def cond(state):
            node, best_t, best_prim = state
            return node < M

        def body(state):
            node, best_t, best_prim = state
            bmin = bvh.bbox_min[node]
            bmax = bvh.bbox_max[node]
            t0 = (bmin - origin) * inv_dir
            t1 = (bmax - origin) * inv_dir
            tnear = jnp.max(jnp.minimum(t0, t1))
            tfar = jnp.min(jnp.maximum(t0, t1))
            box_hit = (tfar >= jnp.maximum(tnear, 0.0)) & (tnear < best_t)

            count = bvh.leaf_count[node]
            is_leaf = count > 0

            def test_leaf(bt, bp):
                # scalar node index only: no vector-indexed table gathers
                v0 = bvh.leaf_v0[node]
                e1 = bvh.leaf_e1[node]
                e2 = bvh.leaf_e2[node]
                ids = bvh.leaf_tri_id[node]
                mask = jnp.arange(v0.shape[0]) < count
                t, valid = tri_test(origin, direction, v0, e1, e2)
                t = jnp.where(valid & mask & (t < bt), t, inf)
                j = jnp.argmin(t)
                better = t[j] < bt
                bt = jnp.where(better, t[j], bt)
                bp = jnp.where(better, ids[j], bp)
                return bt, bp

            do_leaf = box_hit & is_leaf
            best_t, best_prim = jax.lax.cond(
                do_leaf, test_leaf, lambda bt, bp: (bt, bp), best_t, best_prim
            )
            descend = box_hit & (~is_leaf)
            nxt = jnp.where(descend, node + 1, bvh.escape[node])
            return nxt, best_t, best_prim

        init = (jnp.int32(0), inf, jnp.int32(-1))
        _, best_t, best_prim = jax.lax.while_loop(cond, body, init)
        return best_t, best_prim, best_prim >= 0

    return jax.vmap(one_ray)(origins, directions)


def brute_force_intersect(tri_v0, tri_e1, tri_e2, origins, directions):
    """O(R*T) oracle for tests; returns (t, prim, hit) with prim in slot order."""

    def one(origin, direction):
        t, valid = moller_trumbore(origin, direction, tri_v0, tri_e1, tri_e2)
        t = jnp.where(valid, t, jnp.inf)
        j = jnp.argmin(t)
        return t[j], jnp.where(jnp.isfinite(t[j]), j, -1), jnp.isfinite(t[j])

    return jax.vmap(one)(origins, directions)


@functools.partial(jax.jit, static_argnames=("max_leaf", "intersector"))
def bvh_any_hit_before(bvh: BVHArrays, origins, directions, t_max,
                       max_leaf: int = 4, intersector: str = "watertight"):
    """Occlusion query: does any triangle lie at t in (eps, t_max)?

    Used for target visibility (python/upsp/cam_cal_utils/visibility.py:392
    semantics: offset origins, ray toward the camera, any hit = occluded).
    """
    t, prim, hit = bvh_intersect(
        bvh, origins, directions, max_leaf=max_leaf, intersector=intersector
    )
    return hit & (t < t_max)


def node_visibility(
    bvh: BVHArrays,
    triangles: jax.Array,  # (T, 3) node indices per original tri id
    vertices: jax.Array,  # (N, 3)
    node_indices: jax.Array,  # (K,) nodes to test
    cam_center: jax.Array,  # (3,)
    max_leaf: int = 4,
    n_jitter: int = 6,
    jitter: float = 1e-4,
):
    """Per-node visibility using the reference's hit-triangle-contains-node test.

    A node is visible from the camera iff the closest hit of the ray
    camera->node lands on a triangle incident to that node; 6 axis-jittered
    retries absorb edge/vertex grazing (psp_process.cpp:270-295 semantics).
    Returns (visible (K,) bool, closest-hit prim (K,)).
    """
    pos = vertices[node_indices]

    def hits_own_tri(p, nidx):
        d = p - cam_center
        dist = jnp.linalg.norm(d)
        d = d / dist
        t, prim, hit = bvh_intersect(
            bvh, p[None] * 0 + cam_center[None], d[None], max_leaf=max_leaf
        )
        prim = prim[0]
        tri = triangles[jnp.maximum(prim, 0)]
        ok = hit[0] & jnp.any(tri == nidx)
        return ok, prim

    # vectorized primary pass
    d = pos - cam_center[None, :]
    dist = jnp.linalg.norm(d, axis=1, keepdims=True)
    dirs = d / dist
    origins = jnp.broadcast_to(cam_center, pos.shape)
    t, prim, hit = bvh_intersect(bvh, origins, dirs, max_leaf=max_leaf)
    tri_nodes = triangles[jnp.maximum(prim, 0)]
    visible = hit & jnp.any(tri_nodes == node_indices[:, None], axis=1)

    # jittered retries for nodes that failed (edge/vertex grazing)
    offsets = jnp.array(
        [
            [-jitter, 0, 0],
            [jitter, 0, 0],
            [0, -jitter, 0],
            [0, jitter, 0],
            [0, 0, -jitter],
            [0, 0, jitter],
        ],
        pos.dtype,
    )[:n_jitter]
    for k in range(n_jitter):
        pos_k = pos + offsets[k]
        dk = pos_k - cam_center[None, :]
        dk = dk / jnp.linalg.norm(dk, axis=1, keepdims=True)
        _, prim_k, hit_k = bvh_intersect(bvh, origins, dk, max_leaf=max_leaf)
        trik = triangles[jnp.maximum(prim_k, 0)]
        vis_k = hit_k & jnp.any(trik == node_indices[:, None], axis=1)
        visible = visible | vis_k
    return visible, prim


def oblique_cos_filter(normals, dirs, oblique_angle_deg):
    """Keep points whose surface faces the camera within the oblique limit.

    ``dirs`` are unit camera->point directions; the reference keeps a point when
    the angle between its normal and the ray exceeds ``180 - oblique_angle``
    degrees (psp_process.cpp:1606, getTargets) — i.e. the normal points back at
    the camera steeply enough.
    """
    thresh = jnp.cos(jnp.deg2rad(180.0 - oblique_angle_deg))
    cos_theta = jnp.sum(normals * dirs, axis=-1)
    # angle > thresh_angle  <=>  cos(angle) < cos(thresh_angle)
    return cos_theta < thresh
