"""Pose estimation: robust PnP as batched Gauss-Newton + vectorized RANSAC.

Replaces ``cv2.solvePnPRansac(useExtrinsicGuess=True)``
(external_calibrate.py:1140 — studied, not copied) with a batched design:

- :func:`refine_pose` — fixed-iteration Levenberg–Marquardt on the 6-DOF
  reprojection residual, Jacobians via ``jax.jacfwd`` of the camera model.
- :func:`solve_pnp_ransac` — N hypotheses refined *in parallel* under ``vmap``
  (each from a random minimal subset, initialized at the pose guess), inlier
  counting at the reprojection threshold, winner refined on its consensus set.

The wind-tunnel problem always has a good initial pose (wind-off + tunnel
transform), which is why the reference runs ITERATIVE PnP with an extrinsic
guess; the RANSAC wrapper only rejects bad detections.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from upsp_tpu.camera.model import (
    CameraParams,
    project_points,
    rodrigues,
)


class PnPResult(NamedTuple):
    rvec: jax.Array  # (3,)
    tvec: jax.Array  # (3,)
    inliers: jax.Array  # (N,) bool
    rms: jax.Array  # () inlier reprojection RMS


def _residuals(pose6, params: CameraParams, obj_pts, img_pts, weights):
    p = params._replace(rvec=pose6[:3], tvec=pose6[3:6])
    proj = project_points(p, obj_pts)
    return ((proj - img_pts) * weights[:, None]).ravel()


@functools.partial(jax.jit, static_argnames=("n_iters",))
def refine_pose(
    params: CameraParams,
    obj_pts: jax.Array,  # (N, 3)
    img_pts: jax.Array,  # (N, 2)
    weights: jax.Array,  # (N,) 0/1 mask or weights
    n_iters: int = 20,
) -> Tuple[jax.Array, jax.Array]:
    """LM refinement of (rvec, tvec) from the params' current pose."""
    pose0 = jnp.concatenate([params.rvec, params.tvec])

    def r_fn(p6):
        return _residuals(p6, params, obj_pts, img_pts, weights)

    jac = jax.jacfwd(r_fn)

    def body(carry, _):
        pose, lam = carry
        r = r_fn(pose)
        J = jac(pose)
        JTJ = J.T @ J
        g = J.T @ r
        A = JTJ + lam * jnp.diag(jnp.maximum(jnp.diag(JTJ), 1e-10))
        dp = jnp.linalg.solve(A, g)
        new_pose = pose - dp
        improved = jnp.sum(r_fn(new_pose) ** 2) < jnp.sum(r * r)
        pose = jnp.where(improved, new_pose, pose)
        lam = jnp.clip(jnp.where(improved, lam * 0.3, lam * 5.0), 1e-10, 1e6)
        return (pose, lam), None

    (pose, _), _ = jax.lax.scan(body, (pose0, jnp.asarray(1e-3, pose0.dtype)),
                                None, length=n_iters)
    return pose[:3], pose[3:6]


@functools.partial(
    jax.jit, static_argnames=("n_hypotheses", "sample_size", "n_iters")
)
def solve_pnp_ransac(
    params: CameraParams,
    obj_pts: jax.Array,  # (N, 3)
    img_pts: jax.Array,  # (N, 2)
    valid: jax.Array,  # (N,) bool — padded entries False
    key: jax.Array,
    reproj_threshold: float = 6.0,
    n_hypotheses: int = 64,
    sample_size: int = 4,
    n_iters: int = 15,
) -> PnPResult:
    """Vectorized RANSAC PnP from an extrinsic guess (the params' pose)."""
    N = obj_pts.shape[0]
    vmask = valid.astype(obj_pts.dtype)

    def one_hypothesis(k):
        # random minimal subset of valid points
        scores = jax.random.uniform(k, (N,)) + (~valid) * 10.0
        idx = jnp.argsort(scores)[:sample_size]
        w = jnp.zeros(N, obj_pts.dtype).at[idx].set(1.0) * vmask
        rv, tv = refine_pose(params, obj_pts, img_pts, w, n_iters=n_iters)
        p = params._replace(rvec=rv, tvec=tv)
        err = jnp.linalg.norm(project_points(p, obj_pts) - img_pts, axis=1)
        inl = (err < reproj_threshold) & valid
        return inl.sum(), rv, tv

    keys = jax.random.split(key, n_hypotheses)
    counts, rvs, tvs = jax.vmap(one_hypothesis)(keys)

    # the extrinsic guess itself competes as a hypothesis (refined on all pts)
    rv0, tv0 = refine_pose(params, obj_pts, img_pts, vmask, n_iters=n_iters)
    p0 = params._replace(rvec=rv0, tvec=tv0)
    err0 = jnp.linalg.norm(project_points(p0, obj_pts) - img_pts, axis=1)
    inl0 = (err0 < reproj_threshold) & valid
    counts = jnp.concatenate([counts, inl0.sum()[None]])
    rvs = jnp.concatenate([rvs, rv0[None]])
    tvs = jnp.concatenate([tvs, tv0[None]])

    best = jnp.argmax(counts)
    p_best = params._replace(rvec=rvs[best], tvec=tvs[best])
    err = jnp.linalg.norm(project_points(p_best, obj_pts) - img_pts, axis=1)
    inliers = (err < reproj_threshold) & valid

    # final polish on the consensus set
    rv, tv = refine_pose(
        params._replace(rvec=rvs[best], tvec=tvs[best]),
        obj_pts, img_pts, inliers.astype(obj_pts.dtype), n_iters=n_iters,
    )
    p_fin = params._replace(rvec=rv, tvec=tv)
    err = jnp.linalg.norm(project_points(p_fin, obj_pts) - img_pts, axis=1)
    inliers = (err < reproj_threshold) & valid
    n_in = jnp.maximum(inliers.sum(), 1)
    rms = jnp.sqrt(jnp.sum(jnp.where(inliers, err * err, 0.0)) / n_in)
    return PnPResult(rvec=rv, tvec=tv, inliers=inliers, rms=rms)


def solve_pnp(
    rmat_init: np.ndarray,
    tvec_init: np.ndarray,
    camera_matrix: np.ndarray,
    dist_coeffs: np.ndarray,
    obj_pts: np.ndarray,
    img_pts: np.ndarray,
    reproj_threshold: float = 6.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Host-friendly wrapper: arrays in, (rmat, tvec, inlier_idx, rms) out."""
    from upsp_tpu.camera.model import make_camera_params

    params = make_camera_params(rmat_init, tvec_init, camera_matrix, dist_coeffs)
    n = obj_pts.shape[0]
    res = solve_pnp_ransac(
        params,
        jnp.asarray(obj_pts, jnp.float64),
        jnp.asarray(img_pts, jnp.float64),
        jnp.ones(n, bool),
        jax.random.PRNGKey(seed),
        reproj_threshold=reproj_threshold,
    )
    rmat = np.array(rodrigues(res.rvec))
    return (
        rmat,
        np.array(res.tvec).reshape(3, 1),
        np.nonzero(np.array(res.inliers))[0],
        float(res.rms),
    )
