"""Batched RANSAC PnP: camera pose from 3D-2D correspondences.

Functional replacement for the reference's PnPsolver (PnPsolver.cc, 1029 LoC
EPnP + sequential RANSAC, used by relocalization Tracking.cc:1015). Design
deviation, deliberately accelerator-first: instead of EPnP's 4-point minimal solve
(control points + Gauss-Newton on betas — branchy and hard to batch), every
hypothesis solves the 6-point DLT system — a single 12x12 symmetric eigh,
identical in shape across hypotheses, so ALL RANSAC iterations run as one
batched kernel. 6-point samples need more iterations for the same outlier
rate, but 256 batched hypotheses cost less on the device than 300 sequential
4-point EPnP solves cost on a CPU (the reference's own budget,
SetRansacParameters(0.99, 10, 300, 4, 0.5, 5.991), Tracking.cc:1015).
The final pose is re-fit on all inliers and polished by the caller's LM
pose optimization, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3

ITERS = 256
SAMPLE = 6
CHI2 = 5.991


class PnPResult(NamedTuple):
    success: jnp.ndarray  # bool
    Tcw: jnp.ndarray  # [4, 4]
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray  # int32


def _dlt_pose(X: jnp.ndarray, uv_n: jnp.ndarray) -> jnp.ndarray:
    """[s, 3] world points + [s, 2] NORMALIZED image coords -> [3, 4] pose
    (up to scale/orthogonality, fixed afterwards). Batched by vmap."""
    s = X.shape[0]
    ones = jnp.ones((s, 1), X.dtype)
    Xh = jnp.concatenate([X, ones], axis=1)  # [s, 4]
    zero = jnp.zeros_like(Xh)
    u = uv_n[:, 0:1]
    v = uv_n[:, 1:2]
    rows_u = jnp.concatenate([Xh, zero, -u * Xh], axis=1)  # [s, 12]
    rows_v = jnp.concatenate([zero, Xh, -v * Xh], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)  # [2s, 12]
    AtA = A.T @ A
    _, vecs = jnp.linalg.eigh(AtA)
    P = vecs[:, 0].reshape(3, 4)
    return P


def _pose_from_P(P: jnp.ndarray, X_ref: jnp.ndarray) -> jnp.ndarray:
    """Orthogonalize the DLT [3, 4] into SE3, fixing scale and cheirality
    with a reference world point (sample centroid)."""
    M = P[:, :3]
    scale = jnp.cbrt(jnp.abs(jnp.linalg.det(M)) + 1e-12)
    sign_z = jnp.sign(M[2] @ X_ref + P[2, 3])  # depth of reference point
    P = P * (sign_z / scale)
    R = se3.normalize_rotation(P[:, :3])
    return se3.from_Rt(R, P[:, 3])


def solve_pnp(
    points: jnp.ndarray,
    uv: jnp.ndarray,
    sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    intr: jnp.ndarray,
    key: jnp.ndarray,
    min_inliers: int = 10,
) -> PnPResult:
    """RANSAC pose solve from [N, 3] world points and [N, 2] undistorted
    pixels (valid-masked). Deterministic under the given key."""
    n = points.shape[0]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    uv_n = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], axis=-1)

    g = jax.random.gumbel(key, (ITERS, n))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, SAMPLE)  # [I, s]

    P = jax.vmap(_dlt_pose)(points[idx], uv_n[idx])  # [I, 3, 4]
    centroids = jnp.mean(points[idx], axis=1)  # [I, 3]
    T = jax.vmap(_pose_from_P)(P, centroids)  # [I, 4, 4]

    # Score every hypothesis against all correspondences.
    pc = se3.transform(T[:, None], jnp.broadcast_to(points[None], (ITERS, n, 3)))
    z = jnp.where(jnp.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
    pu = fx * pc[..., 0] / z + cx
    pv = fy * pc[..., 1] / z + cy
    err = ((pu - uv[None, :, 0]) ** 2 + (pv - uv[None, :, 1]) ** 2) / jnp.clip(
        sigma2[None, :], 1e-8, None
    )
    inl = (err < CHI2) & (pc[..., 2] > 0) & valid[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)

    # Refit on the best hypothesis's inliers (weighted full DLT).
    best_inl = inl[best]
    w = best_inl.astype(points.dtype)

    def weighted_dlt():
        ones = jnp.ones((n, 1), points.dtype)
        Xh = jnp.concatenate([points, ones], axis=1)
        zero = jnp.zeros_like(Xh)
        u = uv_n[:, 0:1]
        v = uv_n[:, 1:2]
        rows_u = jnp.concatenate([Xh, zero, -u * Xh], axis=1) * w[:, None]
        rows_v = jnp.concatenate([zero, Xh, -v * Xh], axis=1) * w[:, None]
        A = jnp.concatenate([rows_u, rows_v], axis=0)
        _, vecs = jnp.linalg.eigh(A.T @ A)
        Pr = vecs[:, 0].reshape(3, 4)
        cen = jnp.sum(points * w[:, None], axis=0) / jnp.clip(jnp.sum(w), 1.0, None)
        return _pose_from_P(Pr, cen)

    T_ref = weighted_dlt()
    # Re-score the refined pose.
    pc2 = se3.transform(T_ref, points)
    z2 = jnp.where(jnp.abs(pc2[..., 2]) < 1e-8, 1e-8, pc2[..., 2])
    err2 = (
        (fx * pc2[..., 0] / z2 + cx - uv[..., 0]) ** 2
        + (fy * pc2[..., 1] / z2 + cy - uv[..., 1]) ** 2
    ) / jnp.clip(sigma2, 1e-8, None)
    inl2 = (err2 < CHI2) & (pc2[..., 2] > 0) & valid
    use_refined = jnp.sum(inl2) >= counts[best]
    T_out = jnp.where(use_refined, T_ref, T[best])
    inl_out = jnp.where(use_refined, inl2, best_inl)
    n_out = jnp.sum(inl_out)
    return PnPResult(
        success=n_out >= min_inliers,
        Tcw=T_out,
        inliers=inl_out,
        n_inliers=n_out.astype(jnp.int32),
    )
