"""Two-view triangulation: batched DLT + parallax / cheirality validation.

Re-expresses the reference's two triangulators — Initializer::Triangulate
(Initializer.cc:735-751, 4x4 SVD DLT) and KeyFrameTriangulacion
(KeyFrameTriangulacion.cc:35-130: unit rays, parallax cosine, behind-camera,
reprojection-chi2 and scale-consistency checks, quasi-infinity routing for
low-parallax "far points") — as one batched, vmappable kernel.  The per-match
C++ loop becomes a single [N]-wide program: every candidate match is
triangulated and validated in parallel, invalid lanes are masked.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import se3

# Distance at which a low-parallax landmark is frozen "at quasi-infinity"
# (reference uses ray * 1e8, KeyFrameTriangulacion / LocalMapping.cc:259-291).
QINF_DISTANCE = 1e8


def triangulate_dlt(P1: jnp.ndarray, P2: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Linear (DLT) triangulation.

    P1, P2: (..., 3, 4) projection matrices (K [R|t] on undistorted coords,
    or bare [R|t] when x are normalized coords).
    x1, x2: (..., 2) point coordinates in the respective images.
    Returns (..., 3) triangulated points in world/homogeneous frame.

    Inhomogeneous DLT: fix the homogeneous coordinate w = 1 and solve the
    3x3 normal equations B X = -b (B = A[:, :3], b = A[:, 3]) by Cramer's
    rule — pure elementwise arithmetic. The reference solves the 4x4
    homogeneous system by SVD (vt.row(3), Initializer.cc:742-750); the
    difference only matters for points AT infinity (w -> 0), which every
    caller rejects anyway (parallax/cheirality gates; low-parallax far
    points are routed along rays, not through this solve). A batched 4x4
    eigh here was an iterative eigensolver per keyframe event, far slower
    than these elementwise products on the accelerator the system was first
    built on (not measured on the GPU).
    """
    rows = jnp.stack(
        [
            x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        axis=-2,
    )  # (..., 4, 4)
    B = rows[..., :3]  # (..., 4, 3)
    b = rows[..., 3]  # (..., 4)
    G = jnp.swapaxes(B, -1, -2) @ B  # (..., 3, 3) Gram matrix
    rhs = -jnp.einsum("...ri,...r->...i", B, b)  # (..., 3)
    # Cramer via the adjugate (all elementwise; no LU, no eigh).
    c00 = G[..., 1, 1] * G[..., 2, 2] - G[..., 1, 2] * G[..., 2, 1]
    c01 = G[..., 0, 2] * G[..., 2, 1] - G[..., 0, 1] * G[..., 2, 2]
    c02 = G[..., 0, 1] * G[..., 1, 2] - G[..., 0, 2] * G[..., 1, 1]
    c10 = G[..., 1, 2] * G[..., 2, 0] - G[..., 1, 0] * G[..., 2, 2]
    c11 = G[..., 0, 0] * G[..., 2, 2] - G[..., 0, 2] * G[..., 2, 0]
    c12 = G[..., 0, 2] * G[..., 1, 0] - G[..., 0, 0] * G[..., 1, 2]
    c20 = G[..., 1, 0] * G[..., 2, 1] - G[..., 1, 1] * G[..., 2, 0]
    c21 = G[..., 0, 1] * G[..., 2, 0] - G[..., 0, 0] * G[..., 2, 1]
    c22 = G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
    det = (
        G[..., 0, 0] * c00 + G[..., 0, 1] * c10 + G[..., 0, 2] * c20
    )
    safe_det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )  # (..., 3, 3)
    return jnp.einsum("...ij,...j->...i", adj, rhs) / safe_det[..., None]


class TriangulationCheck(NamedTuple):
    """Validation outcome for a batch of candidate triangulations."""

    points: jnp.ndarray  # (..., 3) world points (possibly pushed to q-infinity)
    valid: jnp.ndarray  # (...,) bool: accepted as a regular map point
    far: jnp.ndarray  # (...,) bool: low-parallax, routed to quasi-infinity
    parallax_cos: jnp.ndarray  # (...,) cosine of ray parallax


def parallax_cosine(Tcw1: jnp.ndarray, Tcw2: jnp.ndarray, xw: jnp.ndarray) -> jnp.ndarray:
    """Cosine of the angle between the rays from both camera centers to xw."""
    O1 = se3.camera_center(Tcw1)
    O2 = se3.camera_center(Tcw2)
    r1 = xw - O1[..., None, :] if xw.ndim > O1.ndim else xw - O1
    r2 = xw - O2[..., None, :] if xw.ndim > O2.ndim else xw - O2
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    denom = jnp.where(n1 * n2 < 1e-12, 1e-12, n1 * n2)
    return jnp.sum(r1 * r2, axis=-1) / denom


def validate(
    Tcw1: jnp.ndarray,
    Tcw2: jnp.ndarray,
    xw: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    project1,
    project2,
    sigma2_1: jnp.ndarray,
    sigma2_2: jnp.ndarray,
    rays1: jnp.ndarray | None = None,
    cos_far_threshold: float = 0.9998,
    chi2_threshold: float = 5.991,
    enable_far_points: bool = False,
) -> TriangulationCheck:
    """Validate a batch of triangulated world points between two views.

    Mirrors the acceptance logic of LocalMapping::CreateNewMapPoints
    (LocalMapping.cc:243-314): positive depth in both cameras, reprojection
    error under chi2 * sigma^2 per level in both images, and a parallax gate.
    Low-parallax candidates are optionally re-routed to quasi-infinity along
    the first view's ray (the os1 "puntos lejanos" experiment).

    project1/project2: callables mapping camera-frame (..., 3) -> pixel (..., 2).
    sigma2_*: per-point squared scale factor of the detection octave.
    rays1: optional (..., 3) unit rays (world frame) from camera 1, used to
      place far points; required when enable_far_points.
    """
    pc1 = se3.transform(Tcw1, xw)
    pc2 = se3.transform(Tcw2, xw)
    pos_depth = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)

    e1 = project1(pc1) - uv1
    e2 = project2(pc2) - uv2
    chi1 = jnp.sum(e1 * e1, axis=-1) / jnp.clip(sigma2_1, 1e-8, None)
    chi2_ = jnp.sum(e2 * e2, axis=-1) / jnp.clip(sigma2_2, 1e-8, None)
    reproj_ok = (chi1 < chi2_threshold) & (chi2_ < chi2_threshold)

    cosp = parallax_cosine(Tcw1, Tcw2, xw)
    good_parallax = cosp < cos_far_threshold

    valid = pos_depth & reproj_ok & good_parallax

    far = jnp.zeros_like(valid)
    points = xw
    if enable_far_points and rays1 is not None:
        O1 = se3.camera_center(Tcw1)
        far_pts = O1 + rays1 * QINF_DISTANCE
        far = pos_depth & reproj_ok & (~good_parallax)
        points = jnp.where(far[..., None], far_pts, xw)

    return TriangulationCheck(points=points, valid=valid, far=far, parallax_cos=cosp)


def median_depth(Tcw: jnp.ndarray, points: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median scene depth of masked points in camera frame.

    Used for monocular map-scale normalization at initialization
    (Tracking::CreateInitialMapMonocular, Tracking.cc:473-497 /
    KeyFrame::ComputeSceneMedianDepth, KeyFrame.cc:683-714).
    Masked entries are pushed to +inf and ignored by taking the
    (count/2)-th order statistic of the sorted depths.
    """
    z = se3.transform(Tcw, points)[..., 2]
    z = jnp.where(mask, z, jnp.inf)
    z_sorted = jnp.sort(z, axis=-1)
    n = jnp.sum(mask, axis=-1)
    idx = jnp.clip((n - 1) // 2, 0, z.shape[-1] - 1)
    return jnp.take_along_axis(z_sorted, idx[..., None], axis=-1)[..., 0]
