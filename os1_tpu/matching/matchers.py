"""Matcher variants: thin compositions of the core gated matcher that
reproduce the candidate-generation rules of the reference's ORBmatcher.

Each function maps to a reference entry point (cited); all operate on
fixed-shape masked arrays and are jit-safe.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..features.orb import FrameFeatures
from . import core


def search_for_initialization(
    f1: FrameFeatures,
    f2: FrameFeatures,
    window: float = 100.0,
    ratio: float = 0.9,
    max_dist: int = core.TH_LOW,
) -> core.MatchResult:
    """Window search between the two bootstrap frames
    (ORBmatcher::SearchForInitialization, ORBmatcher.cc:400-515: level-0
    features only, search window around the previous position, ratio test,
    mutual uniqueness, rotation histogram)."""
    gate = core.window_gate(f1.xy, f2.xy, window, f1.valid, f2.valid)
    gate &= (f1.octave[:, None] == 0) & (f2.octave[None, :] == 0)
    res = core.match_with_gate(f1.desc, f2.desc, gate, max_dist, ratio)
    res = core.mutual_best(res, f2.desc.shape[0])
    return core.rotation_consistency(f1.angle, f2.angle, res)


def search_by_projection(
    point_desc: jnp.ndarray,
    point_uv: jnp.ndarray,
    point_valid: jnp.ndarray,
    point_octave: jnp.ndarray,
    feats: FrameFeatures,
    radius: jnp.ndarray,
    ratio: float = 0.8,
    max_dist: int = core.TH_HIGH,
    octave_lo: int = -1,
    octave_hi: int = 1,
    unique: bool = True,
) -> core.MatchResult:
    """Generic "project-and-match": map points (or last-frame points) with
    predicted image positions + octaves are matched to frame features inside
    a per-point radius window and an octave band.

    Covers ORBmatcher::SearchByProjection for the local map
    (ORBmatcher.cc:45-125, radius scaled by predicted octave and view angle)
    and for the last frame (ORBmatcher.cc:1292-1423) — the caller chooses
    radius/octave parameters.

    point_uv: [P, 2] predicted pixel positions; radius: [P] or scalar pixels.
    Returns a match per point into feats.
    """
    gate = core.window_gate(point_uv, feats.xy, radius, point_valid, feats.valid)
    gate &= core.octave_gate(point_octave, feats.octave, octave_lo, octave_hi)
    res = core.match_with_gate(point_desc, feats.desc, gate, max_dist, ratio)
    if unique:
        res = core.mutual_best(res, feats.desc.shape[0])
    return res


def predicted_octave(
    dist: jnp.ndarray, max_dist_point: jnp.ndarray, scale_factor: float, n_levels: int
) -> jnp.ndarray:
    """Predict the detection octave of a map point from its current distance
    (reference MapPoint::PredictScale, MapPoint.cc:370-379)."""
    ratio = jnp.clip(max_dist_point / jnp.clip(dist, 1e-6, None), 1e-6, None)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


def compute_f12(T1w: jnp.ndarray, T2w: jnp.ndarray, K1: jnp.ndarray, K2: jnp.ndarray) -> jnp.ndarray:
    """Fundamental matrix between two views from their world poses
    (LocalMapping::ComputeF12, LocalMapping.cc:449-477):
    F = K1^-T [t12]x R12 K2^-1 with T12 = T1w * T2w^-1."""
    R1, t1 = T1w[:3, :3], T1w[:3, 3]
    R2, t2 = T2w[:3, :3], T2w[:3, 3]
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    tx = jnp.array(
        [
            [0.0, -t12[2], t12[1]],
            [t12[2], 0.0, -t12[0]],
            [-t12[1], t12[0], 0.0],
        ]
    )
    K1invT = jnp.linalg.inv(K1).T
    K2inv = jnp.linalg.inv(K2)
    return K1invT @ tx @ R12 @ K2inv


def epipolar_gate(
    xy1: jnp.ndarray,
    xy2: jnp.ndarray,
    F12: jnp.ndarray,
    sigma2_2: jnp.ndarray,
    epipole2: jnp.ndarray | None = None,
    sigma2_1: jnp.ndarray | None = None,
    chi2: float = 3.84,
) -> jnp.ndarray:
    """[N1, N2] gate: feature pairs consistent with the epipolar geometry
    (ORBmatcher::CheckDistEpipolarLine, ORBmatcher.cc:135-152: squared
    point-line distance < 3.84 * sigma2 of the second feature's octave).

    Optionally rejects candidates too close to the epipole in image 2 — the
    reference's guard against triangulating along the baseline
    (LocalMapping::CreateNewMapPoints epipole check, LocalMapping.cc:243+).
    """
    ones1 = jnp.ones_like(xy1[:, :1])
    x1h = jnp.concatenate([xy1, ones1], axis=1)  # [N1, 3]
    # Constraint x1^T F12 x2 = 0 => the line in image 2 is F12^T x1,
    # whose coefficients are the rows of x1h @ F12.
    lines = x1h @ F12  # [N1, 3]
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * xy2[None, :, :][..., 0] + b * xy2[None, :, :][..., 1] + c
    den = a * a + b * b
    dsq = (num * num) / jnp.clip(den, 1e-12, None)
    ok = dsq < chi2 * sigma2_2[None, :]
    if epipole2 is not None and sigma2_1 is not None:
        de = jnp.sum((xy2 - epipole2[None, :]) ** 2, axis=-1)
        ok &= de[None, :] > 100.0 * sigma2_1[:, None]
    return ok


def search_for_triangulation(
    f1: FrameFeatures,
    f2: FrameFeatures,
    F12: jnp.ndarray,
    sigma2_per_octave: jnp.ndarray,
    epipole2: jnp.ndarray | None = None,
    unmatched1: jnp.ndarray | None = None,
    unmatched2: jnp.ndarray | None = None,
    ratio: float = 0.75,
    max_dist: int = core.TH_LOW,
) -> core.MatchResult:
    """Epipolar-constrained matching of yet-unmatched features between two
    keyframes, for new-point triangulation (ORBmatcher::SearchForTriangulation,
    ORBmatcher.cc:652-804; the reference prunes candidates with BoW buckets
    purely for CPU speed — on the device the full gated matrix is the fast
    path).

    unmatched1/unmatched2: bool masks of features not yet bound to map points.
    """
    s2_1 = sigma2_per_octave[f1.octave]
    s2_2 = sigma2_per_octave[f2.octave]
    gate = f1.valid[:, None] & f2.valid[None, :]
    if unmatched1 is not None:
        gate &= unmatched1[:, None]
    if unmatched2 is not None:
        gate &= unmatched2[None, :]
    gate &= epipolar_gate(f1.xy, f2.xy, F12, s2_2, epipole2, s2_1)
    res = core.match_with_gate(f1.desc, f2.desc, gate, max_dist, ratio)
    res = core.mutual_best(res, f2.desc.shape[0])
    return core.rotation_consistency(f1.angle, f2.angle, res)


def fuse_candidates(
    point_desc: jnp.ndarray,
    point_uv: jnp.ndarray,
    point_valid: jnp.ndarray,
    point_octave: jnp.ndarray,
    feats: FrameFeatures,
    radius_scale: jnp.ndarray,
    max_dist: int = core.TH_LOW,
) -> core.MatchResult:
    """Find, for each projected map point, a duplicate feature in a target
    keyframe (ORBmatcher::Fuse, ORBmatcher.cc:806-1064: radius 3 * scale of
    predicted octave, best distance <= TH_LOW, no ratio test)."""
    radius = 3.0 * radius_scale
    gate = core.window_gate(point_uv, feats.xy, radius, point_valid, feats.valid)
    gate &= core.octave_gate(point_octave, feats.octave, -1, 1)
    res = core.match_with_gate(point_desc, feats.desc, gate, max_dist, ratio=1.0)
    return core.mutual_best(res, feats.desc.shape[0])
