"""Jitted device programs for the tracking FSM.

Each function is one fused XLA program covering what the reference does with
several scalar loops + a g2o solve per frame (Tracking.cc:123-342). The host
FSM (tracking.py) only moves small index arrays and scalars.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..matching import core as mcore
from ..matching import matchers
from ..optim import optimize_pose
from .frame import FrameData

NEG = jnp.int32(-1)


def _bind_features(n_feat: int, match: mcore.MatchResult, pt_slots: jnp.ndarray):
    """Invert a point->feature match into a per-feature binding array.

    Returns bind [n_feat] int32: local point slot per feature (-1 unbound).
    pt_slots: [P] the local slot ids (usually arange).
    """
    bind = jnp.full(n_feat, NEG)
    tgt = jnp.where(match.ok, match.idx, n_feat)  # invalid -> scratch slot
    bind = jnp.concatenate([bind, NEG[None]])  # scratch lane
    bind = bind.at[tgt].set(jnp.where(match.ok, pt_slots, NEG))
    return bind[:n_feat]


def _track_points_core(
    T0: jnp.ndarray,
    pt_xyz: jnp.ndarray,  # [P, 3]
    pt_desc: jnp.ndarray,  # [P, 8]
    pt_valid: jnp.ndarray,  # [P]
    pt_octave: jnp.ndarray,  # [P] reference octave (used when not use_frustum)
    pt_normal: jnp.ndarray,  # [P, 3]
    pt_min_dist: jnp.ndarray,  # [P]
    pt_max_dist: jnp.ndarray,  # [P]
    exclude_feat: jnp.ndarray,  # [N] bool: features already bound (skip)
    prev_xyz: jnp.ndarray,  # [N, 3] positions of already-bound points
    prev_bound: jnp.ndarray,  # [N] bool
    frame: FrameData,
    cam: cam_mod.Camera,
    intr: jnp.ndarray,
    base_radius: jnp.ndarray,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    use_frustum: bool = False,
    ratio: float = 0.8,
    max_dist: int = mcore.TH_HIGH,
    pose_opt_cfg: tuple = (4, 10, True),  # (rounds, iters/round, accept_reject)
):
    """Project candidate points into the frame, match, and pose-optimize.

    Covers TrackWithMotionModel (use_frustum=False: points carry their
    last-seen octave, Tracking.cc:594-651 + ORBmatcher.cc:1292) and
    TrackLocalMap's SearchLocalPoints (use_frustum=True: full isInFrustum
    gates + distance-predicted octave, Tracking.cc:781-826 + Frame.cc:151-207).

    Returns (T_opt, bind [N] local-slot per feature, inlier [N], n_inliers,
    visible [P] — frustum-visible mask for found/visible stats).
    """
    n_feat = frame.xy_un.shape[0]
    pc = se3.transform(T0, pt_xyz)
    depth = pc[..., 2]
    uv = cam_mod.project_ideal(cam, pc)
    visible = pt_valid & (depth > 0.05) & cam_mod.in_image(cam, uv, margin=1.0)

    if use_frustum:
        Ow = se3.camera_center(T0)
        po = pt_xyz - Ow
        dist = jnp.linalg.norm(po, axis=-1)
        # Scale-invariance band with the reference's 0.8/1.2 margins
        # (Frame::isInFrustum, Frame.cc:151-207).
        visible &= (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
        viewcos = jnp.sum(po * pt_normal, axis=-1) / jnp.clip(
            dist * jnp.linalg.norm(pt_normal, axis=-1), 1e-8, None
        )
        visible &= viewcos > 0.5
        octave = matchers.predicted_octave(dist, pt_max_dist, scale_factor, n_levels)
        # Reference: radius 2.5 when viewcos > 0.998 else 4.0 (ORBmatcher.cc:67).
        radius = jnp.where(viewcos > 0.998, 2.5 / 4.0, 1.0) * base_radius
    else:
        octave = pt_octave
        radius = base_radius

    scale_pow = jnp.asarray(scale_factor) ** octave.astype(jnp.float32)
    radius_px = radius * scale_pow

    res = matchers.search_by_projection(
        point_desc=pt_desc,
        point_uv=uv,
        point_valid=visible,
        point_octave=octave,
        feats=frame.feats._replace(xy=frame.xy_un, valid=frame.feats.valid & ~exclude_feat),
        radius=radius_px,
        ratio=ratio,
        max_dist=max_dist,
        octave_lo=-1 if use_frustum else 0,
        octave_hi=1,
    )
    slots = jnp.arange(pt_xyz.shape[0], dtype=jnp.int32)
    bind = _bind_features(n_feat, res, slots)
    new_bound = (bind >= 0) & ~prev_bound
    # Union of previous bindings (e.g. motion-model matches entering
    # TrackLocalMap, Tracking.cc:653-694) and fresh ones; pose is optimized
    # over all of them, as the reference's third PoseOptimization per frame.
    bound = new_bound | prev_bound
    pts_for_feat = jnp.where(
        new_bound[:, None], pt_xyz[jnp.clip(bind, 0, None)], prev_xyz
    )
    rounds, iters, ar = pose_opt_cfg
    opt = optimize_pose(
        T0, pts_for_feat, frame.xy_un, frame.sigma2, bound, intr,
        rounds=rounds, iters_per_round=iters, accept_reject=ar,
    )
    inlier = opt.inlier & bound
    bind = jnp.where(inlier & new_bound, bind, NEG)
    return opt.Tcw, bind, inlier, jnp.sum(inlier), visible


track_points = functools.partial(
    jax.jit, static_argnames=("use_frustum", "n_levels", "pose_opt_cfg")
)(_track_points_core)


def _track_reference_kf_core(
    T0: jnp.ndarray,
    kf_desc: jnp.ndarray,  # [N, 8] keyframe feature descriptors
    kf_bound: jnp.ndarray,  # [N] bool: feature has a map point
    kf_pt_xyz: jnp.ndarray,  # [N, 3] bound point position per kf feature
    kf_angle: jnp.ndarray,  # [N]
    frame: FrameData,
    intr: jnp.ndarray,
    pose_opt_cfg: tuple = (4, 10, True),
):
    """Descriptor-only matching against the reference keyframe + pose opt
    (TrackReferenceKeyFrame, Tracking.cc:540-582; the reference prunes with
    BoW buckets — ORBmatcher::SearchByBoW — purely as a CPU speedup, the
    dense gated matrix replaces it on the device).

    Returns (T_opt, bind [N_frame] -> kf feature index, inlier, n_inliers).
    """
    n_feat = frame.xy_un.shape[0]
    gate = frame.feats.valid[:, None] & kf_bound[None, :]
    res = mcore.match_with_gate(
        frame.feats.desc, kf_desc, gate, max_dist=mcore.TH_LOW, ratio=0.7
    )
    res = mcore.mutual_best(res, kf_desc.shape[0])
    res = mcore.rotation_consistency(frame.feats.angle, kf_angle, res)
    bound = res.ok
    pts_for_feat = kf_pt_xyz[jnp.clip(res.idx, 0, None)]
    rounds, iters, ar = pose_opt_cfg
    opt = optimize_pose(
        T0, pts_for_feat, frame.xy_un, frame.sigma2, bound, intr,
        rounds=rounds, iters_per_round=iters, accept_reject=ar,
    )
    inlier = opt.inlier & bound
    bind = jnp.where(inlier, res.idx, NEG)
    return opt.Tcw, bind, inlier, jnp.sum(inlier)


track_reference_kf = functools.partial(jax.jit, static_argnames=("pose_opt_cfg",))(
    _track_reference_kf_core
)


@jax.jit
def bootstrap(
    f1: FrameData,
    f2: FrameData,
    K: jnp.ndarray,
    key: jnp.ndarray,
):
    """Initialization attempt between two frames: window match + two-view
    RANSAC reconstruction (MonocularInitialization, Tracking.cc:344-419).

    Returns (match result f1->f2, InitResult).
    """
    from ..solvers import initialize_two_view

    match = matchers.search_for_initialization(
        f1.feats._replace(xy=f1.xy_un), f2.feats._replace(xy=f2.xy_un)
    )
    xy1 = f1.xy_un
    xy2 = f2.xy_un[jnp.clip(match.idx, 0, None)]
    init = initialize_two_view(xy1, xy2, match.ok, K, key)
    # Scalar head packed IN the program: the host's accept gates
    # (feature counts, n_matches, success) read one tiny announced buffer
    # instead of dispatching follow-up reductions and cold-reading them —
    # every blocking sync has a fixed latency, so the whole per-attempt
    # decision fits in ONE.
    head = jnp.stack([
        jnp.sum(f1.feats.valid).astype(jnp.float32),
        jnp.sum(f2.feats.valid).astype(jnp.float32),
        jnp.sum(match.ok).astype(jnp.float32),
        init.success.astype(jnp.float32),
    ])
    return match, init, head


def _triangulate_with_neighbor_impl(
    T_new: jnp.ndarray,
    T_nb: jnp.ndarray,
    new_xy: jnp.ndarray,
    new_desc: jnp.ndarray,
    new_angle: jnp.ndarray,
    new_octave: jnp.ndarray,
    new_unbound: jnp.ndarray,  # [N] valid features without a point
    nb_xy: jnp.ndarray,
    nb_desc: jnp.ndarray,
    nb_angle: jnp.ndarray,
    nb_octave: jnp.ndarray,
    nb_unbound: jnp.ndarray,
    K: jnp.ndarray,
    sigma2_table: jnp.ndarray,
    median_depth_new: jnp.ndarray,
    enable_far: bool = False,
):
    """Epipolar-matched triangulation of new map points between the new
    keyframe and one covisible neighbor (LocalMapping::CreateNewMapPoints,
    LocalMapping.cc:188-367).

    With enable_far, low-parallax candidates that pass every other check are
    routed to quasi-infinity along the new keyframe's ray — the os1
    "puntos lejanos" experiment (LocalMapping.cc:259-291, MapPoint::plLejano
    taxonomy).

    Returns (nb feature idx per new feature [-1 = none], points [N, 3],
    accepted [N], far [N]).
    """
    from ..features.orb import FrameFeatures
    from ..geometry import triangulation

    n = new_xy.shape[0]
    # Baseline/depth gate (LocalMapping.cc:219-223): skip neighbors whose
    # baseline is tiny relative to scene depth.
    baseline = jnp.linalg.norm(
        se3.camera_center(T_nb) - se3.camera_center(T_new)
    )
    baseline_ok = baseline / jnp.clip(median_depth_new, 1e-6, None) > 0.01

    F12 = matchers.compute_f12(T_new, T_nb, K, K)
    epi2 = cam_mod.project_ideal(
        cam_mod.Camera(
            fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
            dist=jnp.zeros(8), fisheye=jnp.asarray(False),
            width=jnp.inf, height=jnp.inf,
        ),
        se3.transform(T_nb, se3.camera_center(T_new)),
    )
    dummy = jnp.zeros(n, jnp.float32)
    f_new = FrameFeatures(new_xy, dummy, new_angle, new_octave, new_desc, new_unbound)
    f_nb = FrameFeatures(nb_xy, dummy, nb_angle, nb_octave, nb_desc, nb_unbound)
    match = matchers.search_for_triangulation(
        f_new, f_nb, F12, sigma2_table, epipole2=epi2
    )

    P1 = K @ T_new[:3, :]
    P2 = K @ T_nb[:3, :]
    xy2 = nb_xy[jnp.clip(match.idx, 0, None)]
    X = triangulation.triangulate_dlt(
        jnp.broadcast_to(P1, (n, 3, 4)), jnp.broadcast_to(P2, (n, 3, 4)),
        new_xy, xy2,
    )
    X = jnp.where(jnp.isfinite(X), X, 0.0)

    def proj(T):
        def f(pc):
            z = jnp.where(jnp.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
            return jnp.stack(
                [K[0, 0] * pc[..., 0] / z + K[0, 2], K[1, 1] * pc[..., 1] / z + K[1, 2]],
                axis=-1,
            )
        return f

    rays1 = None
    if enable_far:
        Kinv = jnp.linalg.inv(K)
        ones = jnp.ones_like(new_xy[:, :1])
        d_cam = jnp.concatenate([new_xy, ones], axis=1) @ Kinv.T
        d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
        rays1 = d_cam @ T_new[:3, :3]  # R^T d: camera ray in world frame

    check = triangulation.validate(
        T_new, T_nb, X, new_xy, xy2,
        proj(T_new), proj(T_nb),
        sigma2_table[new_octave], sigma2_table[nb_octave[jnp.clip(match.idx, 0, None)]],
        rays1=rays1, enable_far_points=enable_far,
    )
    far = match.ok & check.far & baseline_ok
    accepted = (match.ok & check.valid & baseline_ok) | far
    nb_idx = jnp.where(accepted, match.idx, NEG)
    return nb_idx, check.points, accepted, far, check.parallax_cos


triangulate_with_neighbor = functools.partial(
    jax.jit, static_argnames=("enable_far",)
)(_triangulate_with_neighbor_impl)


# All covisible neighbors triangulated in ONE device call (the reference's
# sequential per-neighbor loop, LocalMapping.cc:207-365, vmapped over the
# neighbor axis). Padding slots pass T_nb == T_new -> zero baseline -> every
# candidate rejected by the baseline gate.
@functools.partial(jax.jit, static_argnames=("enable_far",))
def triangulate_with_neighbors_batch(*args, enable_far=False):
    def one(*a):
        return _triangulate_with_neighbor_impl(*a, enable_far=enable_far)

    return jax.vmap(
        one,
        in_axes=(None, 0, None, None, None, None, None, 0, 0, 0, 0, 0, None, None, None),
    )(*args)


TRI_TOP = 1024  # max accepted triangulations downloaded per keyframe event


def _pack_tri(nb_idx, pts3, accepted, far, cosp):
    """Compact the [NB, N] triangulation outputs to the first TRI_TOP
    accepted entries: (code [TRI_TOP] i32 = flat nb*N+feat or -1,
    pts [TRI_TOP, 3], far [TRI_TOP], nb_feat [TRI_TOP],
    cos_parallax [TRI_TOP]). The dense readback is ~200 KB, the packed form
    ~26 KB (the dense copy once cost more than the triangulation program on
    the accelerator the system was first built on; not measured on the GPU).
    The parallax cosine feeds the far-point taxonomy (plOrigen classes,
    reference MapPoint.h:404-444).

    Per-feature dedup happens ON DEVICE before packing: only the FIRST
    accepting neighbor of each feature survives (identical to the host
    apply loop's `taken` order — neighbors are covisibility-sorted), so at
    most N (= TRI_TOP) entries can ever be accepted and the compaction can
    never silently truncate duplicate-laden keyframes."""
    NB, N = accepted.shape
    j_first = jnp.argmax(accepted, axis=0)  # first accepting neighbor per feat
    accepted = accepted & (jnp.arange(NB)[:, None] == j_first[None, :])
    flat_ok = accepted.reshape(-1)
    order = jnp.argsort(~flat_ok)[:TRI_TOP]  # accepted-first, stable
    ok_c = flat_ok[order]
    code = jnp.where(ok_c, order.astype(jnp.int32), jnp.int32(-1))
    pts_c = pts3.reshape(-1, 3)[order]
    far_c = far.reshape(-1)[order] & ok_c
    nbf_c = nb_idx.reshape(-1)[order]
    cosp_c = cosp.reshape(-1)[order]
    return code, pts_c, far_c, nbf_c, cosp_c


# Mirror-gathering variant: the per-keyframe feature arrays live in the
# device mirror already (map/mirror.py), so the host uploads only index
# vectors + dynamic masks (~60 KB) instead of the gathered rows (~1 MB).
# Poses are uploaded from the host snapshot — they may
# be fresher than the mirror mid-pass. Outputs are compacted (_pack_tri).
@functools.partial(jax.jit, static_argnames=("enable_far",))
def triangulate_mirror_batch(
    T_new: jnp.ndarray,  # [4, 4] host snapshot
    T_nb: jnp.ndarray,  # [NB, 4, 4] host snapshot
    kf_idx: jnp.ndarray,  # scalar int32 — the new keyframe's mirror row
    all_nb: jnp.ndarray,  # [NB] int32 — neighbor mirror rows
    kf_xy: jnp.ndarray,  # [K, N, 2] mirror (static after insertion)
    kf_angle: jnp.ndarray,  # [K, N] mirror
    kf_octave: jnp.ndarray,  # [K, N] mirror
    kf_desc: jnp.ndarray,  # [K, N, 8] mirror
    new_unbound: jnp.ndarray,  # [N] host (obs table is host-authoritative)
    nb_unbound: jnp.ndarray,  # [NB, N] host
    K: jnp.ndarray,
    sigma2_table: jnp.ndarray,
    median_depth_new: jnp.ndarray,
    enable_far: bool = False,
):
    def one(T_nb1, nb1, unb1):
        return _triangulate_with_neighbor_impl(
            T_new, T_nb1,
            kf_xy[kf_idx], kf_desc[kf_idx], kf_angle[kf_idx],
            kf_octave[kf_idx], new_unbound,
            kf_xy[nb1], kf_desc[nb1], kf_angle[nb1], kf_octave[nb1], unb1,
            K, sigma2_table, median_depth_new, enable_far=enable_far,
        )

    nb_idx, pts3, accepted, far, cosp = jax.vmap(one)(T_nb, all_nb, nb_unbound)
    return _pack_tri(nb_idx, pts3, accepted, far, cosp)


# All fusion targets of one keyframe in ONE device call. The reference's
# SearchInNeighbors runs ORBmatcher::Fuse sequentially per neighbor
# (LocalMapping.cc:369-447, ORBmatcher.cc:806-1064); here every (target,
# candidate-set) pair is a vmapped lane. The merge/Replace bookkeeping stays
# on host (local_mapping.py) and preserves the sequential apply order.
@functools.partial(jax.jit, static_argnames=("n_levels",))
def fuse_batch(
    tgt_T: jnp.ndarray,  # [T, 4, 4]
    tgt_xy: jnp.ndarray,  # [T, N, 2]
    tgt_angle: jnp.ndarray,  # [T, N]
    tgt_octave: jnp.ndarray,  # [T, N]
    tgt_desc: jnp.ndarray,  # [T, N, 8]
    tgt_valid: jnp.ndarray,  # [T, N]
    cand_idx: jnp.ndarray,  # [T, C] int32 into the slice arrays
    cand_valid: jnp.ndarray,  # [T, C] (host pre-excludes already-observed)
    slice_xyz: jnp.ndarray,  # [S, 3]
    slice_desc: jnp.ndarray,  # [S, 8]
    slice_maxdist: jnp.ndarray,  # [S]
    intr: jnp.ndarray,  # [4]
    width: jnp.ndarray,
    height: jnp.ndarray,
    scale_factor: jnp.ndarray,
    n_levels: int = 8,
):
    from ..features.orb import FrameFeatures

    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    def one(T, xy, angle, octave, desc, fvalid, idx, cvalid):
        X = slice_xyz[idx]  # [C, 3]
        pc = se3.transform(T, X)
        z = jnp.where(jnp.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
        uv = jnp.stack(
            [fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], axis=-1
        )
        valid = cvalid & (pc[..., 2] > 0.05)
        valid &= (uv[..., 0] > 0) & (uv[..., 0] < width)
        valid &= (uv[..., 1] > 0) & (uv[..., 1] < height)
        Ow = se3.camera_center(T)
        dist = jnp.linalg.norm(X - Ow, axis=-1)
        octv = matchers.predicted_octave(
            dist, slice_maxdist[idx], scale_factor, n_levels
        )
        feats = FrameFeatures(
            xy=xy, response=jnp.zeros_like(angle), angle=angle,
            octave=octave, desc=desc, valid=fvalid,
        )
        res = matchers.fuse_candidates(
            point_desc=slice_desc[idx], point_uv=uv, point_valid=valid,
            point_octave=octv,
            radius_scale=scale_factor ** octv.astype(jnp.float32),
            feats=feats,
        )
        return res.ok & valid, res.idx

    ok, idx = jax.vmap(one)(
        tgt_T, tgt_xy, tgt_angle, tgt_octave, tgt_desc, tgt_valid,
        cand_idx, cand_valid,
    )
    # Device-side compaction: only the ok entries matter and they are sparse
    # (tens per target). Downloading the dense [T, C] pair would move ~1.5 MB
    # per keyframe; instead pack the first FUSE_TOP ok entries per row as
    # (cand_slot << 12 | feat_idx) codes — ~50 KB.
    order = jnp.argsort(~ok, axis=1)[:, :FUSE_TOP]  # ok lanes first (stable)
    ok_c = jnp.take_along_axis(ok, order, axis=1)
    idx_c = jnp.take_along_axis(idx, order, axis=1)
    code = jnp.where(
        ok_c, (order << 12) | jnp.clip(idx_c, 0, (1 << 12) - 1), -1
    ).astype(jnp.int32)
    return code


FUSE_TOP = 256  # max fuse matches downloaded per target (code-packed)


# Mirror-gathering fuse: target keyframe feature rows and the shared point
FUSE_PAIR_TOP = 128  # max fuse matches downloaded per (target, source) pair


@functools.partial(jax.jit, static_argnames=("n_levels",))
def fuse_pairs_mirror(
    tgt_T: jnp.ndarray,  # [L, 4, 4] target poses (host snapshot — fresher)
    tgt_rows: jnp.ndarray,  # [L] i32 target mirror rows
    src_rows: jnp.ndarray,  # [L] i32 source rows (candidates = src's points)
    lane_valid: jnp.ndarray,  # [L] bool (padding lanes off)
    kf_xy: jnp.ndarray,  # [K, N, 2] mirror
    kf_angle: jnp.ndarray,
    kf_octave: jnp.ndarray,
    kf_desc: jnp.ndarray,
    kf_feat_valid: jnp.ndarray,  # [K, N] mirror
    kf_obs_point: jnp.ndarray,  # [K, N] mirror
    pt_xyz: jnp.ndarray,  # [P, 3] mirror
    pt_desc: jnp.ndarray,
    pt_max_dist: jnp.ndarray,
    pt_valid: jnp.ndarray,  # [P] mirror
    pt_obs_kf: jnp.ndarray,  # [P, M] mirror
    intr: jnp.ndarray,
    width: jnp.ndarray,
    height: jnp.ndarray,
    scale_factor: jnp.ndarray,
    n_levels: int = 8,
):
    """SearchInNeighbors fusion with ALL inputs gathered from the mirror.

    One lane per (target keyframe, source keyframe) pair: the source row's
    bound points are the fuse candidates projected into the target — the
    reference's bidirectional pair structure (LocalMapping.cc:369-447:
    Fuse(neighbor, points-of-new-KF) plus Fuse(new-KF, points-of-neighbor)).
    The old fuse_batch uploaded host-packed candidate tables (cand_idx +
    cand_valid, ~1 MB per keyframe event at the 4096 bucket) — the largest
    recurring host->device transfer in the pipeline, which stalled every
    queued program behind it on the earlier accelerator's transport (not
    measured on the GPU). Here the host uploads three [L] index vectors
    (~1 KB).

    Candidate validity (point alive + not already observed in the target)
    is evaluated on device against the just-published mirror observation
    table. Returns [L, FUSE_PAIR_TOP] i32 codes (src_feat << 12 | tgt_feat,
    -1 pad)."""
    from ..features.orb import FrameFeatures

    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    def one(T, tr, sr, lv):
        pid = kf_obs_point[sr]  # [N] candidate point per source feature
        pidc = jnp.clip(pid, 0, None)
        cval = lv & (pid >= 0) & pt_valid[pidc]
        # Exclude points already observed in the target (the host used to
        # pre-compute this; pt_obs_kf is mirrored, so the device can).
        cval &= ~jnp.any(pt_obs_kf[pidc] == tr, axis=1)
        X = pt_xyz[pidc]  # [N, 3]
        pc = se3.transform(T, X)
        z = jnp.where(jnp.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
        uv = jnp.stack(
            [fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], axis=-1
        )
        valid = cval & (pc[..., 2] > 0.05)
        valid &= (uv[..., 0] > 0) & (uv[..., 0] < width)
        valid &= (uv[..., 1] > 0) & (uv[..., 1] < height)
        Ow = se3.camera_center(T)
        dist = jnp.linalg.norm(X - Ow, axis=-1)
        maxd = jnp.nan_to_num(pt_max_dist[pidc], posinf=1e9)
        octv = matchers.predicted_octave(dist, maxd, scale_factor, n_levels)
        feats = FrameFeatures(
            xy=kf_xy[tr], response=jnp.zeros_like(kf_angle[tr]),
            angle=kf_angle[tr], octave=kf_octave[tr], desc=kf_desc[tr],
            valid=kf_feat_valid[tr] & lv,
        )
        res = matchers.fuse_candidates(
            point_desc=pt_desc[pidc], point_uv=uv, point_valid=valid,
            point_octave=octv,
            radius_scale=scale_factor ** octv.astype(jnp.float32),
            feats=feats,
        )
        return res.ok & valid, res.idx

    ok, idx = jax.vmap(one)(tgt_T, tgt_rows, src_rows, lane_valid)
    order = jnp.argsort(~ok, axis=1)[:, :FUSE_PAIR_TOP]  # ok-first (stable)
    ok_c = jnp.take_along_axis(ok, order, axis=1)
    idx_c = jnp.take_along_axis(idx, order, axis=1)
    code = jnp.where(
        ok_c, (order << 12) | jnp.clip(idx_c, 0, (1 << 12) - 1), -1
    ).astype(jnp.int32)
    return code


@jax.jit
def compute_median_depth(T: jnp.ndarray, pt_xyz: jnp.ndarray, mask: jnp.ndarray):
    from ..geometry import triangulation

    return triangulation.median_depth(T, pt_xyz, mask)


@jax.jit
def assemble_ba_mirror(
    # mirror blocks (device-resident — zero upload)
    pt_xyz: jnp.ndarray,  # [P, 3]
    pt_obs_kf: jnp.ndarray,  # [P, M] i32
    pt_obs_feat: jnp.ndarray,  # [P, M] i32
    kf_xy: jnp.ndarray,  # [K, N, 2]
    kf_octave: jnp.ndarray,  # [K, N] i32
    kf_feat_valid: jnp.ndarray,  # [K, N] bool (False = not materialized)
    # small host uploads (~10 KB total)
    pts_idx: jnp.ndarray,  # [P_BA] i32 point slots (padded; pvalid masks)
    pvalid: jnp.ndarray,  # [P_BA] bool
    cam_T: jnp.ndarray,  # [C, 4, 4] poses from the host snapshot
    cam_lookup: jnp.ndarray,  # [K] i32 keyframe slot -> camera slot (-1)
    sigma2_table: jnp.ndarray,  # [L]
    intr: jnp.ndarray,
):
    """Gather the observation tables of a BA problem FROM THE MIRROR.

    Replaces the ~600 KB host upload per local BA (obs_uv/sigma2/cam/valid
    tables) with device gathers over the mirrored observation index tables
    — the host sends only the point-slot list, poses, and the camera slot
    lookup. Observations in not-yet-materialized keyframes (kf_feat_valid
    False — their kf_xy rows are zeros) are excluded, or they read as
    measurements at pixel (0,0). Returns (obs_cam, obs_uv, obs_sigma2,
    obs_valid, points)."""
    okf = pt_obs_kf[pts_idx]  # [P_BA, M]
    oft = pt_obs_feat[pts_idx]
    okf_c = jnp.clip(okf, 0, kf_xy.shape[0] - 1)
    oft_c = jnp.clip(oft, 0, kf_xy.shape[1] - 1)
    slots = cam_lookup[okf_c]
    valid = ((okf >= 0) & (slots >= 0) & pvalid[:, None]
             & kf_feat_valid[okf_c, oft_c])
    obs_cam = jnp.where(valid, slots, 0).astype(jnp.int32)
    obs_uv = jnp.where(valid[..., None], kf_xy[okf_c, oft_c], 0.0)
    obs_s2 = jnp.where(valid, sigma2_table[kf_octave[okf_c, oft_c]], 1.0)
    points = pt_xyz[pts_idx] * pvalid[:, None]
    return obs_cam, obs_uv, obs_s2, valid, points
