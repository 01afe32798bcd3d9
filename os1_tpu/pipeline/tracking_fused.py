"""Fused per-frame tracking: the whole OK-state frame path in ONE device
program against the device-resident map mirror.

The unfused path (tracking.py + tracking_kernels.py) runs 2-4 separate
device programs per frame and uploads ~20 host-gathered map slices, each
transfer with a fixed latency that adds up against the real-time budget.
Here the map lives on device (map/mirror.py) and one
program covers the reference's entire per-frame pipeline after extraction
(Tracking.cc:231-342):

  1. TrackWithMotionModel (Tracking.cc:594-651), with the reference's
     double-radius retry (Tracking.cc:617) as a lax.cond;
  2. TrackReferenceKeyFrame fallback (Tracking.cc:540-582) as a lax.cond
     taken only when motion tracking fails;
  3. TrackLocalMap (Tracking.cc:653-694): frustum-gated projection matching
     of the local point set + the frame's third pose optimization.

Per frame the host uploads only the image, the previous frame's bindings
[N] and the local candidate ids [L]; it downloads one small result pytree
(pose, global bindings, counts, visibility stats) — a single round trip.

Local-map selection note: the reference picks local keyframes from the
CURRENT frame's post-motion-model matches (Tracking.cc:859-967). Those
matches are by construction a subset of the points bound to the PREVIOUS
frame, so the host selects local candidates from the previous frame's
bindings (plus the reference keyframe's neighborhood) before dispatch —
same covisibility neighborhood, one frame earlier, zero mid-frame syncs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..geometry import camera as cam_mod
from .config import SlamConfig
from .frame import FrameData
from .tracking_kernels import NEG, _track_points_core, _track_reference_kf_core


def pack_result(Tcw, bind, n_inliers, pre_ok, n_pre, used_motion, visible):
    """Pack the fused step's outputs into ONE int32 vector.

    Every device->host transfer has a fixed latency; a dict of 7 small
    arrays would pay it seven times every frame. One packed vector = one
    transfer (what the latency is on an NVIDIA GPU is not measured).
    Layout:
      [0:16]   Tcw float32 bits
      [16]     n_inliers | [17] n_pre | [18] pre_ok | [19] used_motion
      [20:20+N]        bind
      [20+N : 20+N+L/32] visible bitmask (bit i of word w = lane w*32+i)
    """
    L = visible.shape[0]
    vis_words = jnp.sum(
        visible.reshape(L // 32, 32).astype(jnp.uint32)
        << jnp.arange(32, dtype=jnp.uint32),
        axis=-1,
    ).astype(jnp.int32)
    head = jax.lax.bitcast_convert_type(Tcw.reshape(-1), jnp.int32)
    scalars = jnp.stack(
        [n_inliers.astype(jnp.int32), n_pre.astype(jnp.int32),
         pre_ok.astype(jnp.int32), used_motion.astype(jnp.int32)]
    )
    return jnp.concatenate([head, scalars, bind.astype(jnp.int32), vis_words])


def unpack_result(arr, n_feat: int, n_local: int) -> dict:
    """Host-side inverse of :func:`pack_result` (numpy)."""
    import numpy as np

    arr = np.asarray(arr)
    Tcw = arr[:16].view(np.float32).reshape(4, 4)
    words = arr[20 + n_feat:].view(np.uint32)
    visible = (
        (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(bool).reshape(-1)[:n_local]
    return dict(
        Tcw=Tcw,
        n_inliers=int(arr[16]),
        n_pre=int(arr[17]),
        pre_ok=bool(arr[18]),
        used_motion=bool(arr[19]),
        bind=arr[20:20 + n_feat],
        visible=visible,
    )


def _orthonormalize_se3(T: jnp.ndarray) -> jnp.ndarray:
    """Project the rotation block back onto SO(3) (Gram-Schmidt on rows).

    Poses produced by LM updates accumulate float non-orthonormality; the
    device pose chain feeds pred = T_k T_{k-1}^-1 T_k with a TRANSPOSE-based
    inverse, under which a scale defect s evolves as s_{k+1} = s_k^2 s_{k-1}
    — exponential growth at (1 + sqrt(2))x per frame (observed empirically:
    x2.4). Re-projecting every output pose keeps the chain exactly rigid.
    """
    R = T[:3, :3]
    r0 = R[0] / jnp.linalg.norm(R[0])
    r1 = R[1] - jnp.dot(R[1], r0) * r0
    r1 = r1 / jnp.linalg.norm(r1)
    r2 = jnp.cross(r0, r1)
    return T.at[:3, :3].set(jnp.stack([r0, r1, r2]))


def make_fused_tracker(cfg: SlamConfig):
    """Build the jitted fused step for a fixed config. Closes over all
    thresholds (they are compile-time constants, as in the reference)."""
    th = cfg.th
    scale_factor = cfg.orb.scale_factor
    n_levels = cfg.orb.n_levels
    # Pose-opt schedule for the hot path: damped Gauss-Newton with chi2
    # reweighting between rounds, instead of the reference's LM 4x10
    # (Optimizer.cc:284-329). The solver is a latency-bound sequential chain
    # of small solves, so the default compresses the schedule ~3x; configurable for
    # A/B against the reference schedule (accuracy.py --pose-ref).
    POSE_CFG = (th.pose_opt_rounds, th.pose_opt_iters, th.pose_opt_reject)

    @jax.jit
    def step(
        # --- device-resident map mirror (map/mirror.py) ---
        pt_xyz: jnp.ndarray,  # [P, 3]
        pt_desc: jnp.ndarray,  # [P, 8]
        pt_valid: jnp.ndarray,  # [P]
        pt_normal: jnp.ndarray,  # [P, 3]
        pt_min_dist: jnp.ndarray,  # [P]
        pt_max_dist: jnp.ndarray,  # [P]
        kf_desc: jnp.ndarray,  # [K, N, 8]
        kf_angle: jnp.ndarray,  # [K, N]
        kf_obs_point: jnp.ndarray,  # [K, N]
        # --- current frame (device) ---
        frame: FrameData,
        cam: cam_mod.Camera,
        intr: jnp.ndarray,
        # --- small per-frame state (device-chained or host uploads) ---
        last_T: jnp.ndarray,  # [4, 4] last frame pose
        prev_T: jnp.ndarray,  # [4, 4] pose of the frame before that
        last_bind: jnp.ndarray,  # [N] i32 global point id per last-frame feature
        last_octave: jnp.ndarray,  # [N] i32 last-frame feature octaves
        ref_kf: jnp.ndarray,  # scalar i32 (clamped; see ref_ok)
        ref_ok: jnp.ndarray,  # scalar bool — False when no reference KF exists
        local_ids: jnp.ndarray,  # [L] i32 local-map candidate point ids
        local_valid: jnp.ndarray,  # [L] bool
        has_velocity: jnp.ndarray,  # scalar bool
    ):
        P = pt_xyz.shape[0]
        n_feat = frame.xy_un.shape[0]

        # Constant-velocity prediction computed ON DEVICE (Tracking.cc:278-283
        # mVelocity = Tcw_k (Tcw_{k-1})^-1): the pose chain never has to visit
        # the host between frames, which is what makes pipelined tracking a
        # pure device-to-device dependency.
        Rp, tp = prev_T[:3, :3], prev_T[:3, 3]
        prev_inv = (
            jnp.eye(4, dtype=last_T.dtype)
            .at[:3, :3].set(Rp.T)
            .at[:3, 3].set(-Rp.T @ tp)
        )
        pred_T = jnp.where(has_velocity, (last_T @ prev_inv) @ last_T, last_T)

        # ---------------- stage 1: motion-model tracking ---------------- #
        # Runs whenever the previous frame carries verified binds, even with
        # no velocity yet (pred_T falls back to last_T above): the frame
        # right after relocalization/initialization has ~50+ verified
        # matches, and projecting THOSE with a zero-motion window is far
        # stronger than the refkf descriptor fallback (which collapsed to
        # ~6 matches on repetitive real textures and re-lost the track —
        # the post-reloc thrash signature).
        m_ids = jnp.clip(last_bind, 0, P - 1)
        m_live = (last_bind >= 0) & pt_valid[m_ids]
        m_xyz = pt_xyz[m_ids]
        no_prev = jnp.zeros(n_feat, bool)
        zeros3 = jnp.zeros((n_feat, 3), jnp.float32)

        def run_motion(radius):
            r = _track_points_core(
                pred_T, m_xyz, pt_desc[m_ids], m_live, last_octave,
                pt_normal[m_ids], pt_min_dist[m_ids], pt_max_dist[m_ids],
                no_prev, zeros3, no_prev,
                frame, cam, intr, radius,
                scale_factor=scale_factor, n_levels=n_levels,
                use_frustum=False, ratio=0.9, pose_opt_cfg=POSE_CFG,
            )
            return r[0], r[1], r[3]

        # Radius-escalation retry (Tracking.cc:617: th -> 2*th when weak) as
        # a while_loop so the matching+opt body is traced/compiled ONCE.
        def retry_cond(s):
            attempt, radius, (_, _, n1) = s
            return (attempt < 2) & (n1 < th.min_motion_inliers + 10)

        def retry_body(s):
            attempt, radius, _ = s
            return attempt + 1, jnp.float32(th.motion_search_radius_retry), run_motion(radius)

        zero_res = (
            pred_T,
            jnp.full(n_feat, NEG),
            jnp.int32(-1),  # sentinel: forces the first iteration
        )
        _, _, (T1, b1, n1) = lax.while_loop(
            retry_cond,
            retry_body,
            (jnp.int32(0), jnp.float32(th.motion_search_radius), zero_res),
        )
        n1 = jnp.maximum(n1, 0)
        g1 = jnp.where(b1 >= 0, last_bind[jnp.clip(b1, 0, n_feat - 1)], NEG)
        ok1 = n1 >= th.min_motion_inliers

        # -------------- stage 2: reference-KF fallback ------------------ #
        def refkf_branch():
            obs = kf_obs_point[ref_kf]  # [N]
            has_pt = (obs >= 0) & pt_valid[jnp.clip(obs, 0, P - 1)]
            T2, b2, _, n2 = _track_reference_kf_core(
                last_T, kf_desc[ref_kf], has_pt,
                pt_xyz[jnp.clip(obs, 0, P - 1)], kf_angle[ref_kf],
                frame, intr, pose_opt_cfg=POSE_CFG,
            )
            g2 = jnp.where(b2 >= 0, obs[jnp.clip(b2, 0, n_feat - 1)], NEG)
            # A missing reference keyframe (ref_kf < 0 on host, clamped to 0
            # here) must fail cleanly instead of silently matching slot 0 —
            # the unfused path returns failure when ref_kf < 0.
            return T2, g2, n2, (n2 >= th.min_refkf_inliers) & ref_ok

        T_pre, g_pre, n_pre, ok_pre = lax.cond(
            ok1, lambda: (T1, g1, n1, True), refkf_branch
        )

        # ---------------- stage 3: local-map tracking ------------------- #
        l_ids = jnp.clip(local_ids, 0, P - 1)
        prev_bound = g_pre >= 0
        # Candidate points already bound to this frame are skipped
        # (reference mnLastFrameSeen gate, Tracking.cc:795).
        bound_now = (
            jnp.zeros(P, bool)
            .at[jnp.clip(g_pre, 0, P - 1)]
            .max(prev_bound, mode="drop")
        )
        cand = local_valid & pt_valid[l_ids] & ~bound_now[l_ids]
        prev_xyz = pt_xyz[jnp.clip(g_pre, 0, P - 1)]

        T3, lb, inlier, n3, visible = _track_points_core(
            T_pre, pt_xyz[l_ids], pt_desc[l_ids], cand,
            jnp.zeros(local_ids.shape[0], jnp.int32),
            pt_normal[l_ids], pt_min_dist[l_ids], pt_max_dist[l_ids],
            prev_bound, prev_xyz, prev_bound,
            frame, cam, intr, jnp.float32(th.localmap_search_radius),
            scale_factor=scale_factor, n_levels=n_levels,
            use_frustum=True, ratio=0.8, pose_opt_cfg=POSE_CFG,
        )
        L = local_ids.shape[0]
        g3 = jnp.where(
            lb >= 0,
            local_ids[jnp.clip(lb, 0, L - 1)],
            jnp.where(prev_bound & inlier, g_pre, NEG),
        )
        T_final = _orthonormalize_se3(T3)
        # Tcw/bind stay as device arrays for the pipelined pose chain (never
        # downloaded); the host reads ONLY the packed vector (one transfer).
        return dict(
            Tcw=T_final, bind=g3,
            packed=pack_result(T_final, g3, n3, ok_pre, n_pre, ok1,
                               visible & cand),
        )

    return step
