"""Tracking front-end FSM (host orchestration of jitted device programs).

The reference's Tracking thread (Tracking.cc:123-342) as a host state machine:
per frame it runs at most three fused device programs (motion-model track,
reference-KF fallback, local-map track) plus the extractor — the host only
handles state transitions and small index bookkeeping.

States mirror the reference enum (Tracking.h eTrackingState):
NO_IMAGES_YET / NOT_INITIALIZED / OK / LOST.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..map.store import MapStore
from ..optim import BAProblem
from ..utils.profiling import StageTimer
from . import tracking_kernels as tk
from .config import SlamConfig
from .frame import FrameData, make_frame_builder


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclass
class TrackedFrame:
    """Host-side record of the last processed frame."""

    data: FrameData
    Tcw: np.ndarray
    bind: np.ndarray  # [N] global map-point id per feature (-1 unbound)
    frame_id: int
    timestamp: float
    octave: np.ndarray  # host copy of per-feature octaves
    n_inliers: int = 0


@dataclass
class Tracker:
    cfg: SlamConfig
    store: MapStore
    mirror = None  # DeviceMirror | None, wired by System (fused frame path)
    pipelined: bool = False  # frame pipelining over the device chain
    # Frames in flight when pipelined: with a dispatch->result latency of
    # about two frames of device work, depth 2 hides it and the
    # steady-state fps becomes 1/occupancy instead of 1/latency. The pose
    # chain is a pure device-to-device dependency either way; only the
    # host-visible FSM lags `pipeline_depth` frames. Depth 2 (not 3): every
    # extra in-flight frame is queued device work that every cooperative
    # mapping-stage fetch must ALSO wait behind. Both were tuned on the
    # accelerator the system was first built on; the H100's round trip is
    # not measured yet.
    pipeline_depth: int = 2
    state: TrackingState = TrackingState.NO_IMAGES_YET
    last: TrackedFrame | None = None
    init_ref: TrackedFrame | None = None
    velocity: np.ndarray | None = None
    ref_kf: int = -1
    frame_id: int = 0
    last_kf_frame_id: int = 0
    last_reloc_frame_id: int = -10**9
    on_new_keyframe = None  # callback(kf_id) -> None, wired by System
    on_reset = None  # callback() -> None, wired by System (clears BoW db)
    relocalizer = None  # callback(frame) -> (ok, Tcw, bind), wired by System
    trajectory: list = field(default_factory=list)
    # Tracking-loss diagnostics: (frame_id, reason) per loss event — the
    # observability hook for the reloc-storm investigations (bench ok gate).
    loss_log: list = field(default_factory=list)
    # FrameDrawer introspection: last bootstrap-attempt match (device pair,
    # materialized lazily by the drawer) and the attempt's current frame.
    _init_match_dev: object = None
    _init_cur_frame: object = None
    timer: StageTimer = field(default_factory=StageTimer)
    # Map lock (Map::mMutexMapUpdate): the reference's Tracking::Track takes
    # it for the whole per-frame pass (Tracking.cc:133); here only the host
    # FSM sections hold it — device dispatches/waits run outside so the
    # mapping worker can interleave its locked phases between frames.
    lock: threading.RLock = field(default_factory=threading.RLock)
    # Backpressure hooks, wired by System in async mode (reference
    # SetAcceptKeyFrames / InterruptBA protocol, Tracking.cc:719,755):
    mapping_idle = None  # callable() -> bool | None (None = always idle)
    interrupt_ba = None  # callable() -> None | None
    # callable() -> bool: True while a loop closure is in flight; keyframe
    # insertion pauses (the reference's mapper-stopped gate, Tracking.cc:719
    # — a keyframe created mid-closure is missed by the correction).
    loop_closing_active = None
    # Localization-only mode (mbOnlyTracking): the map is frozen — no
    # keyframes, no observations, no point stats are written
    # (Tracking.cc:699-700 gates NeedNewKeyFrame).
    only_tracking: bool = False

    def __post_init__(self):
        self._build = make_frame_builder(self.cfg.orb)
        self._fused = None  # built on first fused frame (needs self.mirror)
        self._prev_Tcw = None  # pose two frames back (device velocity input)
        self._chain = None  # device-resident (bind, T, prevT, octave) chain
        self._pending = []  # in-flight [(frame, fid, ts, out, local_ids)]
        self._key = jax.random.PRNGKey(0)
        self._intr = jnp.asarray(self.cfg.intr)
        self._K = jnp.asarray(
            np.array(
                [
                    [self.cfg.intr[0], 0, self.cfg.intr[2]],
                    [0, self.cfg.intr[1], self.cfg.intr[3]],
                    [0, 0, 1],
                ],
                np.float32,
            )
        )
        self._sigma2 = jnp.asarray(self.cfg.sigma2_table)

    # ------------------------------------------------------------------ #
    def track(self, img, timestamp: float = 0.0):
        """Process one grayscale image. Returns (state, Tcw or None)."""
        with self.timer("trk.extract"):
            frame = self._build(jnp.asarray(img), self.cfg.camera)
        fid = self.frame_id
        self.frame_id += 1

        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            with self.timer("trk.initialize"), self.lock:
                self._monocular_initialization(frame, fid, timestamp)
        elif self.state == TrackingState.OK:
            self._track_frame(frame, fid, timestamp)
        else:  # LOST
            with self.timer("trk.relocalize"), self.lock:
                self._relocalize(frame, fid, timestamp)

        # Trajectory entries are recorded exactly once per accepted frame by
        # the success paths themselves (_finish_frame / _create_initial_map /
        # _relocalize), each stamped with the frame's OWN timestamp — in
        # pipelined mode results lag a frame behind this return value.
        Tcw = self.last.Tcw if self.last is not None and self.state == TrackingState.OK else None
        return self.state, Tcw

    def _record_trajectory(self, timestamp, fid, Tcw):
        """Record the frame pose RELATIVE to the current reference keyframe
        (the reference's mlRelativeFramePoses + reference-KF list,
        System.cc SaveTrajectoryTUM): loop corrections / GBA / local BA
        then retroactively correct the whole trajectory through the live
        keyframe poses at read time."""
        st = self.store
        ref = self.ref_kf
        if ref >= 0 and st.kf_valid[ref]:
            T_rel = (Tcw @ np.linalg.inv(st.kf_T[ref])).astype(np.float32)
            self.trajectory.append(
                (timestamp, fid, int(ref), int(st.kf_seq[ref]), T_rel,
                 Tcw.copy())
            )
        else:
            self.trajectory.append((timestamp, fid, -1, -1, None, Tcw.copy()))

    def frame_trajectory(self):
        """[(timestamp, frame_id, Tcw)] with every pose re-anchored through
        its reference keyframe's CURRENT pose (retroactive corrections).
        Culled references are walked to a live ancestor through the saved
        relative poses (SaveTrajectoryTUM's while(pKF->isBad()) Trw *= mTcp
        walk); only a fully dead chain falls back to the recorded pose."""
        st = self.store
        out = []
        for ts, fid, ref, seq, T_rel, T_abs in self.trajectory:
            T = None
            if ref >= 0:
                T_acc = T_rel
                r, s = ref, seq
                for _ in range(256):  # bounded ancestor walk
                    if st.kf_valid[r] and st.kf_seq[r] == s:
                        T = T_acc @ st.kf_T[r]
                        break
                    link = st.culled_links.get((r, s))
                    if link is None:
                        break
                    p, pseq, T_cp = link
                    T_acc = T_acc @ T_cp
                    r, s = p, pseq
            out.append((ts, fid, T if T is not None else T_abs))
        return out

    @property
    def last_init_match(self):
        """[N] init-reference feature -> current feature (-1 unmatched),
        materialized on demand (FrameDrawer init-flow lines)."""
        if self._init_match_dev is None:
            return None
        ok, idx = self._init_match_dev
        return np.where(np.asarray(ok), np.asarray(idx), -1)

    # ------------------------------------------------------------------ #
    # initialization (Tracking.cc:344-521)
    # ------------------------------------------------------------------ #
    def _monocular_initialization(self, frame, fid, timestamp):
        """Two-view bootstrap FSM with ONE device sync per attempt: the
        bootstrap head carries both frames' feature counts, the match count
        and the model-acceptance flag, so every host decision below reads a
        single announced buffer (each blocking sync has a fixed latency).
        The reference's per-frame keypoint-count gate
        (Tracking.cc:353-360) is evaluated one frame deferred: the
        reference frame is adopted optimistically and replaced if the head
        shows it was feature-poor."""
        from ..utils.transfer import announce

        def adopt_ref():
            self.init_ref = TrackedFrame(
                data=frame, Tcw=np.eye(4, dtype=np.float32),
                bind=np.full(self.cfg.orb.n_features, -1, np.int64),
                frame_id=fid, timestamp=timestamp, octave=None,
            )
            self.state = TrackingState.NOT_INITIALIZED

        if self.init_ref is None:
            adopt_ref()  # validated by the next attempt's head
            return

        self._key, sub = jax.random.split(self._key)
        match, init, head = tk.bootstrap(self.init_ref.data, frame, self._K, sub)
        announce(head)  # d2h in stream order (transport discipline)
        # Init-flow introspection for the FrameDrawer (ref-frame keypoint ->
        # current match; FrameDrawer.cc:104-108 draws these as lines) —
        # device arrays; the drawer materializes only when rendering.
        self._init_match_dev = (match.ok, match.idx)
        self._init_cur_frame = frame
        head = np.asarray(head)
        min_m = self.cfg.th.min_init_matches
        if head[0] <= min_m:  # reference frame was feature-poor: replace
            if head[1] > min_m:
                adopt_ref()
            else:
                self.init_ref = None
            return
        if head[1] <= min_m:  # current frame feature-poor: keep waiting
            return
        if int(head[2]) < min_m:  # n_matches
            self.init_ref = None  # retry with a fresh reference
            return
        if head[3] < 0.5:  # init.success
            return

        self._create_initial_map(frame, fid, timestamp, match, init)

    def _create_initial_map(self, frame, fid, timestamp, match, init):
        st = self.store
        f1, f2 = self.init_ref.data, frame

        from .frame import unpack_host

        from ..utils.transfer import fetch

        # One announced gather for everything the map build needs (each
        # cold np.asarray would pay its own transport round trip).
        T21, good, m_idx, pts3d, p1, p2 = fetch((
            init.T21, init.good, match.idx, init.points,
            f1.host_pack, f2.host_pack,
        ))
        T21 = np.asarray(T21)
        k1 = st.add_keyframe(
            np.eye(4, dtype=np.float32), *unpack_host(p1),
            frame_id=self.init_ref.frame_id, timestamp=self.init_ref.timestamp,
        )
        k2 = st.add_keyframe(T21, *unpack_host(p2), frame_id=fid, timestamp=timestamp)

        st.kf_parent[k2] = k1  # spanning-tree root edge (KeyFrame::ChangeParent)
        good = np.asarray(good)
        m_idx = np.asarray(m_idx)
        pts3d = np.asarray(pts3d)
        feat1_ids = np.nonzero(good)[0]
        pt_ids = st.alloc_points(len(feat1_ids))
        st.pt_xyz[pt_ids] = pts3d[feat1_ids]
        st.pt_first_seq[pt_ids] = st.kf_seq[k2]
        n_new = len(pt_ids)
        # k1 entries precede k2 entries so each point's slot order is (k1, k2).
        st.add_observations(
            np.concatenate([pt_ids, pt_ids]),
            np.concatenate([np.full(n_new, k1), np.full(n_new, k2)]),
            np.concatenate([feat1_ids, m_idx[feat1_ids]]),
        )
        st.update_point_derived(pt_ids, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)

        # Global BA over the initial two-view map (Tracking.cc:470,
        # GlobalBundleAdjustemnt(map, 20)).
        self._initial_ba(k1, k2, pt_ids)

        # Median-depth normalization to 1.0 (Tracking.cc:473-497).
        md = float(
            tk.compute_median_depth(
                jnp.asarray(st.kf_T[k1]), jnp.asarray(st.pt_xyz),
                jnp.asarray(st.pt_valid),
            )
        )
        if md < 1e-6 or int(st.pt_n_obs[pt_ids].sum()) < 2 * self.cfg.th.min_init_triangulated:
            self.reset()
            return
        st.pt_xyz[st.pt_valid] /= md
        st.kf_T[k2, :3, 3] /= md
        st.update_point_derived(pt_ids, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)

        bind = np.full(self.cfg.orb.n_features, -1, np.int64)
        bind[m_idx[feat1_ids]] = pt_ids
        self.last = TrackedFrame(
            data=frame, Tcw=st.kf_T[k2].copy(), bind=bind, frame_id=fid,
            timestamp=timestamp, octave=np.asarray(frame.feats.octave),
            n_inliers=len(pt_ids),
        )
        self.ref_kf = k2
        self.last_kf_frame_id = fid
        self.velocity = None
        self._prev_Tcw = None
        self._chain = None
        self.state = TrackingState.OK
        self._record_trajectory(timestamp, fid, self.last.Tcw)
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(k1, bootstrap=True)
            self.on_new_keyframe(k2, bootstrap=True)

    def _initial_ba(self, k1, k2, pt_ids):
        """Initial two-view BA (Tracking.cc:470) assembled into the SAME
        padded (P, C) bucket + chunked-LM programs the local mapper warms:
        an exact-shape problem would recompile here on every initialization
        (point counts differ per attempt)."""
        from .local_mapping import (
            C_BUCKETS, P_BUCKETS, _ba_begin_j, _ba_iterate_j, _ba_result_j,
        )
        from ..utils.transfer import fetch

        st = self.store
        P = len(pt_ids)
        P_pad = next(b for b in P_BUCKETS if b >= P)
        C_pad = C_BUCKETS[0]
        M = st.cfg.max_obs_per_point
        okf = st.pt_obs_kf[pt_ids]  # [P, M]
        oft = st.pt_obs_feat[pt_ids]
        okf_c = np.clip(okf, 0, None)
        oft_c = np.clip(oft, 0, None)
        obs_valid = np.zeros((P_pad, M), bool)
        obs_cam = np.zeros((P_pad, M), np.int32)
        obs_uv = np.zeros((P_pad, M, 2), np.float32)
        obs_s2 = np.ones((P_pad, M), np.float32)
        obs_valid[:P] = okf >= 0
        obs_cam[:P] = np.where(okf_c == k2, 1, 0)
        obs_uv[:P] = st.kf_xy[okf_c, oft_c]
        obs_s2[:P] = self.cfg.sigma2_table[st.kf_octave[okf_c, oft_c]]
        cam_T = np.tile(np.eye(4, dtype=np.float32), (C_pad, 1, 1))
        cam_T[0], cam_T[1] = st.kf_T[k1], st.kf_T[k2]
        fixed = np.ones(C_pad, bool)
        fixed[1] = False
        points = np.zeros((P_pad, 3), np.float32)
        points[:P] = st.pt_xyz[pt_ids]
        pvalid = np.zeros(P_pad, bool)
        pvalid[:P] = True
        prob = BAProblem(
            cam_T=jnp.asarray(cam_T),
            cam_fixed=jnp.asarray(fixed),
            points=jnp.asarray(points),
            point_valid=jnp.asarray(pvalid),
            obs_cam=jnp.asarray(obs_cam),
            obs_uv=jnp.asarray(obs_uv),
            obs_sigma2=jnp.asarray(obs_s2),
            obs_valid=jnp.asarray(obs_valid),
            intr=self._intr,
        )
        state = _ba_begin_j(prob)
        for _ in range(4):  # 20 LM iterations (GlobalBundleAdjustemnt(20))
            state = _ba_iterate_j(prob, state, n=5)
        res = fetch(_ba_result_j(prob, state))
        st.kf_T[k2] = np.asarray(res.cam_T[1])
        st.pt_xyz[pt_ids] = np.asarray(res.points)[:P]

    # ------------------------------------------------------------------ #
    # steady-state tracking (Tracking.cc:231-342)
    # ------------------------------------------------------------------ #
    def _track_frame(self, frame, fid, timestamp):
        if self.mirror is not None and self.pipelined:
            self._track_frame_pipelined(frame, fid, timestamp)  # locks inside
            return
        with self.lock:
            if self.mirror is not None:
                ok, Tcw, bind, n_inl = self._track_frame_device(frame)
            else:
                ok, Tcw, bind, n_inl = self._track_motion_model(frame)
                if not ok:
                    ok, Tcw, bind, n_inl = self._track_reference_kf(frame)
            if not ok:
                self._mark_lost(frame, fid, timestamp, self.last.Tcw,
                                info="pre_fail")
                return

            if self.mirror is None:
                Tcw, bind, n_inl = self._track_local_map(frame, Tcw, bind)
            self._finish_frame(frame, fid, timestamp, Tcw, bind, n_inl)

    def _mark_lost(self, frame, fid, timestamp, Tcw, info=""):
        self.loss_log.append((fid, info))
        self.state = TrackingState.LOST
        self.last = TrackedFrame(
            data=frame, Tcw=Tcw,
            bind=np.full(self.cfg.orb.n_features, -1, np.int64),
            frame_id=fid, timestamp=timestamp,
            octave=np.asarray(frame.feats.octave),
        )
        # Lost right after initialization: the young map is unreliable —
        # reset and re-initialize (Tracking.cc:327-335).
        if self.store.n_keyframes() <= 5:
            self.reset()

    def _finish_frame(self, frame, fid, timestamp, Tcw, bind, n_inl):
        """Post-local-map FSM tail: accept/lose, motion model, KF decision."""
        if n_inl < self.cfg.th.min_localmap_inliers:
            self._mark_lost(frame, fid, timestamp, Tcw,
                            info=f"localmap n_inl={n_inl}")
            return
        # Motion model update (Tracking.cc:278-283).
        if self.last is not None:
            self.velocity = Tcw @ np.linalg.inv(self.last.Tcw)
            self._prev_Tcw = self.last.Tcw
        self.last = TrackedFrame(
            data=frame, Tcw=Tcw, bind=bind, frame_id=fid, timestamp=timestamp,
            octave=np.asarray(frame.feats.octave) if self.mirror is None else None,
            n_inliers=n_inl,
        )
        self._record_trajectory(timestamp, fid, Tcw)
        if self._need_new_keyframe(n_inl, fid):
            self._create_new_keyframe(frame, fid, timestamp, bind)

    def _track_motion_model(self, frame):
        th = self.cfg.th
        if self.velocity is None or self.last is None:
            return self._track_reference_kf(frame)
        st = self.store
        ids = self.last.bind
        live = (ids >= 0) & st.pt_valid[np.clip(ids, 0, None)]
        safe = np.clip(ids, 0, None)
        pred_T = (self.velocity @ self.last.Tcw).astype(np.float32)

        for radius in (th.motion_search_radius, th.motion_search_radius_retry):
            T, bind, inlier, n, _ = tk.track_points(
                jnp.asarray(pred_T),
                jnp.asarray(st.pt_xyz[safe]),
                jnp.asarray(st.pt_desc[safe]),
                jnp.asarray(live),
                jnp.asarray(self.last.octave),
                jnp.asarray(st.pt_normal[safe]),
                jnp.asarray(st.pt_min_dist[safe]),
                jnp.asarray(st.pt_max_dist[safe]),
                jnp.zeros(self.cfg.orb.n_features, dtype=bool),
                jnp.zeros((self.cfg.orb.n_features, 3), jnp.float32),
                jnp.zeros(self.cfg.orb.n_features, dtype=bool),
                frame, self.cfg.camera, self._intr,
                jnp.float32(radius),
                scale_factor=self.cfg.orb.scale_factor,
                n_levels=self.cfg.orb.n_levels,
                use_frustum=False, ratio=0.9,
            )
            n = int(n)
            if n >= th.min_motion_inliers + 10:
                break
        if n < th.min_motion_inliers:
            return False, None, None, 0
        bind_np = np.asarray(bind)
        g_bind = np.where(bind_np >= 0, ids[np.clip(bind_np, 0, None)], -1)
        return True, np.asarray(T), g_bind, n

    def _track_reference_kf(self, frame):
        th = self.cfg.th
        if self.ref_kf < 0:
            return False, None, None, 0
        st = self.store
        kf = self.ref_kf
        obs_pt = st.kf_obs_point[kf]
        has_pt = (obs_pt >= 0) & st.pt_valid[np.clip(obs_pt, 0, None)]
        pt_xyz = st.pt_xyz[np.clip(obs_pt, 0, None)]
        T0 = self.last.Tcw if self.last is not None else np.eye(4, dtype=np.float32)
        T, bind, inlier, n = tk.track_reference_kf(
            jnp.asarray(T0.astype(np.float32)),
            jnp.asarray(st.kf_desc[kf]),
            jnp.asarray(has_pt),
            jnp.asarray(pt_xyz),
            jnp.asarray(st.kf_angle[kf]),
            frame, self._intr,
        )
        n = int(n)
        if n < th.min_refkf_inliers:
            return False, None, None, 0
        bind_np = np.asarray(bind)
        g_bind = np.where(bind_np >= 0, obs_pt[np.clip(bind_np, 0, None)], -1)
        return True, np.asarray(T), g_bind, n

    # ------------------------------------------------------------------ #
    # fused device frame path (tracking_fused.py): one dispatch, one sync
    # ------------------------------------------------------------------ #
    def _dispatch_fused(self, frame, last_T, prev_T, last_bind, last_octave,
                        has_vel, host_bind):
        """Dispatch the fused per-frame program (async). last_T/prev_T/
        last_bind/last_octave may be device arrays (pipelined chain) or
        host-built; host_bind is the newest host-materialized binding used
        for local-map candidate selection."""
        from . import tracking_fused

        if self._fused is None:
            self._fused = tracking_fused.make_fused_tracker(self.cfg)
        mir = self.mirror
        with self.timer("trk.local_select"):
            local_ids, local_valid = self._local_candidates(host_bind)
        out = self._fused(
            mir.pt_xyz, mir.pt_desc, mir.pt_valid, mir.pt_normal,
            mir.pt_min_dist, mir.pt_max_dist,
            mir.kf_desc, mir.kf_angle, mir.kf_obs_point,
            frame, self.cfg.camera, self._intr,
            last_T, prev_T, last_bind, last_octave,
            jnp.int32(max(self.ref_kf, 0)),
            jnp.bool_(self.ref_kf >= 0 and bool(self.store.kf_valid[self.ref_kf])),
            jnp.asarray(local_ids), jnp.asarray(local_valid),
            jnp.asarray(has_vel),
        )
        return out, local_ids

    def _apply_result(self, frame, fid, timestamp, out, local_ids):
        """Materialize one fused result and run the FSM tail for its frame.
        The device wait happens OUTSIDE the map lock; the host bookkeeping
        under it."""
        from . import tracking_fused

        st = self.store
        with self.timer("trk.readback"):
            host = tracking_fused.unpack_result(
                out["packed"], self.cfg.orb.n_features, self.cfg.th.max_local_points
            )
        with self.lock:
            if not bool(host["pre_ok"]):
                self._mark_lost(
                    frame, fid, timestamp, self.last.Tcw,
                    info=f"pre_fail n_pre={host['n_pre']} "
                         f"motion={host['used_motion']}",
                )
                return
            bind = host["bind"].astype(np.int64)
            # Binds may reference points culled by the mapping worker since
            # dispatch — drop them.
            bind = np.where((bind >= 0) & st.pt_valid[np.clip(bind, 0, None)], bind, -1)
            # Tracking stats for culling (MapPoint::IncreaseVisible/Found).
            # Frozen in localization-only mode: the map must stay untouched.
            if not self.only_tracking:
                st.pt_visible[local_ids[host["visible"]]] += 1
                st.pt_found[bind[bind >= 0]] += 1
            self._finish_frame(
                frame, fid, timestamp, host["Tcw"].astype(np.float32), bind,
                int(host["n_inliers"]),
            )

    def _track_frame_device(self, frame):
        """Synchronous fused frame: one dispatch, one readback. Returns
        (pre_ok, Tcw, bind, n_localmap_inliers) — pose/bind post-local-map."""
        has_vel = self.velocity is not None and self.last is not None
        prev = self._prev_Tcw if self._prev_Tcw is not None else self.last.Tcw
        out, local_ids = self._dispatch_fused(
            frame,
            jnp.asarray(self.last.Tcw.astype(np.float32)),
            jnp.asarray(prev.astype(np.float32)),
            jnp.asarray(self.last.bind.astype(np.int32)),
            self.last.data.feats.octave,
            has_vel, self.last.bind,
        )
        out["packed"].copy_to_host_async()  # announce before any other enqueue
        from . import tracking_fused

        host = tracking_fused.unpack_result(
            out["packed"], self.cfg.orb.n_features, self.cfg.th.max_local_points
        )
        if not bool(host["pre_ok"]):
            return False, None, None, 0
        bind = host["bind"].astype(np.int64)
        st = self.store
        if not self.only_tracking:
            st.pt_visible[local_ids[host["visible"]]] += 1
            st.pt_found[bind[bind >= 0]] += 1
        return True, host["Tcw"].astype(np.float32), bind, int(host["n_inliers"])

    # ------------------------------------------------------------------ #
    # pipelined frame path: dispatch frame N, process frame N-1
    # ------------------------------------------------------------------ #
    def _track_frame_pipelined(self, frame, fid, timestamp):
        """Pipelined tracking with up to ``pipeline_depth`` frames in flight:
        frame N's device programs run while the host handles frame
        N-depth's result — the device-side form of the reference's
        tracking-vs-mapping thread overlap. With a dispatch->result round
        trip of about two frames of device work, depth 2 makes throughput
        occupancy-bound instead of latency-bound (see pipeline_depth).
        Pose/bind chain device-to-device; the caller-visible (state, pose)
        lag `depth` frames."""
        with self.lock:
            ch = self._chain
            if ch is None:
                # First pipelined frame after init/reloc: seed from host state.
                prev = self._prev_Tcw if self._prev_Tcw is not None else self.last.Tcw
                ch = dict(
                    bind=jnp.asarray(self.last.bind.astype(np.int32)),
                    T=jnp.asarray(self.last.Tcw.astype(np.float32)),
                    prevT=jnp.asarray(prev.astype(np.float32)),
                    octave=self.last.data.feats.octave,
                    has_vel=self.velocity is not None,
                )
            out, local_ids = self._dispatch_fused(
                frame, ch["T"], ch["prevT"], ch["bind"], ch["octave"],
                ch["has_vel"], self.last.bind,
            )
        out["packed"].copy_to_host_async()
        self._chain = dict(
            bind=out["bind"], T=out["Tcw"], prevT=ch["T"],
            octave=frame.feats.octave, has_vel=True,
        )
        self._pending.append((frame, fid, timestamp, out, local_ids))
        # Young maps track on a short leash: right after initialization the
        # map covers a narrow view cone and every frame of FSM lag delays
        # the keyframes that extend it — on rotation-dominant motion a
        # depth-3 lag loses tracking before the map can grow. Full depth
        # engages once the map has some spatial extent.
        depth = self.pipeline_depth if self.store.n_keyframes() >= 8 else 1
        # Drain to the target depth (not one-per-frame): if the effective
        # depth shrinks (young-map leash re-engaging, runtime depth change)
        # the backlog must contract, or the FSM lag stays permanently high.
        while len(self._pending) > max(1, depth):
            oldest = self._pending.pop(0)
            self._apply_result(*oldest)
            if self.state != TrackingState.OK:
                # Chain poisoned: every in-flight frame tracked against a
                # lost pose — discard them and let the FSM recover.
                self._pending.clear()
                self._chain = None
                break

    def flush(self):
        """Drain the pipelined in-flight frames (end of stream / mode switch)."""
        while self._pending:
            pending = self._pending.pop(0)
            self._apply_result(*pending)
            if self.state != TrackingState.OK:
                self._pending.clear()
        self._chain = None

    def _local_candidates(self, bind):
        """Padded local-map candidate ids for the fused program: points of
        the covisibility neighborhood of the previous frame's bindings,
        always unioned with the reference keyframe's own points (they are
        the fallback path's match set)."""
        th = self.cfg.th
        st = self.store
        pts, _ = self._local_point_ids(bind)
        if self.ref_kf >= 0:
            rp = st.kf_obs_point[self.ref_kf]
            rp = rp[rp >= 0]
            rp = rp[st.pt_valid[rp]]
            pts = np.union1d(pts, rp)
        L = th.max_local_points
        ids = np.zeros(L, np.int32)
        valid = np.zeros(L, bool)
        m = min(len(pts), L)
        ids[:m] = pts[:m]
        valid[:m] = True
        return ids, valid

    def _local_point_ids(self, bind):
        """Local map = points seen by keyframes sharing points with the
        current frame + their best covisible neighbors (UpdateLocalKeyFrames/
        Points, Tracking.cc:838-967)."""
        st = self.store
        th = self.cfg.th
        tracked = np.unique(bind[bind >= 0])
        if len(tracked) == 0:
            return np.empty(0, np.int64), []
        obs_kf = st.pt_obs_kf[tracked]
        kf_counts = np.bincount(
            obs_kf[obs_kf >= 0], minlength=st.cfg.max_keyframes
        )
        k1 = np.nonzero(kf_counts)[0]
        # Sort by shared count, cap (Tracking.cc:913 max 80).
        k1 = k1[np.argsort(-kf_counts[k1], kind="stable")][: th.max_local_keyframes]
        local_kfs = set(int(k) for k in k1)
        if len(k1) > 0:
            best = int(k1[0])
            for nb in st.covisible_keyframes(best, top=10):
                local_kfs.add(int(nb))
        pts = st.kf_obs_point[sorted(local_kfs)]
        pts = np.unique(pts[pts >= 0])
        pts = pts[st.pt_valid[pts]]
        return pts[: th.max_local_points], sorted(local_kfs)

    def _track_local_map(self, frame, Tcw, bind):
        st = self.store
        th = self.cfg.th
        n_feat = self.cfg.orb.n_features
        local_pts, _ = self._local_point_ids(bind)
        P = th.max_local_points
        ids = np.full(P, 0, np.int64)
        valid = np.zeros(P, bool)
        m = min(len(local_pts), P)
        ids[:m] = local_pts[:m]
        # Exclude points already bound to this frame (reference skips
        # mnLastFrameSeen == current, Tracking.cc:795).
        already = np.isin(ids, bind[bind >= 0])
        valid[:m] = ~already[:m]

        prev_bound = bind >= 0
        prev_xyz = st.pt_xyz[np.clip(bind, 0, None)]

        T, lbind, inlier, n, visible = tk.track_points(
            jnp.asarray(Tcw.astype(np.float32)),
            jnp.asarray(st.pt_xyz[ids]),
            jnp.asarray(st.pt_desc[ids]),
            jnp.asarray(valid & st.pt_valid[ids]),
            jnp.zeros(P, jnp.int32),
            jnp.asarray(st.pt_normal[ids]),
            jnp.asarray(st.pt_min_dist[ids]),
            jnp.asarray(st.pt_max_dist[ids]),
            jnp.asarray(prev_bound),
            jnp.asarray(prev_xyz.astype(np.float32)),
            jnp.asarray(prev_bound),
            frame, self.cfg.camera, self._intr,
            jnp.float32(th.localmap_search_radius),
            scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels,
            use_frustum=True, ratio=0.8,
        )
        lbind_np = np.asarray(lbind)
        inlier_np = np.asarray(inlier)
        new_bind = np.where(
            lbind_np >= 0, ids[np.clip(lbind_np, 0, None)],
            np.where(prev_bound & inlier_np, bind, -1),
        )
        # Tracking stats for culling (MapPoint::IncreaseVisible/Found).
        vis_np = np.asarray(visible)
        if not self.only_tracking:
            st.pt_visible[ids[vis_np & valid]] += 1
            st.pt_found[new_bind[new_bind >= 0]] += 1
        return np.asarray(T), new_bind, int(n)

    # ------------------------------------------------------------------ #
    # keyframe decision / creation (Tracking.cc:697-779)
    # ------------------------------------------------------------------ #
    def _need_new_keyframe(self, n_inl, fid):
        th = self.cfg.th
        st = self.store
        # Localization-only mode never inserts keyframes (Tracking.cc:699-700).
        if self.only_tracking:
            return False
        if self.ref_kf < 0:
            return False
        # Fresh relocalization: hold off keyframe insertion for one max-frames
        # window when the map is already mature (Tracking.cc:709-710).
        if (fid < self.last_reloc_frame_id + th.kf_max_frames
                and st.n_keyframes() > th.kf_max_frames):
            return False
        # Reference matches are counted against points with >= 3 observations
        # (KeyFrame::TrackedMapPoints(3) when the map has > 2 KFs,
        # Tracking.cc:711-714) — weakly-observed points don't inflate n_ref.
        min_obs = 3 if st.n_keyframes() > 2 else 2
        obs = st.kf_obs_point[self.ref_kf]
        oc = np.clip(obs, 0, None)
        n_ref = int(
            ((obs >= 0) & st.pt_valid[oc] & (st.pt_n_obs[oc] >= min_obs)).sum()
        )
        c1 = fid >= self.last_kf_frame_id + th.kf_max_frames
        c2 = (n_inl < n_ref * th.kf_ref_ratio) and n_inl > th.kf_min_tracked
        # Baseline-over-depth staleness (not in the reference, which relies
        # on match decay alone): monocular accuracy needs the map extended
        # once the camera has moved a meaningful fraction of the scene depth
        # since the last keyframe — exactly the gate LocalMapping applies
        # before triangulating (LocalMapping.cc:219-223), applied here
        # prospectively so there is something to triangulate WITH.
        c3 = False
        if n_inl > th.kf_min_tracked:
            ids = self.last.bind
            ids = ids[ids >= 0]
            if len(ids) > 10:
                Tcw = self.last.Tcw
                pc_z = (
                    st.pt_xyz[ids] @ Tcw[:3, :3].T + Tcw[:3, 3]
                )[:, 2]
                md = float(np.median(pc_z[pc_z > 0])) if (pc_z > 0).any() else 0.0
                Ow_cur = -Tcw[:3, :3].T @ Tcw[:3, 3]
                Tkf = st.kf_T[self.ref_kf]
                Ow_kf = -Tkf[:3, :3].T @ Tkf[:3, 3]
                baseline = float(np.linalg.norm(Ow_cur - Ow_kf))
                c3 = md > 1e-6 and baseline / md > th.kf_baseline_depth_ratio
        # Rotation staleness (cfg.th.kf_view_angle_deg): pure rotation has
        # zero baseline, so c3 never fires and c2 fires only after matches
        # already collapsed — too late when the mapper runs a few frames
        # behind the tracker. Trigger on optical-axis divergence instead.
        c4 = False
        if n_inl > th.kf_min_tracked and self.ref_kf >= 0:
            z_cur = self.last.Tcw[2, :3]
            z_ref = st.kf_T[self.ref_kf][2, :3]
            cos_th = float(np.cos(np.deg2rad(th.kf_view_angle_deg)))
            c4 = float(np.dot(z_cur, z_ref)) < cos_th
        if not (c1 or c2 or c3 or c4):
            return False
        # A closure in flight pauses insertion (see loop_closing_active).
        if self.loop_closing_active is not None and self.loop_closing_active():
            return False
        # Backpressure (Tracking.cc:719,749-760): monocular keyframes are
        # only inserted when local mapping is idle; otherwise interrupt the
        # running BA and retry next frame.
        if self.mapping_idle is None or self.mapping_idle():
            return True
        if self.interrupt_ba is not None:
            self.interrupt_ba()
        return False

    def _create_new_keyframe(self, frame, fid, timestamp, bind):
        st = self.store
        if int((~st.kf_valid).sum()) == 0:
            return
        with self.timer("trk.create_kf"):
            # Pose + bindings only: the feature arrays stay ON DEVICE and
            # materialize on the mapping worker (System._worker_prepare) —
            # the reference defers the same per-feature bookkeeping to
            # LocalMapping::ProcessNewKeyFrame (LocalMapping.cc:125-153), so
            # the tracking thread never blocks on a device readback here.
            k = st.add_keyframe_pending(
                self.last.Tcw, frame_id=fid, timestamp=timestamp
            )
            f_idx = np.nonzero(bind >= 0)[0]
            p_ids = bind[f_idx]
            live = st.pt_valid[p_ids]
            st.add_observations(p_ids[live], np.full(int(live.sum()), k), f_idx[live])
            self.ref_kf = k
            self.last_kf_frame_id = fid
        # Start the d2h transfer of the packed feature arrays NOW (async, off
        # the critical path): by the time the mapping worker materializes
        # this keyframe, the ~53 KB pack has already reached the host
        # instead of queueing behind the next frames' device work.
        try:
            frame.host_pack.copy_to_host_async()
        except AttributeError:
            pass  # plain numpy in some test paths
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(k, frame=frame)

    # ------------------------------------------------------------------ #
    def _relocalize(self, frame, fid, timestamp):
        """LOST state: delegate to the relocalizer if wired (Tracking.cc:969).
        Without one (minimal pipeline), stay lost."""
        if self.relocalizer is None:
            return
        ok, Tcw, bind = self.relocalizer(frame)
        if ok:
            self.last = TrackedFrame(
                data=frame, Tcw=Tcw, bind=bind, frame_id=fid,
                timestamp=timestamp, octave=np.asarray(frame.feats.octave),
            )
            Tcw2, bind2, n = self._track_local_map(frame, Tcw, bind)
            if n >= self.cfg.th.min_localmap_inliers:
                self.last.Tcw = Tcw2
                self.last.bind = bind2
                self.velocity = None
                self._prev_Tcw = None
                self._chain = None
                self.last_reloc_frame_id = fid
                # The matched keyframe becomes the reference: the fallback
                # path tracks against ref_kf, and a stale (possibly culled)
                # pre-loss reference made every post-reloc frame fail with
                # n_pre=0 and immediately re-lose (reloc-storm loss_log
                # signature) — the reference re-derives mpReferenceKF from
                # the reloc frame's points (Tracking.cc:UpdateLocalKeyFrames).
                rk = getattr(self.relocalizer, "last_reloc_kf", -1)
                if rk >= 0 and self.store.kf_valid[rk]:
                    self.ref_kf = int(rk)
                self.state = TrackingState.OK
                self._record_trajectory(timestamp, fid, self.last.Tcw)

    def reset(self):
        """Full tracker reset (Tracking::Reset, Tracking.cc:1133-1175)."""
        self.state = TrackingState.NO_IMAGES_YET
        self.last = None
        self.init_ref = None
        self.velocity = None
        self._prev_Tcw = None
        self._chain = None
        self._pending = []
        self.ref_kf = -1
        self.last_kf_frame_id = 0
        self.store.__post_init__()  # clear all map arrays
        if self.on_reset is not None:
            self.on_reset()
