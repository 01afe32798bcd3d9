"""Loop closing: BoW detection with consistency groups, Sim3 computation,
loop correction + essential-graph optimization (reference LoopClosing.cc).

Runs synchronously after local mapping for each new keyframe (the reference
runs it on its own thread with a keyframe queue; the device programs are
identical — host pipelining is an orchestration concern).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import se3, sim3
from ..map.store import MapStore
from ..matching import core as mcore
from ..optim.pose_graph import optimize_pose_graph
from ..optim.sim3_opt import optimize_sim3
from ..solvers.sim3_solver import solve_sim3
from ..utils.transfer import announce, fetch
from ..vocab.database import KeyFrameDatabase
from .config import SlamConfig

MIN_MATCHES_SIM3 = 20  # LoopClosing.cc:269
MIN_INLIERS_SIM3 = 20  # LoopClosing.cc:297 / Optimizer nInliers >= 20
MIN_TOTAL_MATCHES = 40  # LoopClosing.cc:387
CONSISTENCY_TH = 3  # LoopClosing.cc:53 mnCovisibilityConsistencyTh
SIM3_CAP = 512  # padded match capacity (variable shapes would recompile)
PROJ_CAP = 4096  # padded loop-region point capacity for guided projection
# Essential-graph edge-count buckets (compile once per bucket; exact edge
# counts differ on every closure).
_EDGE_BUCKETS = np.array([256, 1024, 4096, 16384])


@jax.jit
def _sim3_candidate_program(
    # current keyframe (1): features + camera-frame coords of bound points
    desc1, bound1, angle1, xy1, oct1, feat_valid1, xyz1,
    # loop candidate keyframe (2)
    desc2, bound2, angle2, xy2, oct2, xyz2,
    # loop-region map points for the guided-projection gate
    region_desc, region_xyz, region_ok,
    T_lw, intr, sigma2_table, key,
):
    """The WHOLE ComputeSim3 pipeline for one loop candidate as ONE device
    program (LoopClosing.cc:234-405): BoW-gated feature matching -> Horn
    Sim3 RANSAC -> Sim3 LM refinement -> guided projection of the loop
    region through the corrected pose. The unfused version ran 4 dispatches
    with a host sync each — ~4 round trips per candidate, all under the map
    lock; here the host uploads snapshots, gets back one small
    result, and holds no lock while the device runs.

    Returns (head [35] float32: success, n_match, n_total, n_inliers,
    S12 flat 16, padding; f1 [SIM3_CAP]; f2 [SIM3_CAP]; pair_ok [SIM3_CAP]).
    """
    from ..features.orb import FrameFeatures
    from ..matching import matchers

    N = desc1.shape[0]
    cap = min(SIM3_CAP, N)  # small-N configs (tests) have N < SIM3_CAP
    res = _match_bound_features(desc1, bound1, angle1, desc2, bound2, angle2)
    n_match = jnp.sum(res.ok)

    # First `cap` matched features, in feature order (fixed shape).
    order = jnp.where(res.ok, N - jnp.arange(N, dtype=jnp.int32), 0)
    vals, f1 = jax.lax.top_k(order, cap)
    msel = vals > 0
    f1 = jnp.where(msel, f1, 0)
    f2 = jnp.where(msel, res.idx[f1], 0)

    zero = jnp.zeros((cap, 1), jnp.float32)
    x1 = jnp.where(msel[:, None], xyz1[f1], zero)
    x2 = jnp.where(msel[:, None], xyz2[f2], zero)
    uv1 = jnp.where(msel[:, None], xy1[f1], zero)
    uv2 = jnp.where(msel[:, None], xy2[f2], zero)
    s2_1 = jnp.where(msel, sigma2_table[oct1[f1]], 1.0)
    s2_2 = jnp.where(msel, sigma2_table[oct2[f2]], 1.0)

    ransac = solve_sim3(
        x1, x2, msel, uv1, uv2, s2_1, s2_2, intr, key,
        min_inliers=MIN_INLIERS_SIM3,
    )
    opt = optimize_sim3(
        ransac.S12, x1, x2, ransac.inliers & msel, uv1, uv2, s2_1, s2_2, intr
    )

    # Guided projection acceptance (LoopClosing.cc:341-389): project the
    # loop region's points into the current KF through the corrected pose
    # and count descriptor-consistent matches.
    S_cw = opt.S12 @ T_lw
    pc = region_xyz @ S_cw[:3, :3].T + S_cw[:3, 3]
    ok_depth = (pc[:, 2] > 0.05) & region_ok
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = jnp.where(jnp.abs(pc[:, 2]) < 1e-8, 1e-8, pc[:, 2])
    uv = jnp.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], 1)
    feats = FrameFeatures(
        xy=xy1, response=jnp.zeros(N), angle=angle1, octave=oct1,
        desc=desc1, valid=feat_valid1,
    )
    P = region_desc.shape[0]
    proj = matchers.search_by_projection(
        point_desc=region_desc, point_uv=uv, point_valid=ok_depth,
        point_octave=jnp.zeros(P, jnp.int32), feats=feats,
        radius=jnp.full(P, 8.0), ratio=1.0, max_dist=mcore.TH_LOW,
        octave_lo=-8, octave_hi=8,
    )
    n_total = jnp.sum(proj.ok)

    success = (
        (n_match >= MIN_MATCHES_SIM3)
        & ransac.success
        & (opt.n_inliers >= MIN_INLIERS_SIM3)
        & (n_total >= MIN_TOTAL_MATCHES)
    )
    head = jnp.zeros(35, jnp.float32)
    head = head.at[0].set(success.astype(jnp.float32))
    head = head.at[1].set(n_match.astype(jnp.float32))
    head = head.at[2].set(n_total.astype(jnp.float32))
    head = head.at[3].set(opt.n_inliers.astype(jnp.float32))
    head = head.at[4:20].set(opt.S12.reshape(-1))
    pair_ok = opt.inliers & msel
    return head, f1.astype(jnp.int32), f2.astype(jnp.int32), pair_ok


@jax.jit
def _match_bound_features(desc1, bound1, angle1, desc2, bound2, angle2):
    """Descriptor matching between point-bound features of two keyframes
    (the reference's SearchByBoW(KF, KF), ORBmatcher.cc:517-650)."""
    gate = bound1[:, None] & bound2[None, :]
    res = mcore.match_with_gate(desc1, desc2, gate, max_dist=mcore.TH_LOW, ratio=0.75)
    res = mcore.mutual_best(res, desc2.shape[0])
    return mcore.rotation_consistency(angle1, angle2, res)


@dataclass
class LoopCloser:
    cfg: SlamConfig
    store: MapStore
    db: KeyFrameDatabase
    run_global_ba: bool = True  # global BA after every corrected loop
    last_loop_kf: int = -100
    consistent_groups: list = field(default_factory=list)  # [(set, count)]
    loop_edges: list = field(default_factory=list)  # [(kf_a, kf_b)]
    n_loops_closed: int = 0
    # Async wiring (None in the synchronous pipeline): the map lock shared
    # with tracker/mapper, and the MappingWorker to stop during correction
    # (the reference's LocalMapping::RequestStop barrier before CorrectLoop,
    # LoopClosing.cc:413-431).
    lock: object = None  # threading.RLock | None
    mapping_worker: object = None
    on_map_updated: object = None  # callback() after async GBA writeback
    # True while a closure attempt is in flight (Sim3 candidates
    # snapshotted but the correction not yet applied/abandoned). The
    # tracker's keyframe gate consults this: a keyframe created in that
    # window exists in the PRE-correction world but is missed by the
    # correction's covisible-group walk, leaving it ~300 px inconsistent
    # after the map moves (the reference gets this for free — keyframe
    # insertion is gated on LocalMapping not being stopped, and CorrectLoop
    # stops it, Tracking.cc:719 / LoopClosing.cc:413-431).
    closing_active: bool = False
    # Called immediately after correct() applied (BEFORE the global BA):
    # the world just moved, so the mirror must republish and the tracker
    # re-anchor NOW — keyframes created while a chunked GBA runs against a
    # stale mirror carry pre-correction poses that the GBA's spanning-tree
    # propagation then composes with post-correction parents (observed:
    # a 46-unit keyframe teleport). Wired by System.
    on_corrected: object = None
    timer: object = None  # StageTimer | None
    # Distributed solver backend (parallel.backend.MeshBABackend), wired by
    # System when a mesh exists: global BA runs landmark-sharded, the
    # essential graph edge-sharded (BASELINE.json configs 4-5).
    mesh_backend: object = None

    def __post_init__(self):
        self._key = jax.random.PRNGKey(7)
        self._intr = jnp.asarray(self.cfg.intr)
        self._gba_thread = None  # transient GBA thread (LoopClosing.cc:584)
        self._stop_gba = False  # mbStopGBA (LoopClosing.cc:416-425)
        if self.lock is None:
            import contextlib

            self.lock = contextlib.nullcontext()
        if self.timer is None:
            from ..utils.profiling import StageTimer

            self.timer = StageTimer()

    # ------------------------------------------------------------------ #
    def process(self, kf: int, kf_count: int) -> bool:
        """Full loop-closing attempt for a new keyframe (synchronous drain
        of :meth:`process_steps`). Returns True if a loop was closed."""
        closed = False
        for closed in self.process_steps(kf, kf_count):
            pass
        return bool(closed)

    def process_steps(self, kf: int, kf_count: int):
        """The loop-closing attempt as a generator yielding at device
        dispatch->result boundaries (the cooperative scheduler's unit of
        interleave). Yields its running closed-a-loop flag; the final value
        is the attempt's outcome. Candidate-free keyframes (the common case)
        finish without ever yielding — detection is pure host work."""
        with self.lock:
            if not self.store.kf_valid[kf]:
                return  # culled before the loop stage got to it
            with self.timer("loop.detect"):
                candidates = self.detect(kf, kf_count)
            # Snapshot the per-candidate inputs under the lock; the Sim3
            # evaluation itself (one device program per candidate) runs
            # UNLOCKED — the tracker needs this lock every frame, and the
            # old in-lock evaluation was its largest p99 stall.
            snaps = [
                (int(c), self._snapshot_sim3(kf, int(c)))
                for c in candidates[:3]
            ]
            epoch0 = self.store.epoch
        if not snaps:
            return
        try:
            hits = []
            for cand, snap in snaps:
                with self.timer("loop.sim3"):
                    dev = self._dispatch_sim3(snap)
                    announce(dev)  # d2h in stream order
                yield False  # two intervals: the pipelined tracker keeps up
                yield False  # to pipeline_depth frames queued ahead
                with self.timer("loop.sim3"):
                    ok, S_cl, matched_pts = self._fetch_sim3(dev)
                if ok:
                    hits.append((cand, S_cl, matched_pts))
                    break
            if not hits:
                return
            with self.lock:
                if self.store.epoch != epoch0:
                    return  # system reset while the device ran
            cand, S_cl, matched_pts = hits[0]
            # A running global BA belongs to a previous (now superseded)
            # loop: abort and join it before correcting (LoopClosing.cc:
            # 416-425).
            with self.timer("loop.gba_abort"):
                self._abort_running_gba()
            # Quiesce local mapping before mutating the whole map — without
            # this barrier a mapper stage dispatched on pre-loop poses would
            # write back over the corrected ones (LoopClosing.cc:413-431).
            # The cooperative scheduler needs no barrier: mapping steps for
            # the next keyframe cannot start while this generator runs.
            with self.timer("loop.stop_barrier"):
                if self.mapping_worker is not None:
                    self.mapping_worker.request_stop()
                    self.mapping_worker.wait_stopped(timeout=60.0)
            try:
                with self.timer("loop.correct"), self.lock:
                    if self.store.kf_valid[kf] and self.store.kf_valid[cand]:
                        self.correct(kf, cand, S_cl, matched_pts)
                        self.last_loop_kf = kf_count
                        self.n_loops_closed += 1
            finally:
                if self.mapping_worker is not None:
                    self.mapping_worker.release()
            if self.on_corrected is not None:
                self.on_corrected()
        finally:
            self.closing_active = False
        if self.run_global_ba:
            if self.mapping_worker is None:
                # Cooperative/sync pipeline: chunked GBA on this thread,
                # deterministic (the sync drain runs it inline; the coop
                # scheduler spreads the chunks over subsequent frames).
                self._stop_gba = False
                yield from self._gba_steps()
            else:
                self._spawn_gba()  # threaded: detached (LoopClosing.cc:584)
        yield True

    # ------------------------------------------------------------------ #
    # Global bundle adjustment (RunGlobalBundleAdjustment, LoopClosing.cc:
    # 653-752): runs in a detached thread after every corrected loop,
    # abortable by the next loop, with correction propagation to keyframes
    # and points created while it solved.
    # ------------------------------------------------------------------ #
    def _abort_running_gba(self):
        t = self._gba_thread
        if t is not None and t.is_alive():
            self._stop_gba = True
            t.join(timeout=120.0)
        self._gba_thread = None

    def _spawn_gba(self):
        import threading

        self._stop_gba = False
        if self.mapping_worker is None:
            self._run_gba()  # synchronous pipeline: deterministic inline GBA
            return
        self._gba_thread = threading.Thread(
            target=self._run_gba, daemon=True, name="GlobalBA"
        )
        self._gba_thread.start()

    def _run_gba(self, iters: int = 20, chunk: int = 5):
        """Synchronous drain of :meth:`_gba_steps` (detached-thread body)."""
        for _ in self._gba_steps(iters=iters, chunk=chunk):
            pass

    def _gba_steps(self, iters: int = 20, chunk: int = 5):
        """Global BA as chunked generator steps: each 5-iteration LM chunk is
        dispatched, then the generator yields while the device solves —
        abortable between chunks by a newer loop (mbStopGBA semantics,
        LoopClosing.cc:672)."""
        from ..optim import ba_begin, ba_iterate, ba_result
        from .local_mapping import apply_global_ba, assemble_global_ba

        with self.lock:
            work = assemble_global_ba(self.store, self.cfg)
        if work is None:
            return
        prob, meta = work
        if self.mesh_backend is not None:
            # Landmark-sharded global BA over the mesh (configs 4-5).
            be = self.mesh_backend
            begin, it, result = be.begin, be.iterate, be.result
            prob = be.shard(prob)
        else:
            begin = jax.jit(ba_begin)
            _it = jax.jit(ba_iterate, static_argnames=("n",))
            it = lambda p, s, n: _it(p, s, n=n)
            result = jax.jit(ba_result)
        state = begin(prob)
        for _ in range(max(1, iters // chunk)):
            if self._stop_gba:
                return  # aborted by a newer loop (LoopClosing.cc:672)
            state = it(prob, state, chunk)
            yield  # chunks chain device-side; no host block (an abort can
            #       still skip every not-yet-dispatched chunk)
        dev = result(prob, state)
        announce(dev)  # d2h in stream order
        yield
        yield
        res = fetch(dev)
        if self._stop_gba:
            return
        # Stop local mapping while corrections propagate (LoopClosing.cc:686).
        if self.mapping_worker is not None:
            self.mapping_worker.request_stop()
            self.mapping_worker.wait_stopped(timeout=60.0)
        try:
            with self.lock:
                apply_global_ba(self.store, self.cfg, res, meta)
            if self.on_map_updated is not None:
                self.on_map_updated()
        finally:
            if self.mapping_worker is not None:
                self.mapping_worker.release()

    # ------------------------------------------------------------------ #
    def detect(self, kf: int, kf_count: int) -> np.ndarray:
        """DetectLoop (LoopClosing.cc:104-232): BoW candidates filtered by
        neighbor min-score and covisibility-consistency accumulation."""
        st = self.store
        if kf_count < self.last_loop_kf + 10:  # LoopClosing.cc:115
            return np.empty(0, np.int64)
        neighbors = st.covisible_keyframes(kf, min_weight=15)
        if len(neighbors) == 0:
            return np.empty(0, np.int64)

        bow_kf = self.db.bows[kf]
        if bow_kf is None:
            return np.empty(0, np.int64)
        # Minimum acceptable score: the worst covisible-neighbor similarity
        # (LoopClosing.cc:125-139).
        scores = [self.db.score_kf(bow_kf, int(n)) for n in neighbors]
        min_score = float(min(scores)) if scores else 0.0

        # Exclude EVERY keyframe sharing at least one point with kf — the
        # reference's spConnectedKeyFrames is the full weight map, not the
        # >=15 covisibility list (KeyFrame::GetConnectedKeyFrames;
        # KeyFrameDatabase.cc:78-96). Excluding only strong covisibles lets
        # weak-overlap TRAILING keyframes through as "loop" candidates on a
        # straight trajectory — false closures that cost a full correction +
        # essential graph + GBA each.
        connected = np.nonzero(st.covisibility_weights(kf) > 0)[0]
        exclude = np.concatenate([[kf], connected])
        cands = self.db.detect_loop_candidates(
            bow_kf, exclude=exclude, min_score=min_score,
            covis_fn=lambda k: st.covisible_keyframes(k, top=10),
        )
        if len(cands) == 0:
            self.consistent_groups = []
            return np.empty(0, np.int64)

        # Consistency groups (LoopClosing.cc:153-227).
        accepted = []
        new_groups = []
        group_used = [False] * len(self.consistent_groups)
        for c in cands:
            c = int(c)
            group = set(int(x) for x in st.covisible_keyframes(c, min_weight=15))
            group.add(c)
            best_count = 0
            for gi, (prev_set, prev_count) in enumerate(self.consistent_groups):
                if group & prev_set:
                    best_count = max(best_count, prev_count + 1)
                    group_used[gi] = True
            new_groups.append((group, best_count))
            if best_count >= CONSISTENCY_TH:
                accepted.append(c)
        self.consistent_groups = new_groups
        return np.array(accepted, np.int64)

    # ------------------------------------------------------------------ #
    def _snapshot_sim3(self, kf: int, cand: int) -> dict:
        """Host-side input snapshot for one loop candidate, taken under the
        map lock (fancy-indexed copies; ~300 KB). xyz1/xyz2 are the
        CAMERA-frame coordinates of the point bound to each feature (garbage
        for unbound features — the program gates on bound masks)."""
        st = self.store
        obs1 = st.kf_obs_point[kf]
        obs2 = st.kf_obs_point[cand]
        bound1 = (obs1 >= 0) & st.pt_valid[np.clip(obs1, 0, None)]
        bound2 = (obs2 >= 0) & st.pt_valid[np.clip(obs2, 0, None)]
        T1, T2 = st.kf_T[kf], st.kf_T[cand]
        xyz1 = st.pt_xyz[np.clip(obs1, 0, None)] @ T1[:3, :3].T + T1[:3, 3]
        xyz2 = st.pt_xyz[np.clip(obs2, 0, None)] @ T2[:3, :3].T + T2[:3, 3]

        # Loop-region map points (cand + its covisible neighborhood) for the
        # guided-projection gate (LoopClosing.cc:341-389).
        region = [cand] + [int(k) for k in st.covisible_keyframes(cand, top=10)]
        pts = st.kf_obs_point[region]
        pts = np.unique(pts[pts >= 0])
        pts = pts[st.pt_valid[pts]][:PROJ_CAP]
        n_real = len(pts)
        pts = np.concatenate([pts, np.zeros(PROJ_CAP - n_real, np.int64)])
        return dict(
            desc1=st.kf_desc[kf].copy(), bound1=bound1,
            angle1=st.kf_angle[kf].copy(), xy1=st.kf_xy[kf].copy(),
            oct1=st.kf_octave[kf].copy(),
            feat_valid1=st.kf_feat_valid[kf].copy(),
            xyz1=xyz1.astype(np.float32),
            desc2=st.kf_desc[cand].copy(), bound2=bound2,
            angle2=st.kf_angle[cand].copy(), xy2=st.kf_xy[cand].copy(),
            oct2=st.kf_octave[cand].copy(), xyz2=xyz2.astype(np.float32),
            region_desc=st.pt_desc[pts], region_xyz=st.pt_xyz[pts],
            region_ok=np.arange(PROJ_CAP) < n_real,
            T_lw=T2.astype(np.float32),
        )

    def _dispatch_sim3(self, snap: dict):
        """Dispatch the fused per-candidate Sim3 program (no blocking)."""
        self._key, sub = jax.random.split(self._key)
        return _sim3_candidate_program(
            **{k: jnp.asarray(v) for k, v in snap.items()},
            intr=self._intr,
            sigma2_table=jnp.asarray(self.cfg.sigma2_table),
            key=sub,
        )

    def _fetch_sim3(self, dev):
        """Block on a dispatched Sim3 program. Returns (ok, S_cl Sim3
        cand-camera -> kf-camera, matched pair array [N, 2])."""
        head, f1, f2, pair_ok = fetch(dev)
        if head[0] < 0.5:
            return False, None, None
        S_cl = head[4:20].reshape(4, 4).astype(np.float32)
        pairs = np.stack([f1[pair_ok], f2[pair_ok]], axis=1)
        return True, S_cl, pairs

    def _eval_sim3(self, snap: dict):
        """ComputeSim3 (LoopClosing.cc:234-405) for one snapshotted
        candidate: ONE device dispatch, one readback, no lock held."""
        return self._fetch_sim3(self._dispatch_sim3(snap))

    # ------------------------------------------------------------------ #
    def correct(self, kf: int, cand: int, S_cl: np.ndarray, pairs: np.ndarray):
        """CorrectLoop (LoopClosing.cc:407-592): propagate the Sim3
        correction over the current covisible group, fuse duplicate points,
        optimize the essential graph, record the loop edge."""
        st = self.store
        K = st.cfg.max_keyframes

        T_lw = st.kf_T[cand]
        S_cw_corr = (S_cl @ T_lw).astype(np.float32)  # Sim3 world -> current

        group = [kf] + [int(k) for k in st.covisible_keyframes(kf, min_weight=15)]
        # Every keyframe NEWER than the closing one joins the corrected
        # group: the cooperative Sim3 evaluation spans a few frames, and a
        # keyframe created in that window lives in the current (pre-
        # correction) neighborhood but may miss the >=15-covisibility walk —
        # left uncorrected it ends up ~300 px inconsistent once the map
        # moves (the reference cannot create keyframes during CorrectLoop at
        # all: insertion is gated on the stopped mapper, Tracking.cc:719).
        seq_kf = int(st.kf_seq[kf])
        for k in np.nonzero(st.kf_valid)[0]:
            k = int(k)
            if int(st.kf_seq[k]) > seq_kf and k not in group:
                group.append(k)
        old_T = {i: st.kf_T[i].copy() for i in group}
        corr_S = {}
        T_cur = st.kf_T[kf]
        for i in group:
            T_ic = old_T[i] @ np.linalg.inv(T_cur)  # SE3 current -> i
            corr_S[i] = (T_ic @ S_cw_corr).astype(np.float32)

        # Correct the group's map points through their first observing
        # group-keyframe (LoopClosing.cc:460-487). Batched per keyframe:
        # each keyframe's uncorrected points move through ONE pair of
        # affine transforms instead of a per-point Python loop (seconds at
        # reference point counts).
        corrected = np.zeros(st.cfg.max_points, bool)
        for i in group:
            obs = st.kf_obs_point[i]
            pids = np.unique(obs[obs >= 0])
            pids = pids[st.pt_valid[pids] & ~corrected[pids]]
            if len(pids) == 0:
                continue
            corrected[pids] = True
            S_new_inv = np.asarray(sim3.inverse(jnp.asarray(corr_S[i])))
            xc = st.pt_xyz[pids] @ old_T[i][:3, :3].T + old_T[i][:3, 3]
            st.pt_xyz[pids] = xc @ S_new_inv[:3, :3].T + S_new_inv[:3, 3]
        # Update group keyframe poses to the (scale-normalized) corrections.
        for i in group:
            st.kf_T[i] = np.asarray(sim3.to_se3(jnp.asarray(corr_S[i])))

        # Loop fusion: the matched pairs reference the same physical point —
        # replace the current-side point with the loop-side one
        # (LoopClosing.cc:525-541).
        obs_cur = st.kf_obs_point[kf]
        for fc, fl in pairs:
            p_cur = int(obs_cur[fc])
            p_loop = int(st.kf_obs_point[cand, fl])
            if p_cur == p_loop or p_cur < 0 or p_loop < 0:
                continue
            if not (st.pt_valid[p_cur] and st.pt_valid[p_loop]):
                continue
            # Move all observations of p_cur onto p_loop.
            for s in range(st.pt_n_obs[p_cur]):
                okf, oft = int(st.pt_obs_kf[p_cur, s]), int(st.pt_obs_feat[p_cur, s])
                if okf < 0:
                    continue
                st.kf_obs_point[okf, oft] = -1
                st.add_observation(p_loop, okf, oft)
            st.pt_valid[p_cur] = False
            st.pt_obs_kf[p_cur] = -1
            st.pt_obs_feat[p_cur] = -1
            st.pt_n_obs[p_cur] = 0

        # ----- essential graph -----
        live = np.nonzero(st.kf_valid)[0]
        S_nodes = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        S_nodes[live] = st.kf_T[live]
        for i in group:  # corrected nodes start from their Sim3 corrections
            S_nodes[i] = corr_S[i]

        edges = set()
        # Spanning tree: the maintained parent links (KeyFrame::GetParent,
        # the reference's essential-graph backbone, Optimizer.cc:655-670).
        for i in live:
            p = int(st.kf_parent[int(i)])
            if p >= 0 and st.kf_valid[p]:
                edges.add((p, int(i)))
        # Strong covisibility edges (minFeat = 100, Optimizer.cc:617).
        for i in live:
            w = st.covisibility_weights(int(i))
            for j in np.nonzero(w >= 100)[0]:
                if j > i:
                    edges.add((int(i), int(j)))
        # Loop edges (past + new).
        for a, b in self.loop_edges:
            if st.kf_valid[a] and st.kf_valid[b]:
                edges.add((min(a, b), max(a, b)))

        ei = np.array([e[0] for e in edges], np.int32)
        ej = np.array([e[1] for e in edges], np.int32)
        # Measurements from PRE-correction poses (NonCorrectedSim3) except
        # for edges inside the corrected group, which use corrected ones;
        # plus the new loop edge from the computed Sim3.
        pre = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        pre[live] = st.kf_T[live]
        for i in group:
            pre[i] = old_T[i]
        eS = np.einsum("eij,ejk->eik", pre[ej], np.linalg.inv(pre[ei]))
        ei = np.concatenate([ei, [np.int32(cand)]])
        ej = np.concatenate([ej, [np.int32(kf)]])
        eS = np.concatenate([eS, S_cw_corr[None] @ np.linalg.inv(st.kf_T[cand])[None]])

        fixed = np.zeros(K, bool)
        fixed[cand] = True  # LoopClosing fixes the loop keyframe (Opt.cc:620)

        # Pre-graph reference pose per KF for point remapping: group KFs'
        # points were ALREADY moved by the Sim3 correction, so their
        # reference is corr_S (the reference's CorrectedSim3 map), not the
        # pre-loop pose — using old_T here would double-correct them.
        old_pose_all = {int(i): st.kf_T[int(i)].copy() for i in live}
        old_pose_all.update({i: corr_S[i] for i in group})

        # Pad the edge arrays to a bucket size: the edge count differs on
        # every closure and an exact-shape call would recompile the whole
        # pose-graph program each time (seconds per compile).
        E = len(ei)
        E_pad = _EDGE_BUCKETS[np.searchsorted(_EDGE_BUCKETS, E)]
        evalid = np.arange(E_pad) < E
        ei = np.concatenate([ei, np.zeros(E_pad - E, np.int32)])
        ej = np.concatenate([ej, np.zeros(E_pad - E, np.int32)])
        eS = np.concatenate(
            [eS, np.tile(np.eye(4, dtype=np.float32), (E_pad - E, 1, 1))]
        )
        with self.timer("loop.essential"):
            if self.mesh_backend is not None:
                # Edge-sharded essential graph over the mesh (config 5).
                from jax.sharding import Mesh

                from ..parallel import distributed_pose_graph

                mesh = Mesh(self.mesh_backend.mesh.devices, ("edges",))
                S_opt = np.asarray(
                    distributed_pose_graph(
                        jnp.asarray(S_nodes),
                        jnp.asarray(st.kf_valid),
                        jnp.asarray(fixed),
                        jnp.asarray(ei), jnp.asarray(ej),
                        jnp.asarray(eS.astype(np.float32)),
                        jnp.asarray(evalid),
                        mesh=mesh, iters=20,
                    )
                )
            else:
                S_opt = np.asarray(
                    optimize_pose_graph(
                        jnp.asarray(S_nodes),
                        jnp.asarray(st.kf_valid),
                        jnp.asarray(fixed),
                        jnp.asarray(ei), jnp.asarray(ej),
                        jnp.asarray(eS.astype(np.float32)),
                        jnp.asarray(evalid),
                        iters=20,
                    )
                )
        # Write back poses and remap all points via their reference KF —
        # batched per keyframe (one affine transform over its uncorrected
        # points), matching Optimizer.cc:833-861's per-point remap.
        new_T = np.asarray(sim3.to_se3(jnp.asarray(S_opt)))
        pt_done = np.zeros(st.cfg.max_points, bool)
        for i in live:
            i = int(i)
            obs = st.kf_obs_point[i]
            pids = np.unique(obs[obs >= 0])
            pids = pids[st.pt_valid[pids] & ~pt_done[pids]]
            if len(pids) == 0:
                continue
            pt_done[pids] = True
            S_old_i = sim3.from_se3(jnp.asarray(old_pose_all[i]))
            corr = np.asarray(
                sim3.inverse(jnp.asarray(S_opt[i])) @ jnp.asarray(S_old_i)
            )
            st.pt_xyz[pids] = st.pt_xyz[pids] @ corr[:3, :3].T + corr[:3, 3]
        st.kf_T[live] = new_T[live]

        self.loop_edges.append((min(kf, cand), max(kf, cand)))
        st.update_point_derived(
            np.nonzero(pt_done)[0],
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels,
        )

        # Global BA runs AFTER correct() returns: detached + abortable in the
        # async pipeline, inline in the synchronous one (see _spawn_gba /
        # reference LoopClosing.cc:584).
