"""Local mapping back-end: point culling, new-point triangulation, local BA.

The reference's LocalMapping thread (LocalMapping.cc:46-110) run synchronously
per keyframe in this minimal pipeline (the host pipelining that restores the
reference's tracking/mapping overlap is an orchestration concern — the device
programs are identical either way).
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..map.store import MapStore
from ..optim import (
    BAProblem,
    ba_begin,
    ba_iterate,
    ba_reclassify,
    ba_result,
    run_ba,
)
from ..utils.profiling import StageTimer
from ..utils.transfer import announce, fetch
from . import tracking_kernels as tk
from .config import SlamConfig

# Bucketed padded problem shapes: compile-once per bucket instead of one
# worst-case 8192x64 shape (whose FLOPs AND 30s+ compile every local BA paid
# even for a ~1k-point local map). The smallest bucket covering the local
# map is used; typical maps stay in the first bucket.
P_BUCKETS = (2048, 8192)  # point capacity
C_BUCKETS = (32, 64)  # camera capacity
P_BA = P_BUCKETS[-1]
C_BA = C_BUCKETS[-1]

_ba_begin_j = jax.jit(ba_begin)
_ba_iterate_j = jax.jit(ba_iterate, static_argnames=("n",))
_ba_reclassify_j = jax.jit(ba_reclassify)
_ba_result_j = jax.jit(ba_result)


@functools.partial(jax.jit, static_argnames=("iters", "recls"))
def _run_ba_jit(prob, iters, recls):
    return run_ba(prob, iters=iters, reclassify_and_continue=recls)


def assemble_global_ba(store: MapStore, cfg: SlamConfig):
    """Snapshot the full-map BA problem (Optimizer::GlobalBundleAdjustemnt
    [sic], Optimizer.cc:41-46: all keyframes free except the first, all
    non-far points). Call under the map lock. Returns (prob, meta) or None."""
    cams = [int(k) for k in np.nonzero(store.kf_valid)[0]]
    if len(cams) < 2:
        return None
    # Padded bucket shapes (exact sizes would recompile on every call).
    K_cap = store.cfg.max_keyframes
    C = next(b for b in (32, 64, 128, 256, K_cap) if b >= len(cams))
    cam_slot = {c: i for i, c in enumerate(cams)}
    pts = np.nonzero(store.pt_valid & ~store.pt_far & (store.pt_n_obs >= 2))[0]
    pts = pts[: store.cfg.max_points]
    n_pts = len(pts)
    if n_pts < 20:
        return None
    P = next(b for b in (4096, store.cfg.max_points) if b >= n_pts)

    okf = store.pt_obs_kf[pts]
    oft = store.pt_obs_feat[pts]
    lookup = np.full(store.cfg.max_keyframes, -1, np.int32)
    for c, i in cam_slot.items():
        lookup[c] = i
    okf_c = np.clip(okf, 0, None)
    oft_c = np.clip(oft, 0, None)
    slots = lookup[okf_c]
    # Exclude observations in keyframes whose feature arrays are not yet
    # materialized (deferred keyframes: the worker/scheduler fills kf_xy
    # later, LocalMapping.cc:125-153 analogue) — their kf_xy rows are still
    # zeros and read as measurements at pixel (0,0), which sent a fresh
    # keyframe 46 units away in a post-loop GBA.
    valid = (okf >= 0) & (slots >= 0) & store.kf_feat_valid[okf_c, oft_c]

    fixed = np.ones(C, bool)  # padding slots stay fixed at identity
    fixed[: len(cams)] = False
    # Gauge: the TWO oldest keyframes by insertion seq. The reference fixes
    # only keyframe 0 (Optimizer.cc:120) and relies on g2o staying near the
    # initialization along the free monocular-scale direction; this solver
    # measurably wanders it (a post-loop GBA rescaled the whole map ~2.5x,
    # which breaks every scale-relative anchor recorded before it), so the
    # second-oldest keyframe pins scale exactly as the local BA's
    # no-boundary gauge does.
    by_age = sorted(cams, key=lambda c: int(store.kf_seq[c]))
    fixed[cam_slot[by_age[0]]] = True
    if len(by_age) > 1:
        fixed[cam_slot[by_age[1]]] = True
    # A camera with (almost) no surviving observations in the problem is
    # unconstrained — the LM step sends it arbitrarily far (observed: a
    # fresh keyframe whose points were all filtered teleported 46 units).
    # Such cameras stay fixed at their current pose.
    n_obs_cam = np.bincount(slots[valid].ravel(), minlength=C)
    for c, i in cam_slot.items():
        if n_obs_cam[i] < 6:
            fixed[i] = True
    cam_T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_T[: len(cams)] = store.kf_T[cams]
    M = store.cfg.max_obs_per_point
    obs_cam = np.zeros((P, M), np.int32)
    obs_uv = np.zeros((P, M, 2), np.float32)
    obs_s2 = np.ones((P, M), np.float32)
    obs_valid = np.zeros((P, M), bool)
    obs_cam[:n_pts] = np.where(valid, slots, 0)
    obs_uv[:n_pts] = store.kf_xy[okf_c, oft_c]
    obs_s2[:n_pts] = cfg.sigma2_table[store.kf_octave[okf_c, oft_c]]
    obs_valid[:n_pts] = valid
    points = np.zeros((P, 3), np.float32)
    points[:n_pts] = store.pt_xyz[pts]
    pvalid = np.zeros(P, bool)
    pvalid[:n_pts] = True

    prob = BAProblem(
        cam_T=jnp.asarray(cam_T),
        cam_fixed=jnp.asarray(fixed),
        points=jnp.asarray(points),
        point_valid=jnp.asarray(pvalid),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.asarray(obs_uv),
        obs_sigma2=jnp.asarray(obs_s2),
        obs_valid=jnp.asarray(obs_valid),
        intr=jnp.asarray(cfg.intr),
    )
    meta = dict(cams=cams, cam_slot=cam_slot, pts=pts, okf=okf, valid=valid,
                fixed=fixed, old_T=store.kf_T[cams].copy(), epoch=store.epoch,
                cam_seq={c: int(store.kf_seq[c]) for c in cams})
    return prob, meta


def apply_global_ba(store: MapStore, cfg: SlamConfig, res, meta) -> None:
    """Write GBA results back and PROPAGATE corrections to keyframes and
    points created while it ran, through the spanning tree — the reference's
    RunGlobalBundleAdjustment tail (LoopClosing.cc:690-750). Call under the
    map lock with local mapping stopped."""
    if store.epoch != meta["epoch"]:
        return
    cams, cam_slot, fixed = meta["cams"], meta["cam_slot"], meta["fixed"]
    pts, okf = meta["pts"], meta["okf"]
    # ABA guard: the solve is chunked over several frames in the
    # cooperative pipeline; a keyframe culled meanwhile may have had its
    # slot RE-ALLOCATED (lowest-first) to a brand-new keyframe. Writing the
    # solved pose into the new occupant teleports it into the old world
    # (observed: a 46-unit trajectory anchor). Identity is (slot, kf_seq).
    cam_seq = meta["cam_seq"]
    still = {c for c in cams
             if store.kf_valid[c] and int(store.kf_seq[c]) == cam_seq[c]}
    in_prob_kf = np.zeros(store.cfg.max_keyframes, bool)
    in_prob_kf[list(still)] = True
    old_pose = {c: meta["old_T"][i] for c, i in cam_slot.items() if c in still}
    new_T = np.asarray(res.cam_T)

    # New keyframes (inserted during the solve): correct via the spanning
    # tree, child pose composed with its parent's correction
    # (LoopClosing.cc:690-720: Tchildc = Tchild * Twc(parent) * TcwGBA(parent)).
    # Parents always predate children, so one ascending-AGE pass suffices
    # (age = kf_seq; slot ids recycle and frame ids can collide post-merge).
    corrected = {c: new_T[i] for c, i in cam_slot.items() if c in still}
    live = np.nonzero(store.kf_valid)[0]
    live = live[np.argsort(store.kf_seq[live], kind="stable")]
    for k in live:
        k = int(k)
        if in_prob_kf[k]:
            continue
        p = int(store.kf_parent[k])
        if p < 0 or (p not in corrected) or (p not in old_pose):
            continue
        T_old_p = old_pose[p]
        T_rel = store.kf_T[k] @ np.linalg.inv(T_old_p)
        corrected[k] = (T_rel @ corrected[p]).astype(np.float32)
        old_pose[k] = store.kf_T[k].copy()

    for k, T in corrected.items():
        if not (k in cam_slot and fixed[cam_slot[k]]) and store.kf_valid[k]:
            store.kf_T[k] = T

    # Points in the problem take their optimized positions; points created
    # during the solve move with their first observing keyframe's correction
    # (LoopClosing.cc:724-748).
    alive = store.pt_valid[pts]
    store.pt_xyz[pts[alive]] = np.asarray(res.points)[: len(pts)][alive]
    in_prob_pt = np.zeros(store.cfg.max_points, bool)
    in_prob_pt[pts] = True
    others = np.nonzero(store.pt_valid & ~in_prob_pt)[0]
    if len(others):
        # Batched per reference keyframe: every point created during the
        # solve moves with its first observer's correction in one affine
        # transform (LoopClosing.cc:724-748; O(points) Python loops here
        # were seconds at 16k points).
        refs = store.pt_obs_kf[others, 0]
        for ref in np.unique(refs):
            ref = int(ref)
            if ref < 0 or ref not in corrected or ref not in old_pose:
                continue
            sel = others[refs == ref]
            T_old, T_new = old_pose[ref], corrected[ref]
            xc = store.pt_xyz[sel] @ T_old[:3, :3].T + T_old[:3, 3]
            store.pt_xyz[sel] = (xc - T_new[:3, 3]) @ T_new[:3, :3]

    # Outlier erase for observations that stayed in the problem (only
    # against keyframes whose slot identity survived — see ABA guard).
    inl = np.asarray(res.obs_inlier)[: len(pts)]
    okf_still = np.isin(okf, list(still)) if still else np.zeros_like(okf, bool)
    out_i, out_s = np.nonzero(meta["valid"] & ~inl & alive[:, None] & okf_still)
    store.remove_observations(pts[out_i], okf[out_i, out_s])
    dead = pts[alive & (store.pt_n_obs[pts] < 2)]
    if len(dead):
        store.cull_points(dead)


def global_bundle_adjustment(store: MapStore, cfg: SlamConfig, iters: int = 20) -> None:
    """Synchronous full-map BA (assemble + solve + apply in one call)."""
    work = assemble_global_ba(store, cfg)
    if work is None:
        return
    prob, meta = work
    res = fetch(run_ba(prob, iters=iters))
    apply_global_ba(store, cfg, res, meta)


@dataclass
class LocalMapper:
    cfg: SlamConfig
    store: MapStore
    timer: StageTimer = field(default_factory=StageTimer)
    # Map lock (the reference's Map::mMutexMapUpdate): every store mutation
    # and every read of mutable store state happens under it. Device solves
    # run OUTSIDE it — each stage assembles inputs under the lock, dispatches,
    # releases, blocks on the device, then re-takes it to write back.
    lock: "threading.RLock" = field(default_factory=lambda: __import__("threading").RLock())
    # Called (under the lock) after a mutation phase that changed point
    # slots, so the device mirror stays consistent with the host store at
    # every lock boundary. Wired by System to DeviceMirror.refresh_points.
    publish_points = None

    on_cull_keyframe = None  # callback(kf_id), wired by System (db.erase)
    # BA preemption flag (reference mbAbortBA, LocalMapping.cc:116): set by
    # the tracker's InterruptBA when a new keyframe wants in; checked between
    # LM chunks so the running local BA yields within one chunk.
    abort_ba: bool = False
    # Backpressure toward the tracker (SetAcceptKeyFrames,
    # LocalMapping.cc:53,101): False while a keyframe is being processed.
    accept_keyframes: bool = True
    ba_iters: int = 0  # LM iterations executed (for the BA iters/s metric)
    # Deferred-keyframe counter for the bounded drain gate in process():
    # heavy stages (fuse + local BA) run at the latest every
    # cfg.th.ba_debt_max keyframes even if the queue never empties
    # (0 = pure drain gating, the reference's LocalMapping.cc:72 behavior).
    _ba_debt: int = 0
    # Tracker's live reference keyframe (wired by System): excluded from
    # keyframe culling — see cull_keyframes.
    protected_kf_fn = None  # callable() -> int | None
    # Runtime far-point parallax knob: finite triangulations with parallax
    # cosine above this are classed umbralCosBajo (the reference's viewer
    # trackbar parameter, Viewer.cc:133 -> LocalMapping.cc:202-204;
    # 0.9998 disables the band, matching param >= 998).
    far_cos_user: float = 0.9998
    # Queue-pressure probe (wired to MappingWorker.queue_size in async mode):
    # the reference runs SearchInNeighbors and local BA ONLY when no further
    # keyframes wait (LocalMapping.cc:72 CheckNewKeyFrames gates) — under a
    # burst, each keyframe gets culling + triangulation and the heavy stages
    # run when the queue drains.
    pending_fn = None  # callable() -> int | None
    # Device mirror (map.mirror.DeviceMirror), wired by System. When set,
    # triangulation and fusion gather keyframe feature rows and the point
    # slice FROM the mirror by index (tk.triangulate_mirror_batch /
    # tk.fuse_mirror_batch) instead of uploading the gathered rows — ~60 KB
    # vs ~1 MB (tri) and ~100 KB vs ~3.5 MB (fuse) per keyframe event.
    # Array refs are captured under the map lock (jnp
    # arrays are immutable, so the captured refs are consistent snapshots).
    mirror = None
    # Distributed solver backend (parallel.backend.MeshBABackend), wired by
    # System when more than one device exists: local BA and global BA run
    # landmark-sharded over the mesh with one psum per LM iteration
    # (BASELINE.json config 4). None -> single-device jits below.
    mesh_backend = None

    def _ba_fns(self):
        """(shard, begin, iterate, reclassify, result) — the resumable BA
        protocol, single-device or mesh-sharded."""
        be = self.mesh_backend
        if be is None:
            return (
                lambda p: p, _ba_begin_j,
                lambda p, s, n: _ba_iterate_j(p, s, n=n),
                _ba_reclassify_j, _ba_result_j,
            )
        return be.shard, be.begin, be.iterate, be.reclassify, be.result

    def warmup(self) -> None:
        """Compile every bucketed device program this mapper can hit (local
        BA shape buckets, fuse candidate buckets, the triangulation batch).
        With the persistent XLA cache this is a one-time per-machine cost;
        without it a bucket first hit mid-run stalls mapping for its full
        compile time (30 s+) and tracking outruns the stale map."""
        cfg = self.cfg
        st = self.store
        N = cfg.orb.n_features
        M = st.cfg.max_obs_per_point
        intr = jnp.asarray(cfg.intr)
        for P_pad in P_BUCKETS:
            for C_pad in C_BUCKETS:
                prob = BAProblem(
                    cam_T=jnp.tile(jnp.eye(4), (C_pad, 1, 1)),
                    cam_fixed=jnp.zeros(C_pad, bool).at[0].set(True),
                    points=jnp.ones((P_pad, 3)).at[:, 2].set(5.0),
                    point_valid=jnp.ones(P_pad, bool),
                    obs_cam=jnp.zeros((P_pad, M), jnp.int32),
                    obs_uv=jnp.full((P_pad, M, 2), 320.0),
                    obs_sigma2=jnp.ones((P_pad, M)),
                    obs_valid=jnp.zeros((P_pad, M), bool),
                    intr=intr,
                )
                shard, begin, iterate, reclassify, result = self._ba_fns()
                prob = shard(prob)
                state = begin(prob)
                state = iterate(prob, state, 5)
                state = reclassify(prob, state)
                jax.block_until_ready(result(prob, state))
        K33 = jnp.asarray(
            np.array([[cfg.intr[0], 0, cfg.intr[2]],
                      [0, cfg.intr[1], cfg.intr[3]], [0, 0, 1]], np.float32)
        )
        NB = cfg.th.triangulation_neighbors
        T_cap = self._T_FUSE
        mir = self.mirror
        if mir is not None:
            # Device-side BA assembly at both point buckets.
            for P_pad in P_BUCKETS:
                for C_pad in C_BUCKETS:
                    jax.block_until_ready(tk.assemble_ba_mirror(
                        mir.pt_xyz, mir.pt_obs_kf, mir.pt_obs_feat,
                        mir.kf_xy, mir.kf_octave, mir.kf_feat_valid,
                        jnp.zeros(P_pad, jnp.int32), jnp.zeros(P_pad, bool),
                        jnp.tile(jnp.eye(4), (C_pad, 1, 1)),
                        jnp.full(st.cfg.max_keyframes, -1, jnp.int32),
                        jnp.asarray(cfg.sigma2_table), intr,
                    )[0])
            # The live path gathers rows/points from the mirror by index.
            jax.block_until_ready(tk.triangulate_mirror_batch(
                jnp.eye(4), jnp.tile(jnp.eye(4), (NB, 1, 1)),
                jnp.int32(0), jnp.zeros(NB, jnp.int32),
                mir.kf_xy, mir.kf_angle, mir.kf_octave, mir.kf_desc,
                jnp.zeros(N, bool), jnp.zeros((NB, N), bool),
                K33, jnp.asarray(cfg.sigma2_table), jnp.float32(5.0),
                enable_far=cfg.enable_far_points,
            ))
            L_cap = 2 * self._T_FUSE
            jax.block_until_ready(tk.fuse_pairs_mirror(
                jnp.tile(jnp.eye(4), (L_cap, 1, 1)),
                jnp.zeros(L_cap, jnp.int32), jnp.zeros(L_cap, jnp.int32),
                jnp.zeros(L_cap, bool),
                mir.kf_xy, mir.kf_angle, mir.kf_octave, mir.kf_desc,
                mir.kf_feat_valid, mir.kf_obs_point,
                mir.pt_xyz, mir.pt_desc, mir.pt_max_dist,
                mir.pt_valid, mir.pt_obs_kf,
                intr, jnp.float32(cfg.camera.width),
                jnp.float32(cfg.camera.height),
                jnp.float32(cfg.orb.scale_factor), n_levels=cfg.orb.n_levels,
            ))
        else:
            jax.block_until_ready(tk.triangulate_with_neighbors_batch(
                jnp.eye(4), jnp.tile(jnp.eye(4), (NB, 1, 1)),
                jnp.zeros((N, 2)), jnp.zeros((N, 8), jnp.uint32),
                jnp.zeros(N), jnp.zeros(N, jnp.int32), jnp.zeros(N, bool),
                jnp.zeros((NB, N, 2)), jnp.zeros((NB, N, 8), jnp.uint32),
                jnp.zeros((NB, N)), jnp.zeros((NB, N), jnp.int32),
                jnp.zeros((NB, N), bool),
                K33, jnp.asarray(cfg.sigma2_table), jnp.float32(5.0),
                enable_far=cfg.enable_far_points,
            ))
            for C in self._FUSE_BUCKETS:
                jax.block_until_ready(tk.fuse_batch(
                    jnp.tile(jnp.eye(4), (T_cap, 1, 1)),
                    jnp.zeros((T_cap, N, 2)), jnp.zeros((T_cap, N)),
                    jnp.zeros((T_cap, N), jnp.int32),
                    jnp.zeros((T_cap, N, 8), jnp.uint32),
                    jnp.zeros((T_cap, N), bool),
                    jnp.zeros((T_cap, C), jnp.int32), jnp.zeros((T_cap, C), bool),
                    jnp.ones((2 * C, 3)), jnp.zeros((2 * C, 8), jnp.uint32),
                    jnp.full(2 * C, 100.0),
                    intr, jnp.float32(cfg.camera.width), jnp.float32(cfg.camera.height),
                    jnp.float32(cfg.orb.scale_factor), n_levels=cfg.orb.n_levels,
                ))

    def _publish(self) -> None:
        """Push mutated point state to the device mirror (called under the
        map lock, so tracker dispatches always see store-consistent device
        state)."""
        if self.publish_points is not None:
            self.publish_points()

    def process(self, kf: int, bootstrap: bool = False) -> None:
        """Full local-mapping pass for a newly inserted keyframe
        (LocalMapping::Run body, LocalMapping.cc:58-88). Drains the step
        generator synchronously — inline and worker-thread modes run the
        identical stage sequence the cooperative scheduler interleaves."""
        for _ in self.process_steps(kf, bootstrap=bootstrap):
            pass

    def process_steps(self, kf: int, bootstrap: bool = False):
        """The local-mapping pass as a generator that yields at every
        dispatch->result boundary: the device crunches the dispatched stage
        while the caller returns to per-frame tracking, and the next step()
        picks up the (by then ready) result. This is the device-side form of
        the reference's tracking/mapping thread overlap (LocalMapping.cc:
        46-110) WITHOUT threads: one host thread, a deterministic interleave,
        and the device as the only concurrency."""
        if bootstrap:
            return  # the initial map was just globally optimized
        t = self.timer
        with t("lm.cull_points"), self.lock:
            # First covisibility update assigns the spanning-tree parent
            # (KeyFrame::UpdateConnections, KeyFrame.cc:383-391).
            self.store.update_spanning_tree(kf)
            self.cull_recent_points(kf)
            self._publish()
        yield from self.create_new_points_steps(kf)
        # The reference runs fuse + local BA only when no further keyframes
        # wait (LocalMapping.cc:72 CheckNewKeyFrames gates). On one card
        # the mapper shares the device with the tracker, so under sustained
        # load the queue is rarely empty and a pure drain gate starves BA
        # entirely (poses then drift unoptimized). Bound the deferral: after
        # cfg.th.ba_debt_max deferred keyframes the heavy stages run
        # regardless — the tracker's interrupt_ba can still preempt the LM
        # chunks.
        self._ba_debt += 1
        debt_max = self.cfg.th.ba_debt_max
        forced = debt_max > 0 and self._ba_debt >= debt_max
        if not forced and self.pending_fn is not None and self.pending_fn():
            return  # more keyframes waiting: heavy stages when queue drains
        yield from self.search_in_neighbors_steps(kf)
        if not forced and self.pending_fn is not None and self.pending_fn():
            return
        self._ba_debt = 0
        yield from self.local_ba_steps(kf)
        with t("lm.cull_kfs"), self.lock:
            self.cull_keyframes(kf)
            self._publish()

    # ------------------------------------------------------------------ #
    def cull_recent_points(self, kf: int) -> None:
        """MapPointCulling (LocalMapping.cc:155-186): drop points with poor
        found/visible ratio or too few observations soon after creation."""
        st = self.store
        th = self.cfg.th
        # Age in KEYFRAMES-SINCE-CREATION via the monotonic sequence number
        # (slot ids recycle; the reference's mnFirstKFid/mnId are monotonic).
        # pt_first_seq records the creating keyframe's kf_seq directly at
        # point creation — dereferencing kf_seq through a recyclable slot id
        # misclassified mature points as recent after keyframe culls.
        seq_now = st.kf_seq[kf]
        first_seq = st.pt_first_seq
        recent = st.pt_valid & (first_seq >= seq_now - 3)
        ratio_bad = recent & (st.pt_visible > 0) & (
            st.pt_found < th.point_cull_found_ratio * st.pt_visible
        )
        age = seq_now - first_seq
        obs_bad = recent & (age >= 2) & (st.pt_n_obs <= 2)
        bad = np.nonzero(ratio_bad | obs_bad)[0]
        if len(bad):
            st.cull_points(bad)

    # ------------------------------------------------------------------ #
    def create_new_points(self, kf: int) -> None:
        for _ in self.create_new_points_steps(kf):
            pass

    def create_new_points_steps(self, kf: int):
        """Triangulate new map points against covisible neighbors
        (LocalMapping::CreateNewMapPoints, LocalMapping.cc:188-367).

        Structure: snapshot store inputs under the map lock, dispatch the
        device program unlocked, YIELD while it runs, write back under the
        lock."""
        st = self.store
        cfg = self.cfg
        NB = cfg.th.triangulation_neighbors
        with self.timer("lm.tri.snap"), self.lock:
            neighbors = st.covisible_keyframes(kf, top=NB)
            if len(neighbors) == 0:
                return
            # Median depth of the new keyframe's own points (baseline gate).
            own = st.kf_obs_point[kf]
            own = np.unique(own[own >= 0])
            if len(own) == 0:
                return
            own_z = (st.pt_xyz[own] @ st.kf_T[kf][:3, :3].T + st.kf_T[kf][:3, 3])[:, 2]
            md = float(np.median(own_z[own_z > 0])) if (own_z > 0).any() else 0.0
            if md <= 1e-6:
                return

            # Pad the neighbor list to a fixed batch (padding = the keyframe
            # itself: zero baseline, auto-rejected).
            nbs = [int(n) for n in neighbors[:NB]]
            pad = [kf] * (NB - len(nbs))
            all_nb = np.array(nbs + pad, np.int64)
            unbound_new = st.kf_feat_valid[kf] & (st.kf_obs_point[kf] < 0)
            if unbound_new.sum() < 10:
                return
            unbound_nb = st.kf_feat_valid[all_nb] & (st.kf_obs_point[all_nb] < 0)
            epoch0 = st.epoch
            mir = self.mirror
            if mir is not None:
                # Mirror-gather path: upload only poses + masks + indices;
                # the feature rows (static after insertion) are gathered
                # on device. Publish-then-capture under the lock makes the
                # captured refs EXACTLY the host state (the diff publish is
                # a cheap no-op when already clean) — the cross-file
                # republish invariant the advisor flagged is now enforced
                # here rather than assumed.
                self._publish()
                mir_rows = (mir.kf_xy, mir.kf_angle, mir.kf_octave,
                            mir.kf_desc)
                snap = (st.kf_T[kf].copy(), st.kf_T[all_nb],
                        unbound_new, unbound_nb)
            else:
                # Snapshot copies (fancy indexing copies; [kf] rows copied
                # explicitly) so the dispatch below needs no lock.
                snap = (
                    st.kf_T[kf].copy(), st.kf_T[all_nb],
                    st.kf_xy[kf].copy(), st.kf_desc[kf].copy(),
                    st.kf_angle[kf].copy(), st.kf_octave[kf].copy(), unbound_new,
                    st.kf_xy[all_nb], st.kf_desc[all_nb],
                    st.kf_angle[all_nb], st.kf_octave[all_nb], unbound_nb,
                )

        K = jnp.asarray(
            np.array(
                [
                    [cfg.intr[0], 0, cfg.intr[2]],
                    [0, cfg.intr[1], cfg.intr[3]],
                    [0, 0, 1],
                ],
                np.float32,
            )
        )
        sigma2 = jnp.asarray(cfg.sigma2_table)
        with self.timer("lm.tri.dispatch"):
            if mir is not None:
                T_new, T_nb, unbound_new, unbound_nb = snap
                dev = tk.triangulate_mirror_batch(
                    jnp.asarray(T_new), jnp.asarray(T_nb),
                    jnp.int32(kf), jnp.asarray(all_nb.astype(np.int32)),
                    *mir_rows,
                    jnp.asarray(unbound_new), jnp.asarray(unbound_nb),
                    K, sigma2, jnp.float32(md),
                    enable_far=cfg.enable_far_points,
                )
            else:
                dev = tk.triangulate_with_neighbors_batch(
                    *(jnp.asarray(a) for a in snap),
                    K, sigma2, jnp.float32(md),
                    enable_far=cfg.enable_far_points,
                )
            # Announce the d2h NOW: a GET first issued at the fetch step
            # (a frame later) would queue behind everything dispatched in
            # between (utils/transfer.py transport discipline).
            announce(dev)
        # ONE interval only for triangulation: its fetch eats a partial
        # stall (the stage sits behind ~pipeline_depth frames of queued
        # tracker work), but map extension is the latency-critical stage —
        # on rotation-dominant motion (~2 deg/frame) each extra frame of
        # tri latency is ~2 degrees of map staleness, and the loop circuit
        # lost tracking with two-interval pacing here. Fuse/BA keep the
        # two-interval schedule (their staleness is benign).
        yield
        with self.timer("lm.tri.fetch"):
            if mir is not None:
                # Compacted readback (~26 KB; transfer announced at
                # dispatch — utils/transfer.py transport note), unpacked
                # back to the dense [NB, N] apply layout on host.
                code, pts_c, far_c, nbf_c, cosp_c = fetch(dev)
                NB_, N_ = len(all_nb), self.cfg.orb.n_features
                acc = np.zeros((NB_, N_), bool)
                pts_np = np.zeros((NB_, N_, 3), np.float32)
                far_np = np.zeros((NB_, N_), bool)
                nb_idx_np = np.full((NB_, N_), -1, np.int32)
                cosp_np = np.zeros((NB_, N_), np.float32)
                sel = code >= 0
                nbs_i, feats_i = code[sel] // N_, code[sel] % N_
                acc[nbs_i, feats_i] = True
                pts_np[nbs_i, feats_i] = pts_c[sel]
                far_np[nbs_i, feats_i] = far_c[sel]
                nb_idx_np[nbs_i, feats_i] = nbf_c[sel]
                cosp_np[nbs_i, feats_i] = cosp_c[sel]
            else:
                nb_idx_np, pts_np, acc, far_np, cosp_np = fetch(dev)

        with self.timer("lm.tri.apply"), self.lock:
            if st.epoch != epoch0:
                return  # store was reset while the device ran
            # Features bound since the snapshot (the tracker may have created
            # a keyframe meanwhile) must not be re-triangulated.
            acc = acc & (st.kf_obs_point[kf] < 0)[None, :]
            # First accepting neighbor per feature (the mirror path already
            # dedups on device; the host path can still have several) —
            # identical winner to the old per-neighbor `taken` loop, applied
            # as ONE batch (the loop was a per-keyframe host cost).
            j_first = np.argmax(acc, axis=0)
            any_acc = acc.any(axis=0) & (j_first < len(nbs))  # skip pad lanes
            feats = np.nonzero(any_acc)[0]
            if len(feats):
                js = j_first[feats]
                order = np.argsort(js, kind="stable")  # old apply order
                feats, js = feats[order], js[order]
                free = int((~st.pt_valid).sum())
                feats, js = feats[:free], js[:free]
            if len(feats):
                ids = st.alloc_points(len(feats))
                st.pt_xyz[ids] = pts_np[js, feats]
                st.pt_first_seq[ids] = st.kf_seq[kf]
                st.pt_desc[ids] = st.kf_desc[kf, feats]
                st.pt_far[ids] = far_np[js, feats]
                # Far-point origin taxonomy (reference plOrigen,
                # MapPoint.h:404-444 / LocalMapping.cc:255-276): points
                # routed to quasi-infinity by the parallax gate are
                # umbralCos; finite triangulations above the user-tunable
                # cos threshold are umbralCosBajo; |X| >= 1e5 marks the
                # SVD-infinity class.
                from ..viz.frame_drawer import (
                    FAR_COS, FAR_LOWCOS, FAR_NORMAL, FAR_SVDINF,
                )

                f_np = far_np[js, feats]
                cos_j = cosp_np[js, feats]
                qinf = np.linalg.norm(pts_np[js, feats], axis=1) >= 1e5
                st.pt_far_class[ids] = np.where(
                    f_np, FAR_COS,
                    np.where(cos_j > self.far_cos_user, FAR_LOWCOS,
                             np.where(qinf, FAR_SVDINF, FAR_NORMAL)),
                ).astype(np.uint8)
                n_new = len(ids)
                nb_arr = np.asarray(nbs, np.int64)[js]
                st.add_observations(
                    np.concatenate([ids, ids]),
                    np.concatenate([np.full(n_new, kf), nb_arr]),
                    np.concatenate([feats, nb_idx_np[js, feats]]),
                )
                st.update_point_derived(
                    ids, cfg.orb.scale_factor, cfg.orb.n_levels
                )
                self._publish()

    # ------------------------------------------------------------------ #
    _P_FUSE = 4096  # max candidate capacity per fusion target
    _FUSE_BUCKETS = (1024, 4096)  # padded candidate-capacity buckets
    _T_FUSE = 46  # padded target capacity: 20 first-ring + 5x5 second-ring + self

    def search_in_neighbors(self, kf: int) -> None:
        for _ in self.search_in_neighbors_steps(kf):
            pass

    def _fuse_targets(self, kf: int) -> list[int]:
        """1st+2nd-ring covisible fusion targets (LocalMapping.cc:374-395)."""
        st = self.store
        first = [int(k) for k in st.covisible_keyframes(kf, top=20)]
        targets = list(first)
        seen = set(first) | {kf}
        for t in first[:5]:
            for t2 in st.covisible_keyframes(t, top=5):
                t2 = int(t2)
                if t2 not in seen:
                    targets.append(t2)
                    seen.add(t2)
        return targets

    def search_in_neighbors_steps(self, kf: int):
        """Bidirectional duplicate-point fusion with 1st+2nd-ring covisible
        neighbors (LocalMapping::SearchInNeighbors, LocalMapping.cc:369-447).
        Snapshot under the map lock, dispatch unlocked, YIELD while the
        device matches, apply under the lock."""
        if self.mirror is not None:
            yield from self._fuse_steps_pairs(kf)
        else:
            yield from self._fuse_steps_host(kf)

    def _fuse_steps_pairs(self, kf: int):
        """Mirror path: one device lane per (target, source) keyframe pair,
        candidates gathered ON DEVICE from the mirror (tk.fuse_pairs_mirror).
        The host uploads three tiny index vectors — the old host-packed
        candidate tables were ~1 MB per keyframe event, the largest
        recurring transfer in the pipeline."""
        st = self.store
        cfg = self.cfg
        L_cap = 2 * self._T_FUSE
        with self.timer("lm.fuse.snap"), self.lock:
            targets = self._fuse_targets(kf)[: self._T_FUSE - 1]
            if not targets:
                return
            # Lane layout: (t <- points of kf) for each target, then
            # (kf <- points of t) — the reference's bidirectional structure.
            tgt = targets + [kf] * len(targets)
            src = [kf] * len(targets) + targets
            L = len(tgt)
            tgt_rows = np.zeros(L_cap, np.int32)
            src_rows = np.zeros(L_cap, np.int32)
            tgt_rows[:L] = tgt
            src_rows[:L] = src
            lane_valid = np.arange(L_cap) < L
            tgt_T = np.tile(np.eye(4, dtype=np.float32), (L_cap, 1, 1))
            tgt_T[:L] = st.kf_T[tgt]
            # Source observation rows snapshotted for the apply mapping
            # (slot -> point id); taken under the same lock as the publish,
            # so they match what the device will read from the mirror.
            snap_src_obs = st.kf_obs_point[src_rows].copy()
            epoch0 = st.epoch
            self._publish()
            mir = self.mirror
            mir_snap = (mir.kf_xy, mir.kf_angle, mir.kf_octave, mir.kf_desc,
                        mir.kf_feat_valid, mir.kf_obs_point,
                        mir.pt_xyz, mir.pt_desc, mir.pt_max_dist,
                        mir.pt_valid, mir.pt_obs_kf)

        with self.timer("lm.fuse.dispatch"):
            code = tk.fuse_pairs_mirror(
                jnp.asarray(tgt_T),
                jnp.asarray(tgt_rows), jnp.asarray(src_rows),
                jnp.asarray(lane_valid),
                *mir_snap,
                jnp.asarray(cfg.intr),
                jnp.float32(cfg.camera.width), jnp.float32(cfg.camera.height),
                jnp.float32(cfg.orb.scale_factor), n_levels=cfg.orb.n_levels,
            )
            announce(code)  # d2h in stream order (transport discipline)
        yield  # two intervals: see create_new_points_steps fetch note
        yield
        with self.timer("lm.fuse.fetch"):
            code = fetch(code)  # [L_cap, FUSE_PAIR_TOP]

        with self.timer("lm.fuse.apply"), self.lock:
            if st.epoch != epoch0:
                return
            # Flatten every lane's matches into ONE batch (the per-lane
            # _apply_fuse loop was a per-keyframe host cost that grew with
            # the lane count). Within the batch, first-occurrence wins for both
            # (target, feature) and (target, point) keys — the second key
            # also closes a pair-lane hazard: the same point can reach the
            # new keyframe through several source lanes and must not bind
            # to two of its features.
            t_l, p_l, f_l = [], [], []
            for lane in range(L):
                c = code[lane]
                c = c[c >= 0]
                slots = c >> 12
                fm = c & 0xFFF
                pids = snap_src_obs[lane][slots]
                keep = pids >= 0
                n_k = int(keep.sum())
                if n_k:
                    t_l.append(np.full(n_k, tgt[lane], np.int64))
                    p_l.append(pids[keep].astype(np.int64))
                    f_l.append(fm[keep].astype(np.int64))
            if not t_l:
                self._publish()
                return
            t_all = np.concatenate(t_l)
            p_all = np.concatenate(p_l)
            f_all = np.concatenate(f_l)
            live = st.pt_valid[p_all]
            t_all, p_all, f_all = t_all[live], p_all[live], f_all[live]

            def first_mask(keys):
                order = np.argsort(keys, kind="stable")
                sk = keys[order]
                first = np.concatenate([[True], sk[1:] != sk[:-1]])
                m = np.zeros(len(keys), bool)
                m[order[first]] = True
                return m

            N_f = self.cfg.orb.n_features
            P_cap = st.cfg.max_points
            uniq = (first_mask(t_all * N_f + f_all)
                    & first_mask(t_all * P_cap + p_all))
            existing = st.kf_obs_point[t_all, f_all]
            dup = (existing >= 0) & st.pt_valid[np.clip(existing, 0, None)]
            already = (st.pt_obs_kf[p_all] == t_all[:, None]).any(1)
            simple = uniq & ~dup & ~already
            st.add_observations(p_all[simple], t_all[simple], f_all[simple])
            touched = [p_all[simple]]
            # True duplicates walk the keep-better-observed Replace path
            # (ORBmatcher::Fuse + MapPoint::Replace, MapPoint.cc:132-175).
            for t, p, f in zip(t_all[uniq & dup], p_all[uniq & dup],
                               f_all[uniq & dup]):
                t, p, f = int(t), int(p), int(f)
                if not st.pt_valid[p]:
                    continue  # died as the loser of an earlier Replace
                e = int(st.kf_obs_point[t, f])
                if e >= 0 and st.pt_valid[e] and e != p:
                    if st.pt_n_obs[e] >= st.pt_n_obs[p]:
                        st.replace_point(p, e)
                        touched.append(np.array([e], np.int64))
                    else:
                        st.replace_point(e, p)
                        touched.append(np.array([p], np.int64))
                elif e < 0 and not (st.pt_obs_kf[p] == t).any():
                    st.add_observation(p, t, f)
                    touched.append(np.array([p], np.int64))
            touched = np.unique(np.concatenate(touched))
            touched = touched[st.pt_valid[touched]]
            if len(touched):
                st.update_point_derived(touched, self.cfg.orb.scale_factor,
                                        self.cfg.orb.n_levels)
            self._publish()

    def _fuse_steps_host(self, kf: int):
        """Host-snapshot path (no mirror — minimal/test pipelines): all
        (target, candidate-set) pairs matched in ONE padded device call
        (tk.fuse_batch) over uploaded candidate tables."""
        st = self.store
        cfg = self.cfg
        with self.timer("lm.fuse.snap"), self.lock:
            targets = self._fuse_targets(kf)
            own = st.kf_obs_point[kf]
            own = np.unique(own[own >= 0])
            own = own[st.pt_valid[own]][: self._P_FUSE]
            fuse = st.kf_obs_point[targets] if targets else np.empty((0, 0), np.int32)
            fuse = np.unique(fuse[fuse >= 0]) if fuse.size else np.empty(0, np.int64)
            fuse = (fuse[st.pt_valid[fuse]] if fuse.size else fuse)[: self._P_FUSE]
            if len(own) == 0 and len(fuse) == 0:
                return

            # Smallest candidate-capacity bucket covering both sets (compile
            # once per bucket; typical local maps fit the first bucket).
            C = next(b for b in self._FUSE_BUCKETS
                     if b >= max(len(own), len(fuse), 1))
            # Shared point slice: union of both candidate sets, uploaded once.
            # Padded to the bucket capacity — a varying slice length would
            # recompile fuse_batch on every keyframe.
            sl = np.union1d(own, fuse).astype(np.int64)[: 2 * C]
            pos = np.zeros(st.cfg.max_points, np.int32)
            pos[sl] = np.arange(len(sl), dtype=np.int32)
            n_sl = len(sl)
            sl = np.concatenate([sl, np.zeros(2 * C - n_sl, np.int64)])

            T_cap = self._T_FUSE
            rows = (targets + [kf])[:T_cap]
            n_rows = len(rows)
            row_kfs = np.zeros(T_cap, np.int64)
            row_kfs[:n_rows] = rows
            cand_idx = np.zeros((T_cap, C), np.int32)
            cand_valid = np.zeros((T_cap, C), bool)
            for r, t in enumerate(rows):
                ids = own if t != kf else fuse
                m = len(ids)
                if m == 0:
                    continue
                cand_idx[r, :m] = pos[ids]
                # Exclude points already observed in this target.
                cand_valid[r, :m] = ~(st.pt_obs_kf[ids] == t).any(1)
            epoch0 = st.epoch
            tgt_valid = (
                st.kf_feat_valid[row_kfs] & (np.arange(T_cap) < n_rows)[:, None]
            )
            snap = (
                st.kf_T[row_kfs], st.kf_xy[row_kfs], st.kf_angle[row_kfs],
                st.kf_octave[row_kfs], st.kf_desc[row_kfs],
                tgt_valid, cand_idx, cand_valid,
                st.pt_xyz[sl], st.pt_desc[sl],
                np.nan_to_num(st.pt_max_dist[sl], posinf=1e9),
            )

        with self.timer("lm.fuse.dispatch"):
            code = tk.fuse_batch(
                *(jnp.asarray(a) for a in snap),
                jnp.asarray(cfg.intr),
                jnp.float32(cfg.camera.width), jnp.float32(cfg.camera.height),
                jnp.float32(cfg.orb.scale_factor), n_levels=cfg.orb.n_levels,
            )
        yield  # device matches; the caller tracks the next frame(s)
        with self.timer("lm.fuse.fetch"):
            code = fetch(code)  # [T, FUSE_TOP]; blocks outside the lock

        with self.timer("lm.fuse.apply"), self.lock:
            if st.epoch != epoch0:
                return
            touched = []
            for r, t in enumerate(rows):
                ids = own if t != kf else fuse
                c = code[r]
                c = c[c >= 0]
                slots = c >> 12
                feats_m = c & 0xFFF
                keep = slots < len(ids)
                touched.append(self._apply_fuse(t, ids, slots[keep], feats_m[keep]))
            # Refresh derived state ONLY for points whose observations
            # actually changed (the matched ones). The reference refreshes
            # the current keyframe's whole point set (LocalMapping.cc:424-444)
            # but the refresh is a pure function of the observations, so
            # untouched points are a no-op — and recomputing the [n, M, 256]
            # descriptor-median for every CANDIDATE point (~8k rows) was the
            # single largest host cost per keyframe).
            touched = [t for t in touched if len(t)]
            touched = np.unique(np.concatenate(touched)) if touched else []
            if len(touched):
                touched = touched[st.pt_valid[touched]]
                st.update_point_derived(touched, self.cfg.orb.scale_factor,
                                        self.cfg.orb.n_levels)
            self._publish()

    def _apply_fuse(self, target: int, ids: np.ndarray, slots: np.ndarray,
                    feats: np.ndarray) -> np.ndarray:
        """Merge matched duplicates into `target` (ORBmatcher::Fuse apply
        phase + MapPoint::Replace semantics, MapPoint.cc:132-175).
        slots index into ids (candidate point list); feats are the matched
        target feature indices. Returns the point ids whose observations
        changed (new binds + both sides of every Replace).

        The common case — the matched feature slot is unbound, so the fuse is
        just a new observation — is applied as ONE batched bind; only true
        duplicates (slot already bound to a live point) walk the
        keep-better-observed Replace path."""
        st = self.store
        if len(slots) == 0:
            return np.empty(0, np.int64)
        p_all = ids[slots]
        f_all = feats
        live = st.pt_valid[p_all]
        p_all, f_all = p_all[live], f_all[live]
        existing = st.kf_obs_point[target, f_all]
        dup = (existing >= 0) & st.pt_valid[np.clip(existing, 0, None)]
        # Collisions within the batch (two candidates matched the same target
        # feature): keep the first, divert the rest through the slow path.
        uniq_first = np.zeros(len(f_all), bool)
        uniq_first[np.unique(f_all[~dup], return_index=True)[1]] = True
        simple = ~dup & uniq_first
        st.add_observations(
            p_all[simple], np.full(int(simple.sum()), target), f_all[simple]
        )
        touched = [np.asarray(p_all[simple], np.int64)]
        for p, f in zip(p_all[~simple], f_all[~simple]):
            p = int(p)
            if not st.pt_valid[p]:
                continue  # died as the loser of an earlier fuse this pass
            e = int(st.kf_obs_point[target, int(f)])
            if e >= 0 and st.pt_valid[e] and e != p:
                # Duplicate: keep the better-observed point (Fuse semantics).
                if st.pt_n_obs[e] >= st.pt_n_obs[p]:
                    st.replace_point(p, e)
                    touched.append(np.array([e], np.int64))
                else:
                    st.replace_point(e, p)
                    touched.append(np.array([p], np.int64))
            elif e < 0:
                st.add_observation(p, target, int(f))
                touched.append(np.array([p], np.int64))
        return np.concatenate(touched)

    # ------------------------------------------------------------------ #
    def cull_keyframes(self, kf: int) -> None:
        """KeyFrameCulling (LocalMapping.cc:556-603): a covisible keyframe
        whose map points are >= 90% redundant (seen by >= 3 other keyframes)
        is removed. The first two keyframes (map origin/gauge) are kept."""
        st = self.store
        th = self.cfg.th
        live = np.nonzero(st.kf_valid)[0]
        # Protect the two OLDEST keyframes (map origin/gauge) by insertion
        # seq — slot order is not age order once slots recycle, and frame
        # ids can collide after a session merge.
        oldest2 = live[np.argsort(st.kf_seq[live], kind="stable")[:2]]
        protected = set(oldest2.tolist()) | {kf}
        # Never cull the tracker's CURRENT reference keyframe: the reference
        # keeps culled KeyFrame objects alive (SetBadFlag never frees,
        # KeyFrame.cc:478-613) so TrackReferenceKeyFrame tolerates a bad
        # mpReferenceKF; here the slot is zeroed, so culling it collapses
        # the per-frame fallback path (observed: n_pre=0 reloc storms).
        if self.protected_kf_fn is not None:
            p = self.protected_kf_fn()
            if p is not None and p >= 0:
                protected.add(int(p))
        for c in st.covisible_keyframes(kf):
            c = int(c)
            if c in protected:
                continue
            obs = st.kf_obs_point[c]
            pts = obs[obs >= 0]
            pts = pts[st.pt_valid[pts]]
            if len(pts) < 10:
                continue
            redundant = st.pt_n_obs[pts] >= 4  # 3 others + itself
            if redundant.mean() > th.kf_cull_redundancy:
                st.cull_keyframe(c)
                if self.on_cull_keyframe is not None:
                    self.on_cull_keyframe(c)

    # ------------------------------------------------------------------ #
    def local_ba(self, kf: int) -> None:
        for _ in self.local_ba_steps(kf):
            pass

    def local_ba_steps(self, kf: int):
        """Assemble and solve the local BA problem
        (Optimizer::LocalBundleAdjustment, Optimizer.cc:340-589): covisible
        keyframes free, boundary observers fixed, 5+10 LM schedule, outlier
        observations erased afterwards.

        Assembly snapshot + result writeback run under the map lock; the LM
        chunks run unlocked so tracking proceeds while BA solves (the exact
        g2o pattern: optimize outside the mutex, apply under it,
        Optimizer.cc:516)."""
        with self.timer("lm.ba.assemble"), self.lock:
            work = self._local_ba_assemble(kf)
        if work is None:
            return
        prob, meta = work
        # 5+10 LM schedule (Optimizer.cc:466-510) in host-checked chunks:
        # the second phase yields to the abort flag between 5-iter chunks
        # (reference mbAbortBA preemption, Optimizer.cc:500-505 checks
        # pbStopFlag between phases; g2o checks per iteration). Dispatches
        # chain device-side WITHOUT host blocking between chunks — each
        # round trip has a fixed latency, and blocking per chunk once made
        # latency, not compute, half the local-BA bill. An abort can still skip any
        # not-yet-dispatched chunk; at worst one in-flight chunk completes,
        # the same granularity g2o's per-iteration stop check provides.
        shard, begin, iterate, reclassify, result = self._ba_fns()
        with self.timer("lm.ba.dispatch"):
            prob = shard(prob)
            state = begin(prob)
            state = iterate(prob, state, 5)
            state = reclassify(prob, state)
            self.ba_iters += 5
        yield  # first LM phase runs on device
        for _ in range(2):
            if self.abort_ba:
                break
            with self.timer("lm.ba.dispatch"):
                state = iterate(prob, state, 5)
                self.ba_iters += 5
            yield  # chunk runs on device; abort re-checked at next step
        with self.timer("lm.ba.dispatch"):
            dev = result(prob, state)
            announce(dev)  # d2h in stream order (transport discipline)
        yield  # two intervals: see create_new_points_steps fetch note
        yield
        with self.timer("lm.ba.fetch"):
            res = fetch(dev)  # ONE block, outside the lock
        with self.timer("lm.local_ba"), self.lock:
            self._local_ba_apply(res, meta)
            self._publish()

    def _local_ba_assemble(self, kf: int):
        st = self.store
        cfg = self.cfg
        local = [kf] + [
            int(k) for k in st.covisible_keyframes(kf, top=cfg.th.local_ba_keyframes - 1)
        ]
        pts = st.kf_obs_point[local]
        pts = np.unique(pts[pts >= 0])
        # Far (quasi-infinity) points are excluded from BA, as the reference
        # excludes them from optimization (Optimizer.cc:243).
        pts = pts[st.pt_valid[pts] & ~st.pt_far[pts]][:P_BUCKETS[-1]]
        if len(pts) < 20:
            return None

        # All observers of the local points.
        obs_kf_all = st.pt_obs_kf[pts]
        observers = np.unique(obs_kf_all[obs_kf_all >= 0])
        boundary = [int(k) for k in observers if int(k) not in set(local)]
        cams = local + boundary
        cams = cams[:C_BUCKETS[-1]]
        # Smallest padded bucket covering the problem (compile-once per
        # bucket; see P_BUCKETS note above).
        P_BA = next(b for b in P_BUCKETS if b >= len(pts))
        C_BA = next(b for b in C_BUCKETS if b >= len(cams))
        cam_slot = {c: i for i, c in enumerate(cams)}
        n_local = len(local)
        fixed = np.ones(C_BA, bool)
        fixed[:n_local] = False
        # Gauge: fix the oldest keyframe in the problem (the reference fixes
        # boundary KFs + kf id 0; with no boundary the oldest local anchors).
        # Age = kf_seq (slot ids recycle; frame ids can collide post-merge).
        by_age = sorted(cams, key=lambda c: int(st.kf_seq[c]))
        fixed[cam_slot[by_age[0]]] = True
        if len(cams) > 1 and len(boundary) == 0:
            # Monocular gauge also needs scale: fix the two oldest.
            fixed[cam_slot[by_age[1]]] = True

        P = len(pts)
        M = st.cfg.max_obs_per_point
        cam_T = np.tile(np.eye(4, dtype=np.float32), (C_BA, 1, 1))
        for c, i in cam_slot.items():
            cam_T[i] = st.kf_T[c]

        okf = st.pt_obs_kf[pts]  # [P, M]
        oft = st.pt_obs_feat[pts]
        slot_lookup = np.full(st.cfg.max_keyframes, -1, np.int32)
        for c, i in cam_slot.items():
            slot_lookup[c] = i
        okf_c = np.clip(okf, 0, None)
        oft_c0 = np.clip(oft, 0, None)
        slots = slot_lookup[okf_c]
        valid_raw = (okf >= 0) & (slots >= 0)
        # Observations the problem will actually contain. Un-materialized
        # keyframes' HOST rows are zeros and must be excluded — EXCEPT the
        # rows the mirror still holds as device-published pending rows
        # (mirror.insert_keyframe_row_device): the device gathers their
        # REAL feature arrays, so they are live observations. Getting this
        # set exactly right matters twice over: counting too few fixes the
        # newest keyframe at its odometry pose in every BA (a drag anchor
        # that decayed tracking); counting too many leaves a free camera
        # with zero real observations (it teleports).
        feat_ok = st.kf_feat_valid[okf_c, oft_c0]
        if self.mirror is not None and self.mirror._pending_rows:
            pending = np.zeros(st.cfg.max_keyframes, bool)
            pending[list(self.mirror._pending_rows)] = True
            feat_ok = feat_ok | pending[okf_c]
        valid = valid_raw & feat_ok
        obs_valid = np.zeros((P_BA, M), bool)
        obs_valid[:P] = valid  # host copy for the outlier-erase writeback
        n_obs_cam = np.bincount(slots[valid].ravel(), minlength=C_BA)
        for c, i in cam_slot.items():
            if n_obs_cam[i] < 6:
                fixed[i] = True

        pts_idx = np.zeros(P_BA, np.int32)
        pts_idx[:P] = pts
        pvalid = np.zeros(P_BA, bool)
        pvalid[:P] = True

        mir = self.mirror
        if mir is not None:
            # Device-side assembly: the observation tables (obs_uv/sigma2/
            # cam/valid, ~600 KB) are gathered from the mirror; the host
            # uploads only the point-slot list, poses, and the camera
            # lookup (~10 KB). Publish-then-capture under the caller's lock
            # makes the mirror exactly the host state.
            self._publish()
            d_obs_cam, d_obs_uv, d_obs_s2, d_obs_valid, d_points = (
                tk.assemble_ba_mirror(
                    mir.pt_xyz, mir.pt_obs_kf, mir.pt_obs_feat,
                    mir.kf_xy, mir.kf_octave, mir.kf_feat_valid,
                    jnp.asarray(pts_idx), jnp.asarray(pvalid),
                    jnp.asarray(cam_T), jnp.asarray(slot_lookup),
                    jnp.asarray(cfg.sigma2_table), jnp.asarray(cfg.intr),
                )
            )
            prob = BAProblem(
                cam_T=jnp.asarray(cam_T),
                cam_fixed=jnp.asarray(fixed),
                points=d_points,
                point_valid=jnp.asarray(pvalid),
                obs_cam=d_obs_cam,
                obs_uv=d_obs_uv,
                obs_sigma2=d_obs_s2,
                obs_valid=d_obs_valid,
                intr=jnp.asarray(cfg.intr),
            )
        else:
            oft_c = np.clip(oft, 0, None)
            obs_cam = np.zeros((P_BA, M), np.int32)
            obs_uv = np.zeros((P_BA, M, 2), np.float32)
            obs_s2 = np.ones((P_BA, M), np.float32)
            obs_cam[:P] = np.where(valid, slots, 0)
            obs_uv[:P] = st.kf_xy[okf_c, oft_c]
            obs_s2[:P] = cfg.sigma2_table[st.kf_octave[okf_c, oft_c]]
            points = np.zeros((P_BA, 3), np.float32)
            points[:P] = st.pt_xyz[pts]
            prob = BAProblem(
                cam_T=jnp.asarray(cam_T),
                cam_fixed=jnp.asarray(fixed),
                points=jnp.asarray(points),
                point_valid=jnp.asarray(pvalid),
                obs_cam=jnp.asarray(obs_cam),
                obs_uv=jnp.asarray(obs_uv),
                obs_sigma2=jnp.asarray(obs_s2),
                obs_valid=jnp.asarray(obs_valid),
                intr=jnp.asarray(cfg.intr),
            )
        meta = dict(pts=pts, okf=okf, cam_slot=cam_slot, fixed=fixed,
                    obs_valid=obs_valid, P=P, epoch=st.epoch,
                    cam_seq={c: int(st.kf_seq[c]) for c in cams})
        return prob, meta

    def _local_ba_apply(self, res, meta) -> None:
        st = self.store
        if st.epoch != meta["epoch"]:
            return  # store was reset while the solve ran
        pts, okf, P = meta["pts"], meta["okf"], meta["P"]
        fixed, obs_valid = meta["fixed"], meta["obs_valid"]
        cam_seq = meta["cam_seq"]
        new_T = np.asarray(res.cam_T)
        still = set()
        for c, i in meta["cam_slot"].items():
            # ABA guard: a keyframe culled during the chunked solve may have
            # had its slot re-allocated to a NEW keyframe — identity is
            # (slot, kf_seq), not the slot alone.
            if not (st.kf_valid[c] and int(st.kf_seq[c]) == cam_seq[c]):
                continue
            still.add(c)
            if not fixed[i]:
                st.kf_T[c] = new_T[i]
        alive = st.pt_valid[pts]  # a point may have been fused/culled meanwhile
        st.pt_xyz[pts[alive]] = np.asarray(res.points)[:P][alive]

        # Erase outlier observations (Optimizer.cc:520-556), batched; only
        # against keyframes whose slot identity survived the solve.
        inl = np.asarray(res.obs_inlier)[:P]
        okf_still = np.isin(okf, list(still)) if still else np.zeros_like(okf, bool)
        out_i, out_s = np.nonzero(obs_valid[:P] & ~inl & alive[:, None]
                                  & okf_still)
        st.remove_observations(pts[out_i], okf[out_i, out_s])
        # Cull points left with < 2 observations.
        dead = pts[alive & (st.pt_n_obs[pts] < 2)]
        if len(dead):
            st.cull_points(dead)
