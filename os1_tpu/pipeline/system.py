"""System facade: the public API of the SLAM engine.

Mirrors the reference's System class (System.h:258-459 / System.cc:41-184):
construction wires tracking + local mapping (+ loop closing when enabled),
`track_monocular` is the per-frame entry point, localization-only mode
freezes the map, reset and trajectory export match the reference semantics.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..map.mirror import DeviceMirror
from ..map.store import MapStore
from ..utils.profiling import StageTimer
from .config import SlamConfig
from .local_mapping import LocalMapper
from .tracking import Tracker, TrackingState


@dataclass
class System:
    cfg: SlamConfig
    enable_mapping: bool = True  # False = localization-only mode
    enable_loop_closing: bool = True
    pipelined: bool = False  # 1-frame-lag tracking pipeline (see tracking.py)
    # Asynchronous keyframe pipeline: local mapping + loop closing run on
    # worker threads against keyframe queues (the reference's thread
    # topology, System.cc:63-83; see pipeline/workers.py), so tracking never
    # waits on keyframe-rate work. False = every keyframe event runs inline
    # (deterministic; what most unit tests use).
    async_mapping: bool = False
    # Cooperative keyframe pipeline (the shipped bench configuration):
    # mapping + loop closing advance as generator micro-steps interleaved
    # between tracked frames on ONE host thread, each step spanning a device
    # dispatch->result interval (workers.py CoopScheduler). Same overlap as
    # the worker threads — the device crunches mapping stages while the host
    # tracks — but deterministic: two runs produce bit-identical
    # trajectories. Ignored when async_mapping is True.
    coop_mapping: bool = False
    # Distributed back-end solves (BASELINE.json configs 4-5): None = auto
    # (shard over the mesh whenever more than one device exists), True =
    # require a mesh, False = force single-device. When active, local BA and
    # global BA run landmark-sharded and the essential graph edge-sharded
    # with one psum per LM iteration (parallel/backend.py, dist_pose_graph).
    distributed: bool | None = None
    store: MapStore = None
    vocab = None  # Vocabulary | None (None -> packaged default)
    tracker: Tracker = field(init=False)
    mapper: LocalMapper = field(init=False)

    def __post_init__(self):
        import threading

        if self.store is None:
            self.store = MapStore(self.cfg.map)
        # One shared stage timer across all pipeline components: the
        # observability the reference lacked (SURVEY.md §5 tracing row).
        self.timer = StageTimer()
        # One shared map lock (Map::mMutexMapUpdate, Map.h:140).
        self.lock = threading.RLock()
        self.tracker = Tracker(cfg=self.cfg, store=self.store)
        self.tracker.timer = self.timer
        self.tracker.lock = self.lock
        self.mapper = LocalMapper(
            cfg=self.cfg, store=self.store, timer=self.timer, lock=self.lock
        )
        self.tracker.on_new_keyframe = self._on_new_keyframe
        # Device-resident map mirror: per-frame tracking reads the map from
        # device memory; every map mutation below ends by re-publishing it
        # (the device-side Map::mMutexMapUpdate — see map/mirror.py).
        self.mirror = DeviceMirror(self.store)
        self.tracker.mirror = self.mirror
        self.tracker.pipelined = self.pipelined
        self.mapper.publish_points = self.mirror.refresh_dynamic
        # Mapper gathers keyframe rows / point slices from the mirror by
        # index instead of uploading them (tk.*_mirror_batch).
        self.mapper.mirror = self.mirror

        # Place recognition: BoW database over the packaged vocabulary
        # (System.cc:100 loads orbVoc.bin; here the default vocabulary, or a
        # DBoW2 binary passed as `vocab`).
        if self.vocab is None:
            from ..vocab.dbow2 import default_vocabulary

            self.vocab = default_vocabulary()
        from ..vocab.database import KeyFrameDatabase
        from .loop_closing import LoopCloser
        from .relocalization import Relocalizer

        self.db = KeyFrameDatabase(self.vocab, self.cfg.map.max_keyframes)
        self.tracker.relocalizer = Relocalizer(
            cfg=self.cfg, store=self.store, db=self.db, mirror=self.mirror
        )
        self.loop_closer = LoopCloser(
            cfg=self.cfg, store=self.store, db=self.db, lock=self.lock,
            on_map_updated=self._publish_after_gba, timer=self.timer,
            on_corrected=self._after_loop_correction,
        )
        self.mapper.on_cull_keyframe = self.db.erase
        self.mapper.protected_kf_fn = lambda: self.tracker.ref_kf
        self.tracker.loop_closing_active = lambda: self.loop_closer.closing_active
        self.tracker.on_reset = self._on_reset
        # Distributed solver backend (configs 4-5).
        if self.distributed is not False:
            from ..parallel.backend import default_mesh_backend

            be = default_mesh_backend()
            if be is None and self.distributed is True:
                raise RuntimeError(
                    "distributed=True requires more than one device"
                )
            self.mesh_backend = be
        else:
            self.mesh_backend = None
        self.mapper.mesh_backend = self.mesh_backend
        self.loop_closer.mesh_backend = self.mesh_backend
        self._kf_count = 0
        # Keyframes created by the tracker whose feature arrays are still
        # device-resident, awaiting worker-side materialization (kf -> FrameData).
        self._pending_frames = {}

        self.mapping_worker = None
        self.loop_worker = None
        self.coop = None
        if self.async_mapping:
            from .workers import LoopWorker, MappingWorker

            if self.enable_loop_closing:
                self.loop_worker = LoopWorker(self._loop_process, self.lock)
            self.mapping_worker = MappingWorker(
                self.mapper,
                self.lock,
                on_process=self._worker_prepare,
                on_pass_done=self._worker_pass_done,
                loop_worker=self.loop_worker,
            )
            self.loop_closer.mapping_worker = self.mapping_worker
            self.tracker.mapping_idle = lambda: self.mapping_worker.accepting
            self.tracker.interrupt_ba = self.mapping_worker.interrupt_ba
            self.mapper.pending_fn = self.mapping_worker.queue_size
        elif self.coop_mapping:
            from .workers import CoopScheduler

            loop_steps = None
            if self.enable_loop_closing:
                loop_steps = lambda kf: self.loop_closer.process_steps(
                    kf, self._kf_count
                )
            self.coop = CoopScheduler(
                self.mapper,
                loop_steps=loop_steps,
                on_prepare=self._worker_prepare,
                on_pass_done=self._worker_pass_done,
            )
            self.tracker.mapping_idle = lambda: self.coop.accepting
            self.tracker.interrupt_ba = lambda: setattr(
                self.mapper, "abort_ba", True
            )
            self.mapper.pending_fn = self.coop.queue_size

    def _on_reset(self):
        if self.mapping_worker is not None:
            self.mapping_worker.request_reset()
        if self.loop_worker is not None:
            self.loop_worker.request_reset()
        if self.coop is not None:
            self.coop.clear()
        self.db.clear()
        self._kf_count = 0
        self._pending_frames.clear()
        self.mirror.refresh()

    def _on_new_keyframe(self, kf: int, bootstrap: bool = False, frame=None):
        self._kf_count += 1
        if frame is not None:
            # Deferred keyframe: feature arrays still on device; the mapping
            # worker materializes them (_worker_prepare). The mirror row
            # inserts device-to-device — zero transfer on the tracking thread.
            self._pending_frames[kf] = frame
        if self.mapping_worker is not None or self.coop is not None:
            # Async/coop: publish the new keyframe row to the mirror so the
            # very next frame can track against it, then queue the heavy work.
            with self.timer("mirror.refresh"):
                if frame is not None:
                    self.mirror.insert_keyframe_row_device(kf, frame)
                else:
                    self.mirror.insert_keyframe_row(kf)
                self.mirror.refresh_dynamic()
            if not self.enable_mapping:
                self._worker_prepare(kf)  # keep the reloc database current
            elif self.mapping_worker is not None:
                self.mapping_worker.insert_keyframe(kf, bootstrap=bootstrap)
            else:
                self.coop.insert(kf, bootstrap=bootstrap)
            return
        self._worker_prepare(kf)
        # Publish the new keyframe row BEFORE mapping: the mapper's
        # triangulation/fusion gather feature rows from the mirror by index
        # (tk.*_mirror_batch), so row kf must be live when process() runs.
        with self.timer("mirror.refresh"):
            self.mirror.insert_keyframe_row(kf)
            self.mirror.refresh_dynamic()
        if self.enable_mapping:
            self.mapper.process(kf, bootstrap=bootstrap)
            if self.enable_loop_closing and not bootstrap:
                with self.timer("loop.process"):
                    self.loop_closer.process(kf, self._kf_count)
        with self.timer("mirror.refresh"):
            self.mirror.refresh_dynamic()

    def _worker_prepare(self, kf: int):
        """Pre-pass for a queued keyframe, ON the mapping worker: materialize
        the deferred feature arrays (one device readback — the reference's
        ProcessNewKeyFrame bookkeeping, LocalMapping.cc:125-153) and compute
        its BoW vector for the place-recognition database."""
        self._materialize_kf(kf)
        st = self.store
        with self.timer("bow.compute"):
            # No lock for the row reads: kf_desc/kf_feat_valid[kf] were
            # written by THIS thread in _materialize_kf and nothing mutates
            # them afterwards (features are immutable once materialized) —
            # the old in-lock copy serialized against the tracker's per-frame
            # lock hold and made lock WAIT, not the 0.8 ms descent, the bulk
            # of the measured bow.compute time.
            if not st.kf_valid[kf]:
                return
            desc = st.kf_desc[kf].copy()
            valid = st.kf_feat_valid[kf].copy()
            _, _, bow = self.db.compute_bow(desc, valid)  # native host descent
            with self.lock:
                if st.kf_valid[kf]:
                    self.db.add(kf, bow)

    def _materialize_kf(self, kf: int):
        frame = self._pending_frames.pop(kf, None)
        if frame is None:
            return
        from .frame import unpack_host

        with self.timer("lm.materialize"):
            pack = np.asarray(frame.host_pack)  # readback OFF tracking thread
            with self.lock:
                if not self.store.kf_valid[kf]:
                    return
                self.store.materialize_keyframe(kf, *unpack_host(pack))
                # Re-publish the static feature row from the now-complete
                # host arrays: a wholesale mirror.refresh() while this
                # keyframe was pending (e.g. a loop correction) clobbered
                # its device-published row with the store's zeros, and the
                # static rows are outside the dynamic diff set — a zeroed
                # row reads as keypoints at pixel (0,0) and teleported the
                # keyframe in its own local BA.
                self.mirror.insert_keyframe_row(kf)
                # Normal/scale/descriptor refresh for the points this
                # keyframe observes (ProcessNewKeyFrame, LocalMapping.cc:
                # 134-147) — deferred here together with the arrays it needs.
                obs = self.store.kf_obs_point[kf]
                pts = np.unique(obs[obs >= 0])
                self.store.update_point_derived(
                    pts, self.cfg.orb.scale_factor, self.cfg.orb.n_levels
                )

    def _worker_pass_done(self, kf: int):
        with self.timer("mirror.refresh"), self.lock:
            self.mirror.refresh_dynamic()

    def _publish_after_gba(self):
        with self.lock:
            self.mirror.refresh_dynamic()

    def _after_loop_correction(self):
        """Re-anchor the tracker after a loop correction moved the world
        (cooperative mode; the reference's tracker blocks on the map-update
        mutex during CorrectLoop, so it never observes the jump mid-chain):
        publish the corrected map, drop in-flight frames whose pose chain is
        anchored in the pre-correction world, and remap the last frame's
        pose through its reference keyframe's corrected pose."""
        with self.lock:
            self.mirror.refresh()
            tr = self.tracker
            tr._pending.clear()
            tr._chain = None
            tr.velocity = None
            tr._prev_Tcw = None
            if tr.last is not None and tr.trajectory:
                ts, fid, ref, seq, T_rel, _ = tr.trajectory[-1]
                if (fid == tr.last.frame_id and ref >= 0
                        and self.store.kf_valid[ref]
                        and self.store.kf_seq[ref] == seq):
                    tr.last.Tcw = (T_rel @ self.store.kf_T[ref]).astype(
                        np.float32
                    )

    def _loop_process(self, kf: int):
        if not self.enable_mapping:
            return
        with self.timer("loop.process"):
            closed = self.loop_closer.process(kf, self._kf_count)
        if closed:
            with self.lock:
                self.mirror.refresh()

    # ------------------------------------------------------------------ #
    def warmup(self, include_loop: bool = True) -> float:
        """Compile every device program the pipeline can hit, up front.

        A cold XLA compile takes seconds per program; any program first hit
        mid-run stalls its pipeline stage for that long (a bucket shape
        first seen during a keyframe event once stalled mapping long enough
        for tracking to outrun the stale map). One warmup fills the
        persistent compilation cache (utils/cache.py); later processes
        replay it from disk. Returns elapsed seconds.
        """
        import time as _time

        import jax
        import jax.numpy as jnp

        from . import tracking_fused
        from . import tracking_kernels as tk

        t0 = _time.time()
        cfg = self.cfg
        cam = cfg.camera
        intr = jnp.asarray(cfg.intr)
        N = cfg.orb.n_features
        L = cfg.th.max_local_points

        # Frame builder (extractor + undistortion) and the fused tracker.
        # Both input dtypes (uint8 camera frames, float32 pre-converted).
        frame = self.tracker._build(
            jnp.zeros((cfg.orb.height, cfg.orb.width), jnp.uint8), cam
        )
        frame = self.tracker._build(
            jnp.zeros((cfg.orb.height, cfg.orb.width), jnp.float32), cam
        )
        if self.tracker._fused is None:
            self.tracker._fused = tracking_fused.make_fused_tracker(cfg)
        mir = self.mirror
        eye = jnp.eye(4)
        out = self.tracker._fused(
            mir.pt_xyz, mir.pt_desc, mir.pt_valid, mir.pt_normal,
            mir.pt_min_dist, mir.pt_max_dist,
            mir.kf_desc, mir.kf_angle, mir.kf_obs_point,
            frame, cam, intr,
            eye, eye, jnp.full(N, -1, jnp.int32), frame.feats.octave,
            jnp.int32(0), jnp.bool_(False),
            jnp.zeros(L, jnp.int32), jnp.zeros(L, bool), jnp.bool_(False),
        )
        jax.block_until_ready(out["packed"])

        # Initialization path: bootstrap + the success-path programs
        # (median depth, mirror keyframe-row insert — both first hit inside
        # _create_initial_map otherwise, stalling the first init seconds).
        import jax.random as jrandom

        jax.block_until_ready(
            tk.bootstrap(frame, frame, self.tracker._K, jrandom.PRNGKey(0))[1].T21
        )
        jax.block_until_ready(tk.compute_median_depth(
            eye, mir.pt_xyz, mir.pt_valid
        ))
        self.mirror.insert_keyframe_row(0)  # store row 0 is zeros pre-init
        self.mirror.refresh_dynamic()

        # Unfused local-map tracking (relocalization's polish path).
        import numpy as np_

        jax.block_until_ready(tk.track_points(
            eye, jnp.ones((L, 3)).at[:, 2].set(5.0),
            jnp.zeros((L, 8), jnp.uint32), jnp.zeros(L, bool),
            jnp.zeros(L, jnp.int32), jnp.zeros((L, 3)), jnp.zeros(L),
            jnp.full(L, 100.0), jnp.zeros(N, bool), jnp.zeros((N, 3)),
            jnp.zeros(N, bool), frame, cam, intr,
            jnp.float32(cfg.th.localmap_search_radius),
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
            use_frustum=True, ratio=0.8,
        )[0])

        # BoW transform.
        self.db.compute_bow(
            np_.zeros((N, 8), np_.uint32), np_.zeros(N, bool)
        )

        # Relocalization programs (match + PnP + LM polish).
        from ..solvers.pnp import solve_pnp
        from ..optim import optimize_pose
        from .relocalization import (
            RELOC_C, _match_frame_to_kf_points, _reloc_candidates_program,
        )

        jax.block_until_ready(_match_frame_to_kf_points(
            frame.feats.desc, frame.feats.valid, frame.feats.angle,
            jnp.zeros((N, 8), jnp.uint32), jnp.zeros(N), jnp.zeros(N, bool),
        ).idx)
        pnp = solve_pnp(
            jnp.ones((N, 3)).at[:, 2].set(5.0), frame.xy_un, frame.sigma2,
            jnp.zeros(N, bool), intr, jrandom.PRNGKey(0),
        )
        jax.block_until_ready(optimize_pose(
            eye, jnp.ones((N, 3)).at[:, 2].set(5.0), frame.xy_un,
            frame.sigma2, jnp.zeros(N, bool), intr,
        ).Tcw)
        # The fused all-candidates program (the live LOST path).
        jax.block_until_ready(_reloc_candidates_program(
            frame.feats.desc, frame.feats.valid, frame.feats.angle,
            frame.xy_un, frame.sigma2,
            jnp.zeros(RELOC_C, jnp.int32),
            mir.kf_desc, mir.kf_angle, mir.kf_obs_point,
            mir.pt_xyz, mir.pt_valid,
            intr, jrandom.PRNGKey(1),
        )[0])

        # Mapping-side buckets (local BA, fuse, triangulation).
        self.mapper.warmup()

        if include_loop:
            from ..optim.pose_graph import optimize_pose_graph
            from .loop_closing import (
                _EDGE_BUCKETS, PROJ_CAP, _sim3_candidate_program,
            )

            # The fused per-candidate Sim3 program (match + RANSAC + LM +
            # guided projection in one dispatch).
            zd = jnp.zeros((N, 8), jnp.uint32)
            zb = jnp.zeros(N, bool)
            zf = jnp.zeros(N)
            z2 = jnp.zeros((N, 2))
            z3 = jnp.ones((N, 3)).at[:, 2].set(5.0)
            jax.block_until_ready(_sim3_candidate_program(
                zd, zb, zf, z2, jnp.zeros(N, jnp.int32), zb, z3,
                zd, zb, zf, z2, jnp.zeros(N, jnp.int32), z3,
                jnp.zeros((PROJ_CAP, 8), jnp.uint32),
                jnp.ones((PROJ_CAP, 3)).at[:, 2].set(5.0),
                jnp.zeros(PROJ_CAP, bool),
                eye, intr, jnp.asarray(cfg.sigma2_table), jrandom.PRNGKey(1),
            )[0])
            # Essential graph at its first two edge buckets (closures pad to
            # bucket shapes; larger buckets only occur on very dense maps).
            K_cap = self.store.cfg.max_keyframes
            for E_pad in _EDGE_BUCKETS[:2]:
                E_pad = int(E_pad)
                jax.block_until_ready(optimize_pose_graph(
                    jnp.tile(jnp.eye(4), (K_cap, 1, 1)),
                    jnp.ones(K_cap, bool),
                    jnp.zeros(K_cap, bool).at[0].set(True),
                    jnp.zeros(E_pad, jnp.int32), jnp.ones(E_pad, jnp.int32),
                    jnp.tile(jnp.eye(4), (E_pad, 1, 1)),
                    jnp.zeros(E_pad, bool).at[:2].set(True), iters=20,
                ))
        return _time.time() - t0

    # ------------------------------------------------------------------ #
    def track_monocular(self, img, timestamp: float = 0.0):
        """Feed one grayscale (or RGB) image. Returns (state, Tcw | None)
        (System::TrackMonocular, System.cc:115-152)."""
        img = np.asarray(img)
        if img.ndim == 3:
            from ..ops.image import rgb_to_gray
            import jax.numpy as jnp

            img = np.asarray(rgb_to_gray(jnp.asarray(img)))
        out = self.tracker.track(img, timestamp)
        if self.coop is not None:
            # One mapping micro-step per frame (two under backlog): the
            # stage dispatched last frame has had a full frame interval of
            # device time — its result is ready or nearly so.
            self.coop.step(budget=2 if self.coop.queue_size() >= 2 else 1)
        return out

    def set_far_parallax_param(self, param: int):
        """The reference viewer's 'Parámetro' trackbar (0..1000,
        Viewer.cc:133): param < 998 sets the far-point classification
        threshold umbralCos = 0.9 + param/10000 (LocalMapping.cc:202-204);
        larger values disable the umbralCosBajo band."""
        self.mapper.far_cos_user = (
            0.9 + param / 10000.0 if param < 998 else 0.9998
        )

    def activate_localization_mode(self):
        """Stop mapping; track against the frozen map (System.cc:154-158).
        The map is truly frozen: no keyframes are inserted
        (Tracking.cc:699-700) and no point statistics are written — the
        store is bit-identical afterwards."""
        self.enable_mapping = False
        self.tracker.only_tracking = True
        if self.coop is not None:
            self.coop.drain()
        if self.mapping_worker is not None:
            self.mapping_worker.wait_idle(timeout=120.0)

    def deactivate_localization_mode(self):
        self.enable_mapping = True
        self.tracker.only_tracking = False

    def reset(self):
        self.tracker.reset()  # on_reset callback clears the BoW database

    def flush(self):
        """Drain the pipelined in-flight frame and the keyframe queues
        (end of stream — the async analogue of waiting for the reference's
        worker threads to go idle)."""
        self.tracker.flush()
        if self.coop is not None:
            self.coop.drain()
        if self.mapping_worker is not None:
            self.mapping_worker.wait_idle(timeout=120.0)
        if self.loop_worker is not None:
            self.loop_worker.wait_idle(timeout=120.0)
        gba = self.loop_closer._gba_thread
        if gba is not None and gba.is_alive():
            gba.join(timeout=120.0)

    def shutdown(self):
        """Stop the worker threads (System::Shutdown, System.cc:169-182)."""
        self.flush()
        self.loop_closer._abort_running_gba()
        if self.mapping_worker is not None:
            self.mapping_worker.shutdown()
        if self.loop_worker is not None:
            self.loop_worker.shutdown()

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    # ------------------------------------------------------------------ #
    def save_map(self, base: str, options: int = 0):
        """Serialize the map in Osmap format (reference Osmap::mapSave,
        Osmap.cpp:68-178; wired to the viewer's save menu in the reference,
        main.cc:147-182)."""
        from ..io import osmap_io

        # The reference stops LocalMapping for the save (Osmap.cpp:70-73).
        if self.coop is not None:
            self.coop.drain()
        if self.mapping_worker is not None:
            self.mapping_worker.wait_idle(timeout=120.0)
        with self.lock:
            return osmap_io.save_map(self.store, self.cfg, base, options)

    def load_map(self, base: str):
        """Load an Osmap-format map and resume in LOST state: the next
        frames relocalize into the loaded map (Osmap::mapLoad semantics,
        Osmap.cpp:180-291)."""
        from ..io import osmap_io

        if self.coop is not None:
            self.coop.clear()
        if self.mapping_worker is not None:
            self.mapping_worker.request_reset()
            self.mapping_worker.wait_idle(timeout=120.0)
        with self.lock:
            header = osmap_io.load_map(self.store, self.cfg, base)
            # Rebuild the BoW database for relocalization.
            self.db.clear()
            for k in np.nonzero(self.store.kf_valid)[0]:
                _, _, bow = self.db.compute_bow(
                    self.store.kf_desc[k], self.store.kf_feat_valid[k]
                )
                self.db.add(int(k), bow)
            self.tracker.state = TrackingState.LOST
            self.tracker.last = None
            self.tracker.velocity = None
            kfs = np.nonzero(self.store.kf_valid)[0]
            self.tracker.ref_kf = int(kfs[-1]) if len(kfs) else -1
            self.mirror.refresh()
        return header

    def merge_session(self, base: str, max_probes: int = 8,
                      run_gba: bool = True) -> bool:
        """Multi-session mapping (BASELINE config 5): merge another
        session's saved Osmap into the live map. The loaded keyframes are
        aligned into this map's world frame via BoW place recognition + the
        loop-closing Sim3 pipeline (the natural substrate the reference's
        map load + relocalize provides, Osmap.cpp:180-291, generalized to
        two resident maps), duplicate landmarks from the matched keyframe
        pair are fused, and a global BA polishes the joint map.

        Returns True if a cross-session alignment was found and applied;
        on False the loaded keyframes/points are removed again."""
        from ..geometry import sim3 as sim3_mod
        from ..io import osmap_io
        import jax.numpy as jnp

        if self.coop is not None:
            self.coop.drain()
        if self.mapping_worker is not None:
            self.mapping_worker.wait_idle(timeout=120.0)
        with self.lock:
            kf_map, pt_map = osmap_io.merge_map(self.store, self.cfg, base)
            st = self.store
            merged_kfs = kf_map[kf_map >= 0].astype(np.int64)
            merged_pts_mask = np.zeros(st.cfg.max_points, bool)
            live_merged = pt_map[pt_map >= 0]
            merged_pts_mask[live_merged[st.pt_valid[live_merged]]] = True
            # BoW vectors for the merged keyframes (db queries only — they
            # are added to the database after alignment succeeds).
            bows = {}
            for k in merged_kfs:
                _, _, bows[int(k)] = self.db.compute_bow(
                    st.kf_desc[k], st.kf_feat_valid[k]
                )

            # Probe the best-matching resident keyframe per merged keyframe.
            lc = self.loop_closer
            probes = sorted(
                merged_kfs.tolist(),
                key=lambda k: -int(st.kf_feat_valid[k].sum()),
            )[:max_probes]
            hit = None
            for k in probes:
                cands, _ = self.db.query(bows[k])
                for cand in cands[:2]:
                    snap = lc._snapshot_sim3(int(k), int(cand))
                    ok, S_cl, pairs = lc._eval_sim3(snap)
                    if ok:
                        hit = (int(k), int(cand), S_cl, pairs)
                        break
                if hit:
                    break
            if hit is None:
                # No cross-session overlap found: roll the load back.
                for k in merged_kfs:
                    st.cull_keyframe(int(k))
                dead = np.nonzero(merged_pts_mask & st.pt_valid)[0]
                if len(dead):
                    st.cull_points(dead)
                self.mirror.refresh()
                return False

            kf, cand, S_cl, pairs = hit
            # S_cl: cand-camera -> kf-camera. The merged map's world (B)
            # maps into the resident world (A) by S_ba = (S_cl T_lw)^-1 T_kb
            # with T_lw = cand's (A-world) pose, T_kb = kf's B-world pose.
            T_lw = st.kf_T[cand]
            T_kb = st.kf_T[kf].copy()
            S_cw = (S_cl @ T_lw).astype(np.float32)
            S_ba = np.asarray(
                sim3_mod.inverse(jnp.asarray(S_cw))
            ) @ T_kb  # X_A = S_ba X_B
            S_ab = np.asarray(sim3_mod.inverse(jnp.asarray(S_ba.astype(np.float32))))

            # Transform merged geometry into the resident frame.
            pids = np.nonzero(merged_pts_mask & st.pt_valid)[0]
            st.pt_xyz[pids] = st.pt_xyz[pids] @ S_ba[:3, :3].T + S_ba[:3, 3]
            for k in merged_kfs:
                S_pose = (st.kf_T[k] @ S_ab).astype(np.float32)
                st.kf_T[k] = np.asarray(sim3_mod.to_se3(jnp.asarray(S_pose)))

            # Fuse the matched duplicate landmarks (the Sim3 inlier pairs
            # reference the same physical points: keep the resident one).
            obs_kf = st.kf_obs_point[kf]
            obs_cand = st.kf_obs_point[cand]
            for fk, fc in pairs:
                p_b, p_a = int(obs_kf[fk]), int(obs_cand[fc])
                if p_b < 0 or p_a < 0 or p_b == p_a:
                    continue
                if st.pt_valid[p_b] and st.pt_valid[p_a]:
                    st.replace_point(p_b, p_a)
            st.update_point_derived(
                pids[st.pt_valid[pids]], self.cfg.orb.scale_factor,
                self.cfg.orb.n_levels,
            )
            # Spanning-tree + place-recognition wiring for the merged side.
            st.kf_parent[kf] = cand
            self.loop_closer.loop_edges.append((min(kf, cand), max(kf, cand)))
            for k in merged_kfs:
                self.db.add(int(k), bows[int(k)])
            self.mirror.refresh()
        if run_gba:
            from .local_mapping import global_bundle_adjustment

            with self.lock:
                global_bundle_adjustment(self.store, self.cfg, iters=20)
                self.mirror.refresh()
        return True

    # ------------------------------------------------------------------ #
    def keyframe_trajectory(self):
        """[(timestamp, Twc 4x4)] for all live keyframes, sorted by time
        (SaveKeyFrameTrajectoryTUM source data, System.h:345-349)."""
        st = self.store
        out = []
        for k in np.nonzero(st.kf_valid)[0]:
            Tcw = st.kf_T[k]
            R = Tcw[:3, :3]
            Twc = np.eye(4, dtype=np.float64)
            Twc[:3, :3] = R.T
            Twc[:3, 3] = -R.T @ Tcw[:3, 3]
            out.append((float(st.kf_timestamp[k]), Twc))
        out.sort(key=lambda x: x[0])
        return out

    def frame_trajectory(self):
        """[(timestamp, frame_id, Tcw)] for every tracked frame, re-anchored
        through each frame's reference keyframe's current pose (loop/GBA
        corrections apply retroactively — SaveTrajectoryTUM semantics)."""
        with self.lock:
            return self.tracker.frame_trajectory()

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM format: 'timestamp tx ty tz qx qy qz qw' per keyframe."""
        from ..geometry import se3
        import jax.numpy as jnp

        with open(path, "w") as f:
            for ts, Twc in self.keyframe_trajectory():
                q = np.asarray(se3.to_quaternion(jnp.asarray(Twc[:3, :3])))
                t = Twc[:3, 3]
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )
