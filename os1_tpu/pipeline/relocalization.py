"""Relocalization: BoW candidate retrieval -> descriptor matching -> RANSAC
PnP -> LM pose polish (reference Tracking::Relocalization,
Tracking.cc:969-1131).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..map.store import MapStore
from ..matching import core as mcore
from ..optim import optimize_pose
from ..solvers.pnp import solve_pnp
from ..vocab.database import KeyFrameDatabase
from .config import SlamConfig
from .frame import FrameData


@jax.jit
def _match_frame_to_kf_points(frame_desc, frame_valid, frame_angle,
                              kf_desc, kf_angle, kf_has_pt):
    """Descriptor matching of frame features to point-bound KF features
    (the reference's SearchByBoW; dense gated matching here)."""
    gate = frame_valid[:, None] & kf_has_pt[None, :]
    res = mcore.match_with_gate(frame_desc, kf_desc, gate,
                                max_dist=mcore.TH_LOW, ratio=0.75)
    res = mcore.mutual_best(res, kf_desc.shape[0])
    return mcore.rotation_consistency(frame_angle, kf_angle, res)


RELOC_C = 5  # fixed candidate batch (reference: up to 5, Tracking.cc:1006)


@jax.jit
def _reloc_candidates_program(
    frame_desc, frame_valid, frame_angle, xy_un, sigma2,  # the lost frame
    cand_idx,  # [C] int32 — candidate keyframe mirror rows
    kf_desc, kf_angle, kf_obs_point,  # mirror [K, N, ...]
    pt_xyz, pt_valid,  # mirror [P, ...]
    intr, key,
):
    """EVERY relocalization candidate evaluated in ONE device program:
    SearchByBoW match -> 256-hypothesis PnP RANSAC -> LM pose polish, per
    candidate as vmapped lanes (reference Tracking::Relocalization's serial
    per-candidate loop, Tracking.cc:1005-1117 — the serial form paid ~4
    host round trips x 5 candidates per attempt; this is one).

    The candidate rows and their bound points are gathered FROM THE MIRROR
    by index — the host uploads 5 integers, not 5 keyframes.

    Returns (head [C, 20]: n_match, pnp_ok, n_good, pad, Tcw flat 16;
    bind [C, N] int32 global point ids per frame feature, -1 unbound)."""
    C = cand_idx.shape[0]
    N = frame_desc.shape[0]
    cdesc = kf_desc[cand_idx]  # [C, N, 8]
    cangle = kf_angle[cand_idx]
    cobs = kf_obs_point[cand_idx]  # [C, N]
    has_pt = (cobs >= 0) & pt_valid[jnp.clip(cobs, 0, None)]
    cxyz = pt_xyz[jnp.clip(cobs, 0, None)]  # [C, N, 3]

    # One distance table for all candidates: a single [N, C*N] call
    # instead of C smaller ones.
    D = mcore.distance_matrix(frame_desc, cdesc.reshape(C * N, 8))
    D = D.reshape(N, C, N).transpose(1, 0, 2)  # [C, N, N]
    keys = jax.random.split(key, C)

    def one(dist, desc2, angle2, hp, xyz, obs_row, k):
        gate = frame_valid[:, None] & hp[None, :]
        res = mcore.match_with_gate(frame_desc, desc2, gate,
                                    max_dist=mcore.TH_LOW, ratio=0.75,
                                    dist=dist)
        res = mcore.mutual_best(res, N)
        res = mcore.rotation_consistency(frame_angle, angle2, res)
        n_match = jnp.sum(res.ok)
        idx = jnp.clip(res.idx, 0, None)
        pts = xyz[idx]  # [N, 3] world position of each feature's match
        pnp = solve_pnp(pts, xy_un, sigma2, res.ok, intr, k)
        opt = optimize_pose(pnp.Tcw, pts, xy_un, sigma2, pnp.inliers, intr)
        bind = jnp.where(opt.inlier & res.ok, obs_row[idx], -1)
        head = jnp.concatenate([
            jnp.stack([
                n_match.astype(jnp.float32),
                pnp.success.astype(jnp.float32),
                opt.n_inliers.astype(jnp.float32),
                jnp.float32(0.0),
            ]),
            opt.Tcw.reshape(-1),
        ])
        return head, bind.astype(jnp.int32)

    return jax.vmap(one)(D, cdesc, cangle, has_pt, cxyz, cobs, keys)


@dataclass
class Relocalizer:
    cfg: SlamConfig
    store: MapStore
    db: KeyFrameDatabase
    max_candidates: int = 5
    # Device mirror (map/mirror.DeviceMirror), wired by System. When set,
    # all candidates are evaluated in ONE fused device program gathering
    # rows from device memory; None falls back to the serial per-candidate path.
    mirror: object = None
    # One-shot console detail of the next relocalization attempt (the
    # reference's 'v' key -> KeyFrameDatabase::verbose, Viewer.cc:247-248).
    verbose: bool = False

    def __post_init__(self):
        self._key = jax.random.PRNGKey(42)
        self._intr = jnp.asarray(self.cfg.intr)

    def _candidates(self, frame: FrameData):
        """BoW retrieval: candidate keyframes in protocol order."""
        st = self.store
        desc = np.asarray(frame.feats.desc)
        valid = np.asarray(frame.feats.valid)
        _, _, bow = self.db.compute_bow(desc, valid)
        # Reference protocol: candidates accumulated over covisibility groups
        # (DetectRelocalizationCandidates, KeyFrameDatabase.cc:199-336).
        cands = self.db.detect_reloc_candidates(
            bow, covis_fn=lambda k: st.covisible_keyframes(k, top=10)
        )
        # HUD introspection (reference relocalizacionCandidatos count shown
        # while LOST, FrameDrawer.cc:197).
        self.last_n_candidates = len(cands)
        if self.verbose:
            self.verbose = False  # one-shot, as in the reference
            print(f"[reloc] {len(cands)} candidates: {list(map(int, cands[:8]))}")
        return cands

    def __call__(self, frame: FrameData):
        """Attempt relocalization. Returns (ok, Tcw, bind [N] point ids)."""
        cands = self._candidates(frame)
        if self.mirror is not None:
            return self._call_fused(frame, cands)
        return self._call_serial(frame, cands)

    def _call_fused(self, frame: FrameData, cands):
        """All candidates in one dispatch (match + PnP + polish per lane),
        then the reference's per-candidate acceptance walk over the tiny
        result head — first candidate clearing every gate wins, identical
        decisions to the serial loop."""
        st = self.store
        keep = []
        for kf in cands[: self.max_candidates]:
            kf = int(kf)
            obs_pt = st.kf_obs_point[kf]
            has_pt = (obs_pt >= 0) & st.pt_valid[np.clip(obs_pt, 0, None)]
            if has_pt.sum() >= 15:
                keep.append(kf)
        if not keep:
            return False, None, None
        cand_idx = np.full(RELOC_C, keep[0], np.int32)
        cand_idx[: len(keep)] = keep[:RELOC_C]

        mir = self.mirror
        self._key, sub = jax.random.split(self._key)
        head, bind = _reloc_candidates_program(
            frame.feats.desc, frame.feats.valid, frame.feats.angle,
            frame.xy_un, frame.sigma2,
            jnp.asarray(cand_idx),
            mir.kf_desc, mir.kf_angle, mir.kf_obs_point,
            mir.pt_xyz, mir.pt_valid,
            self._intr, sub,
        )
        from ..utils.transfer import fetch

        head, bind = fetch((head, bind))
        for i, kf in enumerate(keep):
            n_match, pnp_ok, n_good = head[i, 0], head[i, 1], head[i, 2]
            if n_match < 15 or pnp_ok < 0.5 or n_good < 10:
                continue  # reference gates (Tracking.cc:1014,1050)
            Tcw = head[i, 4:20].reshape(4, 4).astype(np.float32)
            b = bind[i].astype(np.int64)
            # Binds may reference points culled since the mirror publish.
            b = np.where((b >= 0) & st.pt_valid[np.clip(b, 0, None)], b, -1)
            n_good = int(n_good)
            if n_good < 50:
                region_pts = self._region_points(kf)
                for radius in (10.0, 3.0):
                    if n_good >= 50 or len(region_pts) == 0:
                        break
                    Tcw, b, n_good = self._guided_round(
                        frame, Tcw, b, region_pts, radius
                    )
            if n_good < 50:
                continue
            self.last_reloc_kf = kf  # the matched keyframe (new ref)
            return True, Tcw, b
        return False, None, None

    def _call_serial(self, frame: FrameData, cands):
        st = self.store
        for kf in cands[: self.max_candidates]:
            kf = int(kf)
            obs_pt = st.kf_obs_point[kf]
            has_pt = (obs_pt >= 0) & st.pt_valid[np.clip(obs_pt, 0, None)]
            if has_pt.sum() < 15:
                continue
            res = _match_frame_to_kf_points(
                frame.feats.desc, frame.feats.valid, frame.feats.angle,
                jnp.asarray(st.kf_desc[kf]), jnp.asarray(st.kf_angle[kf]),
                jnp.asarray(has_pt),
            )
            ok_np = np.asarray(res.ok)
            if ok_np.sum() < 15:  # reference: nmatches < 15 -> skip
                continue
            idx_np = np.asarray(res.idx)
            pt_ids = np.where(ok_np, obs_pt[np.clip(idx_np, 0, None)], -1)
            pts = st.pt_xyz[np.clip(pt_ids, 0, None)]

            self._key, sub = jax.random.split(self._key)
            pnp = solve_pnp(
                jnp.asarray(pts), frame.xy_un, frame.sigma2,
                jnp.asarray(pt_ids >= 0), self._intr, sub,
            )
            if not bool(pnp.success):
                continue
            # LM polish over PnP inliers (reference: PoseOptimization after
            # each RANSAC iterate, >= 10 inliers to continue, Tracking.cc:1050).
            opt = optimize_pose(
                pnp.Tcw, jnp.asarray(pts), frame.xy_un, frame.sigma2,
                pnp.inliers, self._intr,
            )
            n_good = int(opt.n_inliers)
            if n_good < 10:
                continue
            inlier = np.asarray(opt.inlier)
            Tcw = np.asarray(opt.Tcw)
            bind = np.where(inlier, pt_ids, -1)
            # Escalation (Tracking.cc:1079-1108): below 50 inliers, run up to
            # two guided SearchByProjection + re-optimize rounds over the
            # candidate's covisibility region — first a wide window, then a
            # narrow one around the refined pose.
            if n_good < 50:
                region_pts = self._region_points(kf)
                for radius in (10.0, 3.0):
                    if n_good >= 50 or len(region_pts) == 0:
                        break
                    Tcw, bind, n_good = self._guided_round(
                        frame, Tcw, bind, region_pts, radius
                    )
            if n_good < 50:
                continue
            self.last_reloc_kf = kf  # the matched keyframe (new ref)
            return True, Tcw, bind
        return False, None, None

    def _region_points(self, kf: int) -> np.ndarray:
        """Map points of the candidate keyframe's covisibility region."""
        st = self.store
        region = [kf] + [int(k) for k in st.covisible_keyframes(kf, top=10)]
        pts = st.kf_obs_point[region]
        pts = np.unique(pts[pts >= 0])
        return pts[st.pt_valid[pts]]

    def _guided_round(self, frame, Tcw, bind, region_pts, radius):
        """One guided projection-matching + pose-optimization round."""
        from . import tracking_kernels as tk

        st = self.store
        P = self.cfg.th.max_local_points
        ids = np.zeros(P, np.int64)
        valid = np.zeros(P, bool)
        m = min(len(region_pts), P)
        ids[:m] = region_pts[:m]
        valid[:m] = ~np.isin(ids[:m], bind[bind >= 0])
        prev_bound = bind >= 0
        prev_xyz = st.pt_xyz[np.clip(bind, 0, None)].astype(np.float32)
        T, lbind, inl, n, _ = tk.track_points(
            jnp.asarray(Tcw.astype(np.float32)),
            jnp.asarray(st.pt_xyz[ids].astype(np.float32)),
            jnp.asarray(st.pt_desc[ids]),
            jnp.asarray(valid & st.pt_valid[ids]),
            jnp.zeros(P, jnp.int32),
            jnp.asarray(st.pt_normal[ids]),
            jnp.asarray(st.pt_min_dist[ids]),
            jnp.asarray(np.nan_to_num(st.pt_max_dist[ids], posinf=1e9)),
            jnp.asarray(prev_bound),
            jnp.asarray(prev_xyz), jnp.asarray(prev_bound),
            frame, self.cfg.camera, self._intr, jnp.float32(radius),
            scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels,
            use_frustum=True, ratio=0.9,
        )
        from ..utils.transfer import fetch
        lbind, inl, n, T = fetch((lbind, inl, n, T))
        new_bind = np.where(
            lbind >= 0, ids[np.clip(lbind, 0, None)],
            np.where(prev_bound & inl, bind, -1),
        )
        return np.asarray(T), new_bind, int(n)
