"""Device-resident mirror of the map store.

The host-side :class:`~os1_tpu.map.store.MapStore` owns all bookkeeping
(allocation, observation tables, culling) in numpy; per-frame device programs
must NOT re-upload map slices every frame — the tracker would need ~25 small
host->device transfers per frame, each with a fixed latency (what one costs
on an NVIDIA GPU is not measured).

The mirror keeps the arrays the per-frame program reads resident in device
memory and refreshes them only when the map actually changes (keyframe
insertion, local mapping, loop closure, load/reset) — the device-side
analogue of the reference's tracking thread reading the map under ``Map::mMutexMapUpdate``
between frames (reference Map.h:140, Tracking.cc:133): a frame sees one
consistent map version; map mutations publish a new version between frames.

Publishes are INCREMENTAL: the mirror keeps a host-side shadow of the
dynamic state, diffs it against the store (a ~2 ms vectorized compare), and
scatters only the changed point/keyframe rows onto the device — a typical
mapping-pass publish moves tens of KB instead of the ~2.7 MB wholesale
upload, which at 3-4 publishes per keyframe event saturated the host link
of the accelerator the system was first built on and queued every other
transfer behind it (not measured on the GPU). The publish runs under the map lock, so the diff is consistent; consumers
capture array refs under the same lock (jnp arrays are immutable, so a
captured set of refs is a consistent snapshot).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from .store import MapStore

# Dynamic point-block fields mirrored with row-diff scatter updates.
_PT_FIELDS = (
    "pt_xyz", "pt_desc", "pt_valid", "pt_normal", "pt_min_dist",
    "pt_max_dist", "pt_n_obs", "pt_obs_kf", "pt_obs_feat",
)
# Padded scatter-batch sizes (compile once per bucket).
_UPD_BUCKETS = (256, 1024, 4096, 16384)


@jax.jit
def _insert_row(kf_xy, kf_angle, kf_octave, kf_desc, kf_feat_valid, k,
                xy, angle, octave, desc, valid):
    return (
        kf_xy.at[k].set(xy),
        kf_angle.at[k].set(angle),
        kf_octave.at[k].set(octave),
        kf_desc.at[k].set(desc),
        kf_feat_valid.at[k].set(valid),
    )


@jax.jit
def _scatter_pts(cur, idx, rows):
    return tuple(a.at[idx].set(r) for a, r in zip(cur, rows))


@jax.jit
def _scatter_kf(feat_valid, obs_point, idx, fv_rows, op_rows):
    return feat_valid.at[idx].set(fv_rows), obs_point.at[idx].set(op_rows)


@jax.jit
def _scatter_rows(arr, idx, rows):
    return arr.at[idx].set(rows)


def _row_changed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n] bool: any element differs in row i (works for any rank >= 1)."""
    d = a != b
    return d.reshape(len(d), -1).any(axis=1) if d.ndim > 1 else d


@dataclass
class DeviceMirror:
    store: MapStore
    # --- point block (scatter-updated on map events) ---
    pt_xyz: jnp.ndarray = field(init=False)  # [P, 3] f32
    pt_desc: jnp.ndarray = field(init=False)  # [P, 8] u32
    pt_valid: jnp.ndarray = field(init=False)  # [P] bool
    pt_normal: jnp.ndarray = field(init=False)  # [P, 3] f32
    pt_min_dist: jnp.ndarray = field(init=False)  # [P] f32
    pt_max_dist: jnp.ndarray = field(init=False)  # [P] f32
    pt_n_obs: jnp.ndarray = field(init=False)  # [P] i32
    pt_obs_kf: jnp.ndarray = field(init=False)  # [P, M] i32
    pt_obs_feat: jnp.ndarray = field(init=False)  # [P, M] i32
    # --- keyframe block (rows refreshed as keyframes change) ---
    kf_T: jnp.ndarray = field(init=False)  # [K, 4, 4] f32
    kf_valid: jnp.ndarray = field(init=False)  # [K] bool
    kf_xy: jnp.ndarray = field(init=False)  # [K, N, 2] f32
    kf_angle: jnp.ndarray = field(init=False)  # [K, N] f32
    kf_octave: jnp.ndarray = field(init=False)  # [K, N] i32
    kf_desc: jnp.ndarray = field(init=False)  # [K, N, 8] u32
    kf_feat_valid: jnp.ndarray = field(init=False)  # [K, N] bool
    kf_obs_point: jnp.ndarray = field(init=False)  # [K, N] i32

    version: int = field(init=False, default=0)

    def __post_init__(self):
        # Keyframe rows published straight from device frames whose HOST
        # feat_valid row is still all-False (deferred materialization): the
        # diff publisher must NOT clobber their live kf_feat_valid row with
        # the store's False until the store materializes.
        self._pending_rows = set()
        self.refresh()

    # ------------------------------------------------------------------ #
    def refresh(self) -> None:
        """Full re-publish of every mirrored array from the host store.
        Used at construction, reset, map load, and loop corrections (which
        move nearly everything anyway)."""
        st = self.store
        for f in _PT_FIELDS:
            setattr(self, f, jnp.asarray(getattr(st, f)))
        self.kf_T = jnp.asarray(st.kf_T)
        self.kf_valid = jnp.asarray(st.kf_valid)
        self.kf_xy = jnp.asarray(st.kf_xy)
        self.kf_angle = jnp.asarray(st.kf_angle)
        self.kf_octave = jnp.asarray(st.kf_octave)
        self.kf_desc = jnp.asarray(st.kf_desc)
        self.kf_feat_valid = jnp.asarray(st.kf_feat_valid)
        self.kf_obs_point = jnp.asarray(st.kf_obs_point)
        self._shadow = {f: getattr(st, f).copy() for f in _PT_FIELDS}
        self._shadow["kf_feat_valid"] = st.kf_feat_valid.copy()
        self._shadow["kf_obs_point"] = st.kf_obs_point.copy()
        # Device-published pending rows are clobbered by a wholesale
        # republish; their observations stay excluded (feat_valid False)
        # until the host materializes them — safe, merely conservative.
        self._pending_rows = set()
        self.version += 1

    def refresh_dynamic(self) -> None:
        """Incremental publish of the mutable state: diff the store against
        the shadow, scatter changed point rows / keyframe binding rows, and
        re-upload the (small) pose + liveness arrays wholesale."""
        st = self.store
        sh = self._shadow

        changed = np.zeros(st.cfg.max_points, bool)
        for f in _PT_FIELDS:
            changed |= _row_changed(getattr(st, f), sh[f])
        idx = np.nonzero(changed)[0]
        P = st.cfg.max_points
        if len(idx) > P // 4:
            # Bulk change (loop correction / GBA): wholesale is cheaper.
            for f in _PT_FIELDS:
                setattr(self, f, jnp.asarray(getattr(st, f)))
                sh[f] = getattr(st, f).copy()
        elif len(idx):
            D = next(b for b in _UPD_BUCKETS if b >= len(idx))
            pidx = np.full(D, idx[0], np.int32)
            pidx[: len(idx)] = idx
            rows = tuple(
                jnp.asarray(np.ascontiguousarray(getattr(st, f)[pidx]))
                for f in _PT_FIELDS
            )
            out = _scatter_pts(
                tuple(getattr(self, f) for f in _PT_FIELDS),
                jnp.asarray(pidx), rows,
            )
            for f, a in zip(_PT_FIELDS, out):
                setattr(self, f, a)
                sh[f][idx] = getattr(st, f)[idx]

        # Keyframe dynamic state: poses + liveness are tiny (<10 KB), the
        # per-feature binding rows are diffed per keyframe.
        self.kf_T = jnp.asarray(st.kf_T)
        self.kf_valid = jnp.asarray(st.kf_valid)
        # Pending device-inserted rows graduate once the store materializes
        # (or the keyframe dies): from then on the store is authoritative.
        if self._pending_rows:
            self._pending_rows = {
                k for k in self._pending_rows
                if st.kf_valid[k] and not st.kf_feat_valid[k].any()
            }
        kch_fv = _row_changed(st.kf_feat_valid, sh["kf_feat_valid"])
        kch_op = _row_changed(st.kf_obs_point, sh["kf_obs_point"])
        # Do not push the store's all-False feat_valid over a live
        # device-published row (the keyframe's features exist on device; the
        # host materializes them later).
        for k in self._pending_rows:
            kch_fv[k] = False
        K = st.cfg.max_keyframes
        fidx = np.nonzero(kch_fv)[0]
        if len(fidx) > K // 4:
            keep = None
            if self._pending_rows:
                pk = np.array(sorted(self._pending_rows), np.int32)
                keep = np.asarray(self.kf_feat_valid[jnp.asarray(pk)])
            self.kf_feat_valid = jnp.asarray(st.kf_feat_valid)
            if keep is not None:
                self.kf_feat_valid = _scatter_rows(
                    self.kf_feat_valid, jnp.asarray(pk), jnp.asarray(keep)
                )
            sh["kf_feat_valid"] = st.kf_feat_valid.copy()
        elif len(fidx):
            D = next(b for b in (4, 16, 64, K) if b >= len(fidx))
            pk = np.full(D, fidx[0], np.int32)
            pk[: len(fidx)] = fidx
            self.kf_feat_valid = _scatter_rows(
                self.kf_feat_valid, jnp.asarray(pk),
                jnp.asarray(np.ascontiguousarray(st.kf_feat_valid[pk])),
            )
            sh["kf_feat_valid"][fidx] = st.kf_feat_valid[fidx]
        oidx = np.nonzero(kch_op)[0]
        if len(oidx) > K // 4:
            self.kf_obs_point = jnp.asarray(st.kf_obs_point)
            sh["kf_obs_point"] = st.kf_obs_point.copy()
        elif len(oidx):
            D = next(b for b in (4, 16, 64, K) if b >= len(oidx))
            pk = np.full(D, oidx[0], np.int32)
            pk[: len(oidx)] = oidx
            self.kf_obs_point = _scatter_rows(
                self.kf_obs_point, jnp.asarray(pk),
                jnp.asarray(np.ascontiguousarray(st.kf_obs_point[pk])),
            )
            sh["kf_obs_point"][oidx] = st.kf_obs_point[oidx]
        self.version += 1

    def insert_keyframe_row(self, k: int) -> None:
        """Publish one new keyframe's static feature arrays (row k)."""
        st = self.store
        self.kf_xy = self.kf_xy.at[k].set(jnp.asarray(st.kf_xy[k]))
        self.kf_angle = self.kf_angle.at[k].set(jnp.asarray(st.kf_angle[k]))
        self.kf_octave = self.kf_octave.at[k].set(jnp.asarray(st.kf_octave[k]))
        self.kf_desc = self.kf_desc.at[k].set(jnp.asarray(st.kf_desc[k]))

    def insert_keyframe_row_device(self, k: int, frame) -> None:
        """Publish a new keyframe row straight from the frame's
        device-resident feature arrays — zero host<->device bytes (the frame
        was extracted on device; the host store row materializes later on
        the mapping worker). kf_feat_valid is included: device-side
        consumers (fusion targets, BA observation gathers) gate on it, and
        the mirror row is REAL from creation even though the host store's
        row materializes later. The host shadow still holds False for this
        row, so the later materialization diff simply re-publishes the same
        values."""
        (self.kf_xy, self.kf_angle, self.kf_octave, self.kf_desc,
         self.kf_feat_valid) = _insert_row(
            self.kf_xy, self.kf_angle, self.kf_octave,
            self.kf_desc, self.kf_feat_valid, jnp.int32(k), frame.xy_un,
            frame.feats.angle, frame.feats.octave, frame.feats.desc,
            frame.feats.valid,
        )
        self._pending_rows.add(int(k))

    def refresh_points(self) -> None:
        """Re-publish the mutable state (alias kept for callers that only
        changed points; the diff makes the distinction moot)."""
        self.refresh_dynamic()
