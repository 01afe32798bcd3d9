"""Parity: mirror-gather kernels vs the row-upload kernels.

The live mapper gathers keyframe feature rows and the point slice from the
device mirror by index (tk.triangulate_mirror_batch / tk.fuse_mirror_batch
— uploads ~100 KB of poses+masks+indices instead of MBs of gathered
rows). Both variants must produce IDENTICAL outputs
from the same underlying values — this pins the gather indexing so the two
paths cannot silently drift (advisor r2 finding: the mirror variants were
dead code with no coverage).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from os1_tpu.pipeline import tracking_kernels as tk


N = 64          # features per keyframe
KROWS = 6       # mirror keyframe capacity
ROW_NEW = 2     # mirror row of the "new" keyframe
ROW_NB = 4      # mirror row of the neighbor
FX = FY = 100.0
CX, CY = 40.0, 30.0
SIGMA2 = ((1.2 ** 2) ** np.arange(8)).astype(np.float32)


def _geometry(seed=0):
    """Two views of a shared point cloud with exact-match descriptors, plus
    junk in every other mirror row (wrong gathers would pick the junk)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.0, -1.0, 4.0], [1.0, 1.0, 8.0], (N, 3)).astype(np.float32)
    T_new = np.eye(4, dtype=np.float32)
    T_nb = np.eye(4, dtype=np.float32)
    T_nb[0, 3] = -0.3  # baseline

    def proj(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack(
            [FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1
        ).astype(np.float32)

    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    kf_xy = rng.uniform(0, 80, (KROWS, N, 2)).astype(np.float32)
    kf_angle = np.zeros((KROWS, N), np.float32)
    kf_octave = np.zeros((KROWS, N), np.int32)
    kf_desc = rng.integers(0, 2 ** 32, (KROWS, N, 8), dtype=np.uint64).astype(
        np.uint32
    )
    kf_xy[ROW_NEW], kf_xy[ROW_NB] = proj(T_new), proj(T_nb)
    kf_desc[ROW_NEW] = kf_desc[ROW_NB] = desc
    K33 = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    return X, T_new, T_nb, desc, kf_xy, kf_angle, kf_octave, kf_desc, K33


def test_triangulate_mirror_matches_row_upload():
    (X, T_new, T_nb, desc, kf_xy, kf_angle, kf_octave, kf_desc, K33) = _geometry()
    NB = 2
    all_nb = np.array([ROW_NB, ROW_NEW], np.int32)  # 2nd lane = self (pad)
    T_nbs = np.stack([T_nb, T_new])
    unbound_new = np.ones(N, bool)
    unbound_nb = np.stack([np.ones(N, bool), np.zeros(N, bool)])
    md = np.float32(5.0)

    ref = tk.triangulate_with_neighbors_batch(
        jnp.asarray(T_new), jnp.asarray(T_nbs),
        jnp.asarray(kf_xy[ROW_NEW]), jnp.asarray(kf_desc[ROW_NEW]),
        jnp.asarray(kf_angle[ROW_NEW]), jnp.asarray(kf_octave[ROW_NEW]),
        jnp.asarray(unbound_new),
        jnp.asarray(kf_xy[all_nb]), jnp.asarray(kf_desc[all_nb]),
        jnp.asarray(kf_angle[all_nb]), jnp.asarray(kf_octave[all_nb]),
        jnp.asarray(unbound_nb),
        jnp.asarray(K33), jnp.asarray(SIGMA2), md,
    )
    mir = tk.triangulate_mirror_batch(
        jnp.asarray(T_new), jnp.asarray(T_nbs),
        jnp.int32(ROW_NEW), jnp.asarray(all_nb),
        jnp.asarray(kf_xy), jnp.asarray(kf_angle),
        jnp.asarray(kf_octave), jnp.asarray(kf_desc),
        jnp.asarray(unbound_new), jnp.asarray(unbound_nb),
        jnp.asarray(K33), jnp.asarray(SIGMA2), md,
    )
    accepted = np.asarray(ref[2])
    assert accepted.any(), "fixture should triangulate something"
    # The mirror variant returns the COMPACTED form (tk._pack_tri):
    # unpack it back to dense [NB, N] and compare against the row-upload
    # reference outputs.
    code, pts_c, far_c, nbf_c, _cosp = (np.asarray(a) for a in mir)
    NB_, N_ = accepted.shape
    acc_m = np.zeros((NB_, N_), bool)
    pts_m = np.zeros((NB_, N_, 3), np.float32)
    far_m = np.zeros((NB_, N_), bool)
    nbi_m = np.full((NB_, N_), -1, np.int32)
    sel = code >= 0
    nb_i, ft_i = code[sel] // N_, code[sel] % N_
    acc_m[nb_i, ft_i] = True
    pts_m[nb_i, ft_i] = pts_c[sel]
    far_m[nb_i, ft_i] = far_c[sel]
    nbi_m[nb_i, ft_i] = nbf_c[sel]
    np.testing.assert_array_equal(accepted, acc_m)
    np.testing.assert_array_equal(
        np.asarray(ref[1])[accepted], pts_m[accepted]
    )
    np.testing.assert_array_equal(np.asarray(ref[3])[accepted], far_m[accepted])
    np.testing.assert_array_equal(
        np.asarray(ref[0])[accepted], nbi_m[accepted]
    )


def test_fuse_pairs_mirror_matches_row_upload():
    """The pair-lane mirror kernel (candidates gathered on device from
    kf_obs_point + validity from pt_obs_kf) must produce the same fuse
    matches as fuse_batch fed the equivalent host-packed candidate table."""
    (X, T_new, T_nb, desc, kf_xy, kf_angle, kf_octave, kf_desc, K33) = _geometry()
    rng = np.random.default_rng(1)
    P = 128  # mirror point capacity
    C = 64   # candidate bucket (= N here)
    M = 4    # obs slots per point
    pt_xyz = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    pt_desc = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint64).astype(np.uint32)
    pt_max_dist = np.full(P, 100.0, np.float32)
    pt_valid = np.zeros(P, bool)
    sl = rng.permutation(P)[: N].astype(np.int32)  # src row's bound points
    pt_xyz[sl] = X
    pt_desc[sl] = desc
    pt_valid[sl] = True
    pt_max_dist[sl] = np.linalg.norm(X, axis=1) * 1.2
    # Observation table: each slice point observed in the SOURCE row only.
    pt_obs_kf = np.full((P, M), -1, np.int32)
    pt_obs_kf[sl, 0] = ROW_NEW
    kf_obs_point = np.full((KROWS, N), -1, np.int32)
    kf_obs_point[ROW_NEW] = sl  # src row: feature i bound to point sl[i]
    kf_feat_valid = np.zeros((KROWS, N), bool)
    kf_feat_valid[ROW_NEW] = kf_feat_valid[ROW_NB] = True
    intr = np.array([FX, FY, CX, CY], np.float32)
    args_tail = (
        jnp.asarray(intr), jnp.float32(80.0), jnp.float32(60.0),
        jnp.float32(1.2),
    )

    # Reference: fuse_batch with the equivalent host-packed candidates
    # (target ROW_NB receives the src row's points, slice order = feature
    # order, so candidate slots == src feature indices).
    sl_pad = np.concatenate([sl, np.zeros(2 * C - len(sl), np.int32)])
    ref = tk.fuse_batch(
        jnp.asarray(T_nb[None]),
        jnp.asarray(kf_xy[ROW_NB][None]), jnp.asarray(kf_angle[ROW_NB][None]),
        jnp.asarray(kf_octave[ROW_NB][None]), jnp.asarray(kf_desc[ROW_NB][None]),
        jnp.asarray(np.ones((1, N), bool)),
        jnp.asarray(np.arange(C, dtype=np.int32)[None]),
        jnp.asarray(np.ones((1, C), bool)),
        jnp.asarray(pt_xyz[sl_pad]), jnp.asarray(pt_desc[sl_pad]),
        jnp.asarray(np.nan_to_num(pt_max_dist[sl_pad], posinf=1e9)),
        *args_tail, n_levels=8,
    )
    pairs = tk.fuse_pairs_mirror(
        jnp.asarray(T_nb[None]),
        jnp.asarray(np.array([ROW_NB], np.int32)),
        jnp.asarray(np.array([ROW_NEW], np.int32)),
        jnp.asarray(np.ones(1, bool)),
        jnp.asarray(kf_xy), jnp.asarray(kf_angle),
        jnp.asarray(kf_octave), jnp.asarray(kf_desc),
        jnp.asarray(kf_feat_valid), jnp.asarray(kf_obs_point),
        jnp.asarray(pt_xyz), jnp.asarray(pt_desc), jnp.asarray(pt_max_dist),
        jnp.asarray(pt_valid), jnp.asarray(pt_obs_kf),
        *args_tail, n_levels=8,
    )
    ref_codes = np.asarray(ref)[0]
    pair_codes = np.asarray(pairs)[0]
    ref_set = set(ref_codes[ref_codes >= 0].tolist())
    pair_set = set(pair_codes[pair_codes >= 0].tolist())
    assert ref_set, "fixture should fuse something"
    assert ref_set == pair_set
