"""Bundle adjustment with explicit Schur complement — the g2o BlockSolver_6_3
replacement (reference Optimizer::BundleAdjustment Optimizer.cc:49-204 and
Optimizer::LocalBundleAdjustment Optimizer.cc:340-589).

Design (accelerator-first):
  * Observations are stored GROUPED BY POINT in fixed-shape padded arrays
    [P, O]: this makes landmark marginalization (the Schur trick g2o gets
    from setMarginalized(true), Optimizer.cc:98) a batched 3x3 inverse over
    points, and the reduced-camera-system assembly a single scatter-add of
    [P, O, O] 6x6 block products — no sparse matrix structures.
  * The reduced system S (6C x 6C, C = #cameras <= a few hundred for local
    BA) is solved densely on the device; fixed cameras are projected out by
    masking rows/columns.
  * LM loop with multiplicative damping and branchless accept/reject; the
    abort-BA preemption of the reference (mbAbortBA, LocalMapping.cc:116)
    maps to chunked host calls — run_ba is cheap to call for a few
    iterations at a time.

Distributed note: every per-point quantity (H_pp, W, Y, S contributions)
is independent across points, so sharding the P axis over a device mesh and
psum-ing S and b_red gives the distributed Schur BA of BASELINE.json
configs 4-5 (see parallel/dist_ba.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import reprojection as rp

CHI2_MONO = 5.991


class BAProblem(NamedTuple):
    """Fixed-shape masked BA problem, observations grouped by point."""

    cam_T: jnp.ndarray  # [C, 4, 4] world-to-camera poses
    cam_fixed: jnp.ndarray  # [C] bool — poses held constant (boundary KFs)
    points: jnp.ndarray  # [P, 3]
    point_valid: jnp.ndarray  # [P] bool
    obs_cam: jnp.ndarray  # [P, O] int32 camera index per observation slot
    obs_uv: jnp.ndarray  # [P, O, 2] undistorted pixel measurements
    obs_sigma2: jnp.ndarray  # [P, O] squared octave scale
    obs_valid: jnp.ndarray  # [P, O] bool
    intr: jnp.ndarray  # [4] fx, fy, cx, cy


class BAResult(NamedTuple):
    cam_T: jnp.ndarray
    points: jnp.ndarray
    obs_inlier: jnp.ndarray  # [P, O] final chi2 + depth classification
    cost: jnp.ndarray


def _per_obs_terms(prob: BAProblem, cam_T, points, active):
    """Residuals, Jacobians and IRLS weights for every (point, obs) slot."""
    Tcw = cam_T[prob.obs_cam]  # [P, O, 4, 4]
    X = points[:, None, :]  # broadcast over obs slots
    r = rp.residual(Tcw, jnp.broadcast_to(X, prob.obs_uv.shape[:2] + (3,)), prob.obs_uv, prob.intr)
    J_c, J_p = rp.jacobians(Tcw, jnp.broadcast_to(X, prob.obs_uv.shape[:2] + (3,)), prob.intr)
    r = jnp.where(active[..., None], r, 0.0)
    J_c = jnp.where(active[..., None, None], J_c, 0.0)
    J_p = jnp.where(active[..., None, None], J_p, 0.0)
    inv_s2 = 1.0 / jnp.clip(prob.obs_sigma2, 1e-8, None)
    chi2 = jnp.sum(r * r, axis=-1) * inv_s2
    w = rp.huber_weight(chi2, rp.HUBER_MONO) * inv_s2
    w = jnp.where(active, w, 0.0)
    d2 = rp.HUBER_MONO**2
    rho = jnp.where(chi2 <= d2, chi2, 2.0 * jnp.sqrt(chi2 * d2) - d2)
    cost = jnp.sum(jnp.where(active, rho, 0.0))
    return r, J_c, J_p, w, cost


def _cost_only(prob: BAProblem, cam_T, points, active):
    return _per_obs_terms(prob, cam_T, points, active)[4]


def assemble_reduced(prob: BAProblem, cam_T, points, active, lam):
    """Build the point-marginalized (Schur-reduced) camera system from this
    problem's observations.

    Returns (S [C, C, 6, 6], b_red [C, 6], H_pp_inv [P, 3, 3], W [P, O, 6, 3],
    b_p [P, 3]). Every output except S/b_red is per-point; S and b_red are
    SUMS over points — which is exactly what makes the distributed version a
    psum over point shards (parallel/dist_ba.py).
    """
    C = cam_T.shape[0]
    P, O = prob.obs_valid.shape
    r, J_c, J_p, w, _ = _per_obs_terms(prob, cam_T, points, active)

    # Landmark blocks.
    H_pp = jnp.einsum("poki,po,pokj->pij", J_p, w, J_p)  # [P, 3, 3]
    b_p = jnp.einsum("poki,po,pok->pi", J_p, w, r)  # [P, 3]
    H_pp = H_pp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(H_pp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    )
    # Freeze invalid points with identity blocks (keeps the inverse finite).
    pv = prob.point_valid
    H_pp = jnp.where(pv[:, None, None], H_pp, jnp.eye(3))
    b_p = jnp.where(pv[:, None], b_p, 0.0)
    H_pp_inv = jnp.linalg.inv(H_pp)

    # Per-observation camera blocks.
    Hc_o = jnp.einsum("poki,po,pokj->poij", J_c, w, J_c)  # [P, O, 6, 6]
    W = jnp.einsum("poki,po,pokj->poij", J_c, w, J_p)  # [P, O, 6, 3]
    b_co = jnp.einsum("poki,po,pok->poi", J_c, w, r)  # [P, O, 6]
    Y = jnp.einsum("poij,pjk->poik", W, H_pp_inv)  # [P, O, 6, 3]

    # Reduced camera system S [C, C, 6, 6], b_red [C, 6], assembled with
    # one-hot contractions (matrix products). The index-based alternative —
    # a scatter-add of [P, O, O] 6x6 pair blocks — serializes on duplicate
    # camera indices; on the accelerator the system was first built on it
    # dominated the whole BA. Which form wins on an NVIDIA GPU is not
    # measured.
    E = jax.nn.one_hot(prob.obs_cam, C, dtype=cam_T.dtype)  # [P, O, C]
    # Diagonal contributions Σ_po E Hc_o.
    S_diag = jnp.einsum("poc,poij->cij", E, Hc_o)  # [C, 6, 6]
    # Cross terms -Σ_p (Σ_o E Y)(Σ_q E W)^T over the shared landmark index.
    A = jnp.einsum("poc,poik->pcik", E, Y)  # [P, C, 6, 3]
    B = jnp.einsum("poc,pojk->pcjk", E, W)  # [P, C, 6, 3]
    S = -jnp.einsum("pcik,pdjk->cdij", A, B)  # [C, C, 6, 6]
    S = S.at[jnp.arange(C), jnp.arange(C)].add(S_diag)

    b_c = jnp.einsum("poc,poi->ci", E, b_co)  # [C, 6]
    corr = jnp.einsum("poc,poij,pj->ci", E, Y, b_p)
    b_red = b_c - corr
    return S, b_red, H_pp_inv, W, b_p


def solve_cameras(S, b_red, cam_fixed, lam):
    """Damp, project out fixed cameras, and densely solve the reduced
    system. Returns delta_c [C, 6]."""
    C = S.shape[0]
    # Damping on camera diagonal blocks.
    diag = S[jnp.arange(C), jnp.arange(C)]  # [C, 6, 6]
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        lam * jnp.eye(6) * jnp.maximum(
            jnp.trace(diag, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
        )
    )

    # Project out fixed cameras: zero rows/cols, identity diagonal.
    free = ~cam_fixed
    mask2 = free[:, None] & free[None, :]
    S = jnp.where(mask2[:, :, None, None], S, 0.0)
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        jnp.where(free[:, None, None], 0.0, jnp.eye(6))
    )
    b_red = jnp.where(free[:, None], b_red, 0.0)

    # Dense solve of the reduced system.
    S_full = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    delta_c = -jnp.linalg.solve(
        S_full + 1e-9 * jnp.eye(C * 6, dtype=S_full.dtype), b_red.reshape(-1)
    ).reshape(C, 6)
    return jnp.where(free[:, None], delta_c, 0.0)


def backsub_points(prob: BAProblem, delta_c, H_pp_inv, W, b_p):
    """Back-substitute landmark updates: H_pp dp = -(b_p + sum_o W^T dc)."""
    dc_per_obs = delta_c[prob.obs_cam]  # [P, O, 6]
    wtd = jnp.einsum("poij,poi->pj", W, dc_per_obs)  # [P, 3]
    delta_p = -jnp.einsum("pij,pj->pi", H_pp_inv, b_p + wtd)
    return jnp.where(prob.point_valid[:, None], delta_p, 0.0)


def _schur_step(prob: BAProblem, cam_T, points, active, lam):
    """One damped GN step via Schur complement. Returns (new cam_T, new points)."""
    S, b_red, H_pp_inv, W, b_p = assemble_reduced(prob, cam_T, points, active, lam)
    delta_c = solve_cameras(S, b_red, prob.cam_fixed, lam)
    delta_p = backsub_points(prob, delta_c, H_pp_inv, W, b_p)
    cam_T_new = se3.exp_batch(delta_c) @ cam_T
    points_new = points + delta_p
    return cam_T_new, points_new


def classify_obs(prob: BAProblem, cam_T, points, chi2_th: float = CHI2_MONO):
    """Final inlier classification: chi2 gate + positive depth, mirroring the
    reference's post-BA outlier erase (Optimizer.cc:520-556)."""
    Tcw = cam_T[prob.obs_cam]
    X = jnp.broadcast_to(points[:, None, :], prob.obs_uv.shape[:2] + (3,))
    pc, uv = rp.project_point(Tcw, X, prob.intr)
    r = uv - prob.obs_uv
    chi2 = jnp.sum(r * r, axis=-1) / jnp.clip(prob.obs_sigma2, 1e-8, None)
    return prob.obs_valid & (chi2 <= chi2_th) & (pc[..., 2] > 0)


class BAState(NamedTuple):
    """Resumable LM state: run a few iterations, check the host abort flag,
    continue — the device-side form of g2o's force-stop preemption
    (``mbAbortBA`` set by keyframe insertion, LocalMapping.cc:116;
    ``setForceStopFlag`` Optimizer.cc:65-66). Partial results are valid at
    every chunk boundary, exactly as g2o's in-place vertex updates are."""

    cam_T: jnp.ndarray
    points: jnp.ndarray
    active: jnp.ndarray  # [P, O] observations currently in the problem
    lam: jnp.ndarray
    cost: jnp.ndarray


def ba_begin(prob: BAProblem, lam0: float = 1e-4) -> BAState:
    return BAState(
        cam_T=prob.cam_T,
        points=prob.points,
        active=prob.obs_valid,
        lam=jnp.float32(lam0),
        cost=_cost_only(prob, prob.cam_T, prob.points, prob.obs_valid),
    )


def ba_iterate(prob: BAProblem, state: BAState, n: int) -> BAState:
    """n damped-LM iterations with branchless accept/reject."""

    def body(_, s):
        cam_T, points, lam, cost = s
        cand_T, cand_p = _schur_step(prob, cam_T, points, state.active, lam)
        new_cost = _cost_only(prob, cand_T, cand_p, state.active)
        ok = new_cost < cost
        cam_T = jnp.where(ok, cand_T, cam_T)
        points = jnp.where(ok, cand_p, points)
        lam = jnp.where(ok, lam * 0.5, lam * 4.0)
        return cam_T, points, lam, jnp.where(ok, new_cost, cost)

    cam_T, points, lam, cost = jax.lax.fori_loop(
        0, n, body, (state.cam_T, state.points, state.lam, state.cost)
    )
    return BAState(cam_T=cam_T, points=points, active=state.active, lam=lam, cost=cost)


def ba_reclassify(prob: BAProblem, state: BAState, lam0: float = 1e-4) -> BAState:
    """Drop chi2/depth outliers from the active set and reset damping — the
    boundary between the reference's 5- and 10-iteration local-BA phases
    (Optimizer.cc:466-510)."""
    active = classify_obs(prob, state.cam_T, state.points)
    return BAState(
        cam_T=state.cam_T,
        points=state.points,
        active=active,
        lam=jnp.float32(lam0),
        cost=_cost_only(prob, state.cam_T, state.points, active),
    )


def ba_result(prob: BAProblem, state: BAState) -> BAResult:
    inlier = classify_obs(prob, state.cam_T, state.points)
    return BAResult(
        cam_T=state.cam_T, points=state.points, obs_inlier=inlier, cost=state.cost
    )


def run_ba(
    prob: BAProblem,
    iters: int = 5,
    reclassify_and_continue: int = 0,
    lam0: float = 1e-4,
) -> BAResult:
    """LM bundle adjustment (single-dispatch convenience wrapper).

    iters: first-phase iterations over all valid observations.
    reclassify_and_continue: if > 0, after the first phase observations with
    chi2 > 5.991 are dropped and this many further iterations run — the
    reference's 5+10 LocalBundleAdjustment schedule (Optimizer.cc:466-510).

    For the preemptible (abortable) form, drive ba_begin / ba_iterate /
    ba_reclassify / ba_result yourself in host-checked chunks.
    """
    state = ba_begin(prob, lam0)
    state = ba_iterate(prob, state, iters)
    if reclassify_and_continue > 0:
        state = ba_reclassify(prob, state, lam0)
        state = ba_iterate(prob, state, reclassify_and_continue)
    return ba_result(prob, state)
