"""Motion-only pose optimization: batched Levenberg-Marquardt on one SE3
pose with fixed map points.

Replaces Optimizer::PoseOptimization (reference Optimizer.cc:206-338): the
g2o dense-solver graph with per-point EdgeSE3ProjectXYZOnlyPose edges becomes
a [N]-wide residual map reduced to a 6x6 normal system on-device. The
reference's 4 rounds x 10 iterations with chi2=5.991 inlier reclassification
between rounds (Optimizer.cc:284-329) is preserved: after each round,
observations with chi2 > 5.991 are excluded (and can re-enter later rounds,
exactly like the reference's outlier re-inclusion).

Fully jittable: rounds/iters are lax.fori_loop, accept/reject is branchless.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import reprojection as rp

CHI2_MONO = 5.991


class PoseOptResult(NamedTuple):
    Tcw: jnp.ndarray  # [4, 4] optimized pose
    inlier: jnp.ndarray  # [N] bool final inlier classification
    n_inliers: jnp.ndarray  # int32
    chi2: jnp.ndarray  # final robust total chi2


def _normal_system(Tcw, X, uv, intr, sigma2, active):
    """Accumulate the 6x6 GN system over active observations with Huber IRLS
    (delta matches the reference's deltaMono sqrt(5.991))."""
    r = rp.residual(Tcw, X, uv, intr)  # [N, 2]
    J_pose, _ = rp.jacobians(Tcw, X, intr)  # [N, 2, 6]
    # Inactive lanes may hold garbage points (behind camera, z ~ 0) whose
    # residuals/Jacobians overflow; zero them BEFORE any product so that
    # 0 * inf never produces NaN.
    r = jnp.where(active[:, None], r, 0.0)
    J_pose = jnp.where(active[:, None, None], J_pose, 0.0)
    inv_s2 = 1.0 / jnp.clip(sigma2, 1e-8, None)
    chi2 = jnp.sum(r * r, axis=-1) * inv_s2
    w = rp.huber_weight(chi2, rp.HUBER_MONO) * inv_s2
    w = jnp.where(active, w, 0.0)
    H = jnp.einsum("nki,n,nkj->ij", J_pose, w, J_pose)
    b = jnp.einsum("nki,n,nk->i", J_pose, w, r)
    # Robust total cost (rho(chi2) for Huber).
    d2 = rp.HUBER_MONO**2
    rho = jnp.where(chi2 <= d2, chi2, 2.0 * jnp.sqrt(chi2 * d2) - d2)
    cost = jnp.sum(jnp.where(active, rho, 0.0))
    return H, b, cost, chi2


def optimize_pose(
    Tcw0: jnp.ndarray,
    points: jnp.ndarray,
    uv: jnp.ndarray,
    sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    intr: jnp.ndarray,
    rounds: int = 4,
    iters_per_round: int = 10,
    accept_reject: bool = True,
) -> PoseOptResult:
    """Pose-only solve.

    points: [N, 3] world positions of matched map points; uv: [N, 2]
    undistorted pixel measurements; sigma2: [N] per-octave squared scale;
    valid: [N] match mask; intr: [4] (fx, fy, cx, cy).

    accept_reject=True is classic LM (two cost evaluations per iteration,
    branchless step rejection — matches g2o's behavior). accept_reject=False
    is damped Gauss-Newton: ONE normal-system evaluation per iteration and
    every step taken. The solve is a latency-bound sequential chain of tiny
    ops, so halving evaluations halves wall time; with a motion-model
    initialization and Huber IRLS the GN steps are reliably descent steps,
    and the per-round chi2 reclassification discards any observation a bad
    step would have misclassified. The hot fused tracker uses GN with fewer
    iterations (tracking_kernels.py); cold paths (relocalization) keep LM.
    """

    def lm_round(round_state):
        Tcw, inlier, _ = round_state
        lam0 = jnp.float32(1e-3)

        def lm_iter(_, s):
            Tcw, lam, cost_prev = s
            H, b, cost, _ = _normal_system(Tcw, points, uv, intr, sigma2, inlier)
            Hd = H + lam * jnp.diag(jnp.diag(H))
            delta = -jnp.linalg.solve(
                Hd + 1e-10 * jnp.eye(6, dtype=H.dtype), b
            )
            T_new = se3.exp(delta) @ Tcw
            if not accept_reject:
                return T_new, lam, cost
            _, _, cost_new, _ = _normal_system(
                T_new, points, uv, intr, sigma2, inlier
            )
            improved = cost_new < cost
            Tcw = jnp.where(improved, T_new, Tcw)
            lam = jnp.where(improved, lam * 0.5, lam * 4.0)
            return Tcw, lam, jnp.where(improved, cost_new, cost)

        Tcw, _, cost = jax.lax.fori_loop(
            0, iters_per_round, lm_iter, (Tcw, lam0, jnp.float32(jnp.inf))
        )
        # Reclassify: recompute chi2 for ALL valid obs (outliers may return).
        _, _, _, chi2 = _normal_system(Tcw, points, uv, intr, sigma2, valid)
        inlier = valid & (chi2 <= CHI2_MONO)
        return Tcw, inlier, cost

    state = (Tcw0, valid, jnp.float32(jnp.inf))
    for _ in range(rounds):  # static unroll: reclassification between rounds
        state = lm_round(state)
    Tcw, inlier, cost = state
    return PoseOptResult(
        Tcw=Tcw,
        inlier=inlier,
        n_inliers=jnp.sum(inlier).astype(jnp.int32),
        chi2=cost,
    )
