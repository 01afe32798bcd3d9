"""Distributed Schur-complement bundle adjustment over a device mesh.

The scaling design of BASELINE.json configs 4-5: landmarks are sharded
across devices along the point axis; each device marginalizes its own
landmark blocks locally (the embarrassingly parallel part of Schur BA), the
reduced camera system — tiny compared to the landmark system: (6C)^2 vs 3P
— is summed with one psum (an all-reduce over NVLink between the cards of
one host), solved redundantly on every device, and the camera update is
broadcast back implicitly (every device already has it).
Landmark back-substitution again touches only local shards.

Communication per LM iteration: one psum of [C, C, 6, 6] + [C, 6] + two
scalars — independent of the number of points. This is the device-mesh
re-expression of what the reference cannot do at all (g2o is strictly
single-threaded shared-memory; SURVEY.md §2.3).

Works on any jax.sharding.Mesh: the GPUs of one host, joined all to all by
NVLink (so a 1-D mesh follows the algorithm alone), or the virtual CPU host
mesh used by the tests and the multi-device dry run.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import se3
from ..optim import ba_core
from ..optim.ba_core import BAProblem

AXIS = "points"


def shard_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """Place point-axis arrays across the mesh, replicate camera arrays."""
    pt = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    return BAProblem(
        cam_T=jax.device_put(prob.cam_T, rep),
        cam_fixed=jax.device_put(prob.cam_fixed, rep),
        points=jax.device_put(prob.points, pt),
        point_valid=jax.device_put(prob.point_valid, pt),
        obs_cam=jax.device_put(prob.obs_cam, pt),
        obs_uv=jax.device_put(prob.obs_uv, pt),
        obs_sigma2=jax.device_put(prob.obs_sigma2, pt),
        obs_valid=jax.device_put(prob.obs_valid, pt),
        intr=jax.device_put(prob.intr, rep),
    )


def _local_cost(prob, cam_T, points, active):
    local = ba_core._cost_only(prob, cam_T, points, active)
    return jax.lax.psum(local, AXIS)


def make_distributed_ba(mesh: Mesh, iters: int = 10, lam0: float = 1e-4):
    """Build a jitted distributed BA runner over the given mesh.

    Returns a function prob -> (cam_T, points, cost) with points/obs sharded
    along AXIS and cameras replicated.
    """
    pt = P(AXIS)
    rep = P()
    prob_specs = BAProblem(
        cam_T=rep, cam_fixed=rep,
        points=pt, point_valid=pt,
        obs_cam=pt, obs_uv=pt, obs_sigma2=pt, obs_valid=pt,
        intr=rep,
    )

    def step(prob: BAProblem):
        def body(_, state):
            cam_T, points, lam, cost = state
            S, b_red, H_pp_inv, W, b_p = ba_core.assemble_reduced(
                prob, cam_T, points, prob.obs_valid, lam
            )
            # The one collective: reduce the camera system over point shards.
            S = jax.lax.psum(S, AXIS)
            b_red = jax.lax.psum(b_red, AXIS)
            delta_c = ba_core.solve_cameras(S, b_red, prob.cam_fixed, lam)
            delta_p = ba_core.backsub_points(prob, delta_c, H_pp_inv, W, b_p)
            cand_T = se3.exp_batch(delta_c) @ cam_T
            cand_p = points + delta_p
            new_cost = _local_cost(prob, cand_T, cand_p, prob.obs_valid)
            ok = new_cost < cost
            cam_T = jnp.where(ok, cand_T, cam_T)
            points = jnp.where(ok, cand_p, points)
            lam = jnp.where(ok, lam * 0.5, lam * 4.0)
            return cam_T, points, lam, jnp.where(ok, new_cost, cost)

        cost0 = _local_cost(prob, prob.cam_T, prob.points, prob.obs_valid)
        cam_T, points, lam, cost = jax.lax.fori_loop(
            0, iters, body, (prob.cam_T, prob.points, jnp.float32(lam0), cost0)
        )
        return cam_T, points, cost

    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(prob_specs,),
        out_specs=(rep, pt, rep),
        check_vma=False,
    )
    return jax.jit(sharded)


def distributed_ba(prob: BAProblem, mesh: Mesh, iters: int = 10, lam0: float = 1e-4):
    """Convenience wrapper: shard, run, return (cam_T, points, cost)."""
    runner = make_distributed_ba(mesh, iters=iters, lam0=lam0)
    return runner(shard_problem(prob, mesh))
