"""Mesh solver backend: the live pipeline's BA protocol, sharded.

`optim.ba_core` drives every bundle adjustment through the resumable
ba_begin / ba_iterate / ba_reclassify / ba_result protocol (host-checked
chunks for mbAbortBA preemption). This module provides the SAME protocol
with landmarks sharded across a `jax.sharding.Mesh` — one psum of the
reduced camera system per LM iteration (see dist_ba.py for the scaling
design) — so LocalMapper's local BA and LoopCloser's global BA route
through the mesh without changing their orchestration (BASELINE.json
configs 4-5: the distributed back-end serving the live pipeline, not a
standalone solver).

Semantics match the single-device protocol: same LM schedule, same
accept/reject, same chi2 reclassification. With the same inputs the
sharded run matches single-device to float tolerance (test_parallel).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..optim import ba_core
from ..optim.ba_core import BAProblem, BAState

AXIS = "points"

_PROB_PT_FIELDS = (
    "points", "point_valid", "obs_cam", "obs_uv", "obs_sigma2", "obs_valid",
)


def _prob_specs(pt):
    rep = P()
    return BAProblem(
        cam_T=rep, cam_fixed=rep, points=pt, point_valid=pt,
        obs_cam=pt, obs_uv=pt, obs_sigma2=pt, obs_valid=pt, intr=rep,
    )


def _state_specs(pt):
    rep = P()
    return BAState(cam_T=rep, points=pt, active=pt, lam=rep, cost=rep)


class MeshBABackend:
    """Drop-in replacement for the (jitted) ba_* protocol on a device mesh.

    Usage: backend = MeshBABackend(mesh); then begin/iterate/reclassify/
    result mirror optim.ba_core. Point counts must divide the mesh size
    (callers' bucketed shapes are powers of two, the mesh is 2^k devices).

    The mesh may be 1D ("points": the cards of one host, config 4) or 2D
    ("dcn", "ici": hosts x cards per host, config 5) — landmarks shard over
    ALL axes and the per-iteration psum of the reduced camera system
    contracts over ("ici", "dcn") in that order, so XLA reduces within each
    host first (NVLink, all to all) and crosses the network between hosts
    only with the already-reduced [C,C,6,6] block — the hierarchical
    all-reduce multi-host Schur BA wants (dist_ba.py design note). The axis
    names: "ici" (inter-chip link) is the in-host axis and "dcn"
    (data-centre network) the cross-host one.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        axes = tuple(mesh.axis_names)
        # Reduction order: innermost (in-host, last axis) first.
        red = tuple(reversed(axes))
        pt = P(axes)
        rep = P()

        def d_cost(prob, cam_T, points, active):
            return jax.lax.psum(
                ba_core._cost_only(prob, cam_T, points, active), red
            )

        def d_begin(prob):
            return BAState(
                cam_T=prob.cam_T, points=prob.points, active=prob.obs_valid,
                lam=jnp.float32(1e-4),
                cost=d_cost(prob, prob.cam_T, prob.points, prob.obs_valid),
            )

        def d_iterate(prob, state, n):
            def body(_, s):
                cam_T, points, lam, cost = s
                S, b_red, H_pp_inv, W, b_p = ba_core.assemble_reduced(
                    prob, cam_T, points, state.active, lam
                )
                # The one collective per LM iteration (in-host first when 2D).
                S = jax.lax.psum(S, red)
                b_red = jax.lax.psum(b_red, red)
                delta_c = ba_core.solve_cameras(S, b_red, prob.cam_fixed, lam)
                delta_p = ba_core.backsub_points(prob, delta_c, H_pp_inv, W, b_p)
                from ..geometry import se3

                cand_T = se3.exp_batch(delta_c) @ cam_T
                cand_p = points + delta_p
                new_cost = d_cost(prob, cand_T, cand_p, state.active)
                ok = new_cost < cost
                cam_T = jnp.where(ok, cand_T, cam_T)
                points = jnp.where(ok, cand_p, points)
                lam = jnp.where(ok, lam * 0.5, lam * 4.0)
                return cam_T, points, lam, jnp.where(ok, new_cost, cost)

            cam_T, points, lam, cost = jax.lax.fori_loop(
                0, n, body, (state.cam_T, state.points, state.lam, state.cost)
            )
            return BAState(cam_T=cam_T, points=points, active=state.active,
                           lam=lam, cost=cost)

        def d_reclassify(prob, state):
            active = ba_core.classify_obs(prob, state.cam_T, state.points)
            return BAState(
                cam_T=state.cam_T, points=state.points, active=active,
                lam=jnp.float32(1e-4),
                cost=d_cost(prob, state.cam_T, state.points, active),
            )

        def d_result(prob, state):
            inlier = ba_core.classify_obs(prob, state.cam_T, state.points)
            return ba_core.BAResult(
                cam_T=state.cam_T, points=state.points, obs_inlier=inlier,
                cost=state.cost,
            )

        ps, ss = _prob_specs(pt), _state_specs(pt)
        res_spec = ba_core.BAResult(cam_T=rep, points=pt, obs_inlier=pt, cost=rep)
        self._begin = jax.jit(jax.shard_map(
            d_begin, mesh=mesh, in_specs=(ps,), out_specs=ss, check_vma=False
        ))
        self._iterate = {}  # n -> compiled runner
        self._mk_iterate = lambda n: jax.jit(jax.shard_map(
            lambda prob, state: d_iterate(prob, state, n),
            mesh=mesh, in_specs=(ps, ss), out_specs=ss, check_vma=False,
        ))
        self._reclassify = jax.jit(jax.shard_map(
            d_reclassify, mesh=mesh, in_specs=(ps, ss), out_specs=ss,
            check_vma=False,
        ))
        self._result = jax.jit(jax.shard_map(
            d_result, mesh=mesh, in_specs=(ps, ss), out_specs=res_spec,
            check_vma=False,
        ))

    # ------------------------------------------------------------------ #
    def shard(self, prob: BAProblem) -> BAProblem:
        """Place point-axis arrays across the mesh, replicate the rest."""
        pt = NamedSharding(self.mesh, P(tuple(self.mesh.axis_names)))
        rep = NamedSharding(self.mesh, P())
        specs = _prob_specs(pt)._replace(
            cam_T=rep, cam_fixed=rep, intr=rep
        )
        return jax.tree.map(jax.device_put, prob, specs)

    def begin(self, prob: BAProblem) -> BAState:
        return self._begin(prob)

    def iterate(self, prob: BAProblem, state: BAState, n: int) -> BAState:
        fn = self._iterate.get(n)
        if fn is None:
            fn = self._iterate[n] = self._mk_iterate(n)
        return fn(prob, state)

    def reclassify(self, prob: BAProblem, state: BAState) -> BAState:
        return self._reclassify(prob, state)

    def result(self, prob: BAProblem, state: BAState):
        return self._result(prob, state)


def two_level_backend(n_hosts: int, devices=None) -> "MeshBABackend":
    """A ("dcn", "ici") 2D-mesh backend simulating (or spanning) n_hosts
    hosts: devices reshape to [n_hosts, per_host] and landmarks shard over
    both axes. On a real multi-host cluster the outer axis crosses the
    network between hosts and the inner one NVLink within a host; under the
    CPU virtual mesh it validates the hierarchical program (config 5's
    two-process story compiles and matches single-device)."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    assert len(devs) % n_hosts == 0, (len(devs), n_hosts)
    mesh = Mesh(devs.reshape(n_hosts, -1), ("dcn", "ici"))
    return MeshBABackend(mesh)


_BACKEND_CACHE: dict = {}


def default_mesh_backend() -> "MeshBABackend | None":
    """A MeshBABackend over ALL local devices when more than one exists
    (config 4: the whole map's landmarks sharded over the slice); None on a
    single chip. Memoized."""
    devs = jax.devices()
    if len(devs) < 2:
        return None
    key = tuple(d.id for d in devs)
    be = _BACKEND_CACHE.get(key)
    if be is None:
        mesh = Mesh(np.array(devs), (AXIS,))
        be = _BACKEND_CACHE[key] = MeshBABackend(mesh)
    return be
