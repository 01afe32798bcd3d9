"""Distributed Sim3 pose-graph (essential graph) optimization over a mesh.

Edges are sharded across devices; each device assembles the dense normal
equations H [K,K,7,7] / b [K,7] for its own edge shard (vmapped autodiff
Jacobians, scatter-added blocks), the systems are summed with one psum per
LM iteration, and the tiny [7K, 7K] solve runs replicated on every device. Communication per iteration is O(K^2) — independent of the edge count,
which is what grows with trajectory length (covisibility edges, minFeat=100,
reference Optimizer.cc:591-863).

This is the pose-graph analogue of parallel/dist_ba.py (points sharded,
reduced camera system psum'd) and together they cover both loop-closing
back-end solves of BASELINE.json configs 4-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import sim3
from ..optim.pose_graph import _edge_residual

AXIS = "edges"


def _assemble(S_cur, edge_i, edge_j, edge_S, edge_valid):
    """Dense H/b for THIS shard's edges (same math as the single-device
    optimize_pose_graph build_system, pose_graph.py:44-85). Damping and
    gauge-fixing are applied by the caller AFTER the psum."""
    K = S_cur.shape[0]
    zero14 = jnp.zeros(14)

    def edge_terms(i, j, Sm, ok):
        def f(xi):
            return _edge_residual(xi[:7], xi[7:], S_cur[i], S_cur[j], Sm)

        r = f(zero14)
        J = jax.jacfwd(f)(zero14)
        w = ok.astype(S_cur.dtype)
        return r * w, J * w

    r, J = jax.vmap(edge_terms)(edge_i, edge_j, edge_S, edge_valid)
    Ji, Jj = J[:, :, :7], J[:, :, 7:]
    H = jnp.zeros((K * K, 7, 7), S_cur.dtype)
    b = jnp.zeros((K, 7), S_cur.dtype)
    H = H.at[edge_i * K + edge_i].add(jnp.einsum("eki,ekj->eij", Ji, Ji))
    H = H.at[edge_j * K + edge_j].add(jnp.einsum("eki,ekj->eij", Jj, Jj))
    Hij = jnp.einsum("eki,ekj->eij", Ji, Jj)
    H = H.at[edge_i * K + edge_j].add(Hij)
    H = H.at[edge_j * K + edge_i].add(jnp.swapaxes(Hij, -1, -2))
    b = b.at[edge_i].add(jnp.einsum("eki,ek->ei", Ji, r))
    b = b.at[edge_j].add(jnp.einsum("eki,ek->ei", Jj, r))
    cost = jnp.sum(r * r)
    return H.reshape(K, K, 7, 7), b, cost


def _shard_cost(S_cur, edge_i, edge_j, edge_S, edge_valid):
    def one(i, j, Sm, ok):
        r = _edge_residual(
            jnp.zeros(7), jnp.zeros(7), S_cur[i], S_cur[j], Sm
        )
        return jnp.sum(r * r) * ok.astype(S_cur.dtype)

    return jnp.sum(jax.vmap(one)(edge_i, edge_j, edge_S, edge_valid))


_RUNNER_CACHE: dict = {}


def make_distributed_pose_graph(mesh: Mesh, iters: int = 15, lam0: float = 1e-4):
    """Build a jitted edge-sharded pose-graph runner.

    Returns fn(S [K,4,4], kf_valid, fixed, edge_i, edge_j, edge_S,
    edge_valid) -> S_out with edge arrays sharded along AXIS and keyframe
    state replicated. Edge count must be divisible by the mesh size (pad
    with edge_valid=False slots).
    """
    # Memoized per (mesh, iters, lam0): each closure owns a fresh jit cache,
    # so rebuilding one per call would recompile the whole program (seconds)
    # every loop closure.
    key = (tuple(mesh.devices.flat), mesh.axis_names, iters, lam0)
    cached = _RUNNER_CACHE.get(key)
    if cached is not None:
        return cached

    ed = P(AXIS)
    rep = P()

    def step(S0, kf_valid, fixed, edge_i, edge_j, edge_S, edge_valid):
        K = S0.shape[0]
        free = kf_valid & ~fixed

        def body(_, state):
            S_cur, lam, cost = state
            H, b, _ = _assemble(S_cur, edge_i, edge_j, edge_S, edge_valid)
            # The one collective per iteration.
            H = jax.lax.psum(H, AXIS)
            b = jax.lax.psum(b, AXIS)
            diag = H[jnp.arange(K), jnp.arange(K)]
            H = H.at[jnp.arange(K), jnp.arange(K)].add(
                lam * jnp.eye(7) * jnp.maximum(
                    jnp.trace(diag, axis1=-2, axis2=-1)[:, None, None] / 7.0,
                    1e-6,
                )
            )
            mask2 = free[:, None] & free[None, :]
            H = jnp.where(mask2[:, :, None, None], H, 0.0)
            H = H.at[jnp.arange(K), jnp.arange(K)].add(
                jnp.where(free[:, None, None], 0.0, jnp.eye(7))
            )
            b = jnp.where(free[:, None], b, 0.0)
            Hf = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
            delta = -jnp.linalg.solve(
                Hf + 1e-9 * jnp.eye(K * 7), b.reshape(-1)
            ).reshape(K, 7)
            delta = jnp.where(free[:, None], delta, 0.0)
            S_new = sim3.exp_batch(delta) @ S_cur
            new_cost = jax.lax.psum(
                _shard_cost(S_new, edge_i, edge_j, edge_S, edge_valid), AXIS
            )
            ok = new_cost < cost
            S_cur = jnp.where(ok, S_new, S_cur)
            lam = jnp.where(ok, lam * 0.5, lam * 4.0)
            return S_cur, lam, jnp.where(ok, new_cost, cost)

        cost0 = jax.lax.psum(
            _shard_cost(S0, edge_i, edge_j, edge_S, edge_valid), AXIS
        )
        S_out, _, _ = jax.lax.fori_loop(
            0, iters, body, (S0, jnp.float32(lam0), cost0)
        )
        return S_out

    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(rep, rep, rep, ed, ed, ed, ed),
        out_specs=rep,
        check_vma=False,
    )
    runner = jax.jit(sharded)
    _RUNNER_CACHE[key] = runner
    return runner


def distributed_pose_graph(
    S, kf_valid, fixed, edge_i, edge_j, edge_S, edge_valid,
    mesh: Mesh, iters: int = 15, lam0: float = 1e-4,
):
    """Convenience wrapper: shard edge arrays, run, return S_out [K,4,4]."""
    ed = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    n = mesh.devices.size
    E = edge_i.shape[0]
    pad = (-E) % n
    if pad:
        edge_i = jnp.concatenate([edge_i, jnp.zeros(pad, edge_i.dtype)])
        edge_j = jnp.concatenate([edge_j, jnp.zeros(pad, edge_j.dtype)])
        edge_S = jnp.concatenate(
            [edge_S, jnp.broadcast_to(jnp.eye(4, dtype=edge_S.dtype), (pad, 4, 4))]
        )
        edge_valid = jnp.concatenate([edge_valid, jnp.zeros(pad, bool)])
    args = (
        jax.device_put(S, rep),
        jax.device_put(kf_valid, rep),
        jax.device_put(fixed, rep),
        jax.device_put(edge_i, ed),
        jax.device_put(edge_j, ed),
        jax.device_put(edge_S, ed),
        jax.device_put(edge_valid, ed),
    )
    return make_distributed_pose_graph(mesh, iters=iters, lam0=lam0)(*args)
