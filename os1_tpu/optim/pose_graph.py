"""Sim3 pose-graph (essential graph) optimization — the loop-closing
backbone (reference Optimizer::OptimizeEssentialGraph, Optimizer.cc:591-863:
BlockSolver_7_3 over spanning-tree + strong-covisibility (minFeat=100) +
loop edges).

Graph residual for edge (i, j) with measurement S_ji (relative Sim3 at
measurement time): e = log_sim3(S_ji . S_i . S_j^-1) — zero when the
current poses reproduce the measured relative transform. Left-multiplicative
updates, autodiff edge Jacobians (vmapped jacfwd over the edge batch),
dense [7K, 7K] normal equations — for the few-hundred-keyframe graphs the
essential graph produces, one dense batched solve beats sparse bookkeeping.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..geometry import sim3


def _edge_residual(xi_i, xi_j, S_i, S_j, S_meas_ji):
    Si = sim3.exp(xi_i) @ S_i
    Sj = sim3.exp(xi_j) @ S_j
    return sim3.log(S_meas_ji @ Si @ sim3.inverse(Sj))  # [7]


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    S: jnp.ndarray,  # [K, 4, 4] Sim3 world->camera per keyframe
    kf_valid: jnp.ndarray,  # [K]
    fixed: jnp.ndarray,  # [K] bool (the loop keyframe anchors the gauge)
    edge_i: jnp.ndarray,  # [E] int32
    edge_j: jnp.ndarray,  # [E]
    edge_S: jnp.ndarray,  # [E, 4, 4] measured S_ji = S_j @ S_i^-1
    edge_valid: jnp.ndarray,  # [E]
    iters: int = 15,
    lam0: float = 1e-4,
) -> jnp.ndarray:
    K = S.shape[0]
    zero14 = jnp.zeros(14)

    def build_system(S_cur_val, lam):
        def edge_terms(i, j, Sm, ok):
            def f(xi):
                return _edge_residual(xi[:7], xi[7:], S_cur_val[i], S_cur_val[j], Sm)

            r = f(zero14)
            J = jax.jacfwd(f)(zero14)
            w = ok.astype(S.dtype)
            return r * w, J * w

        r, J = jax.vmap(edge_terms)(edge_i, edge_j, edge_S, edge_valid)  # [E,7],[E,7,14]
        Ji = J[:, :, :7]
        Jj = J[:, :, 7:]
        # Assemble dense block system.
        H = jnp.zeros((K * K, 7, 7), S.dtype)
        b = jnp.zeros((K, 7), S.dtype)
        Hii = jnp.einsum("eki,ekj->eij", Ji, Ji)
        Hjj = jnp.einsum("eki,ekj->eij", Jj, Jj)
        Hij = jnp.einsum("eki,ekj->eij", Ji, Jj)
        H = H.at[edge_i * K + edge_i].add(Hii)
        H = H.at[edge_j * K + edge_j].add(Hjj)
        H = H.at[edge_i * K + edge_j].add(Hij)
        H = H.at[edge_j * K + edge_i].add(jnp.swapaxes(Hij, -1, -2))
        b = b.at[edge_i].add(jnp.einsum("eki,ek->ei", Ji, r))
        b = b.at[edge_j].add(jnp.einsum("eki,ek->ei", Jj, r))
        H = H.reshape(K, K, 7, 7)
        # Damping + gauge.
        diag = H[jnp.arange(K), jnp.arange(K)]
        H = H.at[jnp.arange(K), jnp.arange(K)].add(
            lam * jnp.eye(7) * jnp.maximum(
                jnp.trace(diag, axis1=-2, axis2=-1)[:, None, None] / 7.0, 1e-6
            )
        )
        free = kf_valid & ~fixed
        mask2 = free[:, None] & free[None, :]
        H = jnp.where(mask2[:, :, None, None], H, 0.0)
        H = H.at[jnp.arange(K), jnp.arange(K)].add(
            jnp.where(free[:, None, None], 0.0, jnp.eye(7))
        )
        b = jnp.where(free[:, None], b, 0.0)
        cost = jnp.sum(r * r)
        return H, b, cost, free

    def total_cost(S_cur_val):
        def one(i, j, Sm, ok):
            r = _edge_residual(jnp.zeros(7), jnp.zeros(7), S_cur_val[i], S_cur_val[j], Sm)
            return jnp.sum(r * r) * ok.astype(S.dtype)

        return jnp.sum(jax.vmap(one)(edge_i, edge_j, edge_S, edge_valid))

    def body(_, state):
        S_cur_val, lam, cost = state
        H, b, _, free = build_system(S_cur_val, lam)
        Hf = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
        delta = -jnp.linalg.solve(Hf + 1e-9 * jnp.eye(K * 7), b.reshape(-1)).reshape(K, 7)
        delta = jnp.where(free[:, None], delta, 0.0)
        S_new = sim3.exp_batch(delta) @ S_cur_val
        new_cost = total_cost(S_new)
        ok = new_cost < cost
        S_cur_val = jnp.where(ok, S_new, S_cur_val)
        lam = jnp.where(ok, lam * 0.5, lam * 4.0)
        return S_cur_val, lam, jnp.where(ok, new_cost, cost)

    S_cur = S
    cost0 = total_cost(S_cur)
    S_out, _, _ = jax.lax.fori_loop(0, iters, body, (S_cur, jnp.float32(lam0), cost0))
    return S_out
