"""Hierarchical BoW vocabulary: batched tree descent + dense scoring.

Replaces DBoW2's TemplatedVocabulary (reference Thirdparty/DBoW2, ~1.9k LoC
of pointer-tree traversal per descriptor) with a flat-array tree and a
vmapped descent: all N descriptors walk the tree together, each level being
one gather + one popcount-distance + one argmin — elementwise work.

BoW vectors are kept DENSE ([W] float32, L1-normalized): with W ~ 10^4 and
hundreds of keyframes the whole database is a few MB, and similarity
queries against every keyframe become one broadcast |v - V| reduction on
the device instead of DBoW2's inverted-file walk (KeyFrameDatabase.cc:74).
Scoring matches DBoW2's L1 norm: s(v, w) = 1 - 0.5 * ||v - w||_1 in [0, 1].
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import hamming


class Vocabulary(NamedTuple):
    """Flat general-tree vocabulary (supports both trained and DBoW2-loaded
    trees; node 0 is the root and has no descriptor).

    Arrays are HOST numpy: the per-keyframe tree descent runs natively on
    the host (native/os1native.cpp bow_transform — the reference computes
    BoW on the CPU too, KeyFrame::ComputeBoW); jitted device fallbacks
    accept numpy operands and convert at dispatch."""

    node_desc: "np.ndarray"  # [n_nodes, 8] uint32
    node_children: "np.ndarray"  # [n_nodes, kb] int32, -1 padded
    node_weight: "np.ndarray"  # [n_nodes] float32 (idf; 0 for non-leaves)
    node_word: "np.ndarray"  # [n_nodes] int32 word id, -1 for non-leaves
    n_words: int
    branching: int
    depth: int


@functools.partial(jax.jit, static_argnames=("depth",))
def _descend(node_desc, node_children, node_word, node_weight, desc, depth):
    n = desc.shape[0]
    cur = jnp.zeros(n, jnp.int32)
    for _ in range(depth):
        children = node_children[cur]  # [N, kb]
        cdesc = node_desc[jnp.clip(children, 0, None)]  # [N, kb, 8]
        dist = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(cdesc, desc[:, None, :])),
            axis=-1,
        ).astype(jnp.int32)
        dist = jnp.where(children >= 0, dist, 1 << 20)
        best = jnp.argmin(dist, axis=-1)
        chosen = jnp.take_along_axis(children, best[:, None], axis=1)[:, 0]
        has_child = children[:, 0] >= 0
        cur = jnp.where(has_child, chosen, cur)
    return node_word[cur], node_weight[cur]


def transform(vocab: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray):
    """Descriptors [N, 8] -> (word_id [N] int32 (-1 invalid), weight [N]).

    The DBoW2 ``transform`` (TemplatedVocabulary.h) for a whole frame at
    once.
    """
    word, weight = _descend(
        vocab.node_desc, vocab.node_children, vocab.node_word,
        vocab.node_weight, desc, vocab.depth,
    )
    word = jnp.where(valid, word, -1)
    return word, jnp.where(valid, weight, 0.0)


def bow_vector(word: jnp.ndarray, weight: jnp.ndarray, n_words: int) -> jnp.ndarray:
    """Sparse (word, weight) pairs -> dense L1-normalized [W] tf-idf vector."""
    ok = word >= 0
    v = jnp.zeros(n_words, jnp.float32).at[jnp.where(ok, word, 0)].add(
        jnp.where(ok, weight, 0.0)
    )
    s = jnp.sum(v)
    return v / jnp.where(s < 1e-12, 1.0, s)


def l1_score(v: jnp.ndarray, database: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity of one vector vs a [K, W] database -> [K] in [0,1]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(database - v[None, :]), axis=-1)


def shared_word_counts(v: jnp.ndarray, database: jnp.ndarray) -> jnp.ndarray:
    """Number of common (nonzero) words with each database row — the
    inverted-file candidate filter (KeyFrameDatabase.cc:84-120) as a dense
    boolean reduction."""
    return jnp.sum((database > 0) & (v[None, :] > 0), axis=-1).astype(jnp.int32)
