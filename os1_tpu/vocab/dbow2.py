"""DBoW2 binary vocabulary format: reader/writer for drop-in interop.

The os1 binary format (documented at reference TemplatedVocabulary.h:1546-1560
and README.md:24 — the ~100x-faster loader os1 adds over stock ORB-SLAM2):

  header, 4 bytes:   k (branching), L (depth), scoring, weighting
  per-node, 45 bytes: parent id (int32) | isLeaf (u8) | descriptor (32 B)
                      | weight (float64)

Nodes appear in breadth-compatible order (parent always before child); node
ids are implicit (1-based, root = 0 has no record); word ids are assigned to
leaves in file order — all reproduced here so a vocabulary written by this
module loads in the reference and vice versa.
"""
from __future__ import annotations

import numpy as np

from .tree import Vocabulary

_REC = np.dtype(
    [
        ("parent", "<i4"),
        ("is_leaf", "u1"),
        ("desc", "u1", 32),
        ("weight", "<f8"),
    ]
)


def save_binary(vocab: Vocabulary, path: str) -> None:
    node_desc = np.asarray(vocab.node_desc)
    node_children = np.asarray(vocab.node_children)
    node_word = np.asarray(vocab.node_word)
    node_weight = np.asarray(vocab.node_weight)
    n = len(node_desc)

    # File node order must assign word ids (leaf order) consistently with
    # ours: emit nodes in id order (parents precede children by construction).
    parent = np.full(n, -1, np.int64)
    for i in range(n):
        for c in node_children[i]:
            if c >= 0:
                parent[c] = i

    # Word ids are IMPLICIT in the file (leaves numbered in record order,
    # TemplatedVocabulary binary layout), so in-memory word numbering — the
    # native trainer assigns ids in a different traversal order — need not
    # match: the reloaded vocabulary is renumbered but self-consistent, and
    # nothing persists word ids across save/load (BoW vectors are always
    # recomputed from descriptors).

    recs = np.zeros(n - 1, _REC)
    for i in range(1, n):
        r = recs[i - 1]
        r["parent"] = parent[i]
        r["is_leaf"] = 1 if node_word[i] >= 0 else 0
        r["desc"] = node_desc[i].view(np.uint8)
        r["weight"] = float(node_weight[i])
    with open(path, "wb") as f:
        f.write(
            bytes([vocab.branching & 0xFF, vocab.depth & 0xFF, 0, 0])
        )  # L1-NORM, TF_IDF
        f.write(recs.tobytes())


def load_binary(path: str) -> Vocabulary:
    import jax.numpy as jnp

    # Native fast path: one mmap'd C++ pass (the binary-loader speed the
    # reference added orbVoc.bin for; the Python loop below is the fallback).
    try:
        from ..native import load_vocab_binary_native

        loaded = load_vocab_binary_native(path)
    except Exception:
        loaded = None
    if loaded is not None:
        desc, children, weight, word, n_words, kb, L = loaded
        return Vocabulary(
            node_desc=np.asarray(desc),
            node_children=np.asarray(children),
            node_weight=np.asarray(weight),
            node_word=np.asarray(word),
            n_words=n_words,
            branching=kb,
            depth=L,
        )

    with open(path, "rb") as f:
        header = f.read(4)
        k, L = header[0], header[1]
        body = f.read()
    recs = np.frombuffer(body[: (len(body) // 45) * 45], dtype=_REC)
    n = len(recs) + 1

    node_desc = np.zeros((n, 8), np.uint32)
    node_children = np.full((n, k), -1, np.int32)
    node_weight = np.zeros(n, np.float32)
    node_word = np.full(n, -1, np.int32)
    child_count = np.zeros(n, np.int32)

    parents = recs["parent"].astype(np.int64)
    node_desc[1:] = np.ascontiguousarray(recs["desc"]).reshape(n - 1, 8, 4).view(np.uint32).reshape(n - 1, 8)
    node_weight[1:] = recs["weight"].astype(np.float32)
    w = 0
    for i in range(1, n):
        p = parents[i - 1]
        node_children[p, child_count[p]] = i
        child_count[p] += 1
        if recs["is_leaf"][i - 1]:
            node_word[i] = w
            w += 1

    return Vocabulary(
        node_desc=np.asarray(node_desc),
        node_children=np.asarray(node_children),
        node_weight=np.asarray(node_weight),
        node_word=np.asarray(node_word),
        n_words=w,
        branching=int(k),
        depth=int(L),
    )


_DEFAULT_CACHE = None


def default_vocabulary() -> Vocabulary:
    """The packaged default vocabulary. Prefers the reference-scale tree
    (data/vocab_1m.bin, k=10 L=6, ~8.5x10^5 nodes / 7.6x10^5 words — the
    analogue of the reference's ~10^6-node orbVoc.bin, trained by
    scripts/train_vocab_1m.py on a 4.8M-descriptor rendered corpus), then
    the small texture-trained default (data/default_vocab.bin), training one
    if absent."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is not None:
        return _DEFAULT_CACHE
    import os

    data_dir = os.path.join(os.path.dirname(__file__), "..", "data")
    big = os.path.abspath(os.path.join(data_dir, "vocab_1m.bin"))
    if os.path.exists(big):
        _DEFAULT_CACHE = load_binary(big)
        return _DEFAULT_CACHE
    path = os.path.join(os.path.dirname(__file__), "..", "data", "default_vocab.bin")
    path = os.path.abspath(path)
    if not os.path.exists(path):
        from .train import build_vocabulary, training_descriptors

        os.makedirs(os.path.dirname(path), exist_ok=True)
        descs, docs = training_descriptors()
        vocab = build_vocabulary(
            descs, branching=10, depth=4, n_docs=int(docs.max()) + 1, doc_ids=docs
        )
        save_binary(vocab, path)
    _DEFAULT_CACHE = load_binary(path)
    return _DEFAULT_CACHE
