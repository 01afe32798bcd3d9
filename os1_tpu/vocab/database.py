"""Keyframe place-recognition database: sparse BoW + inverted file.

Re-expresses the reference's KeyFrameDatabase (KeyFrameDatabase.cc, 341 LoC)
at reference vocabulary scale: each keyframe stores only its ~<=1024 present
words (a frame has at most n_features descriptors), candidate retrieval
walks an inverted file (word -> posting list, the reference's
mvInvertedFile, KeyFrameDatabase.h:144), and the two-stage candidate
protocol — shared words >= 0.8 * max, then covisibility-group score
accumulation with the 0.75 * best threshold — mirrors
DetectLoopCandidates (KeyFrameDatabase.cc:74-197) and
DetectRelocalizationCandidates (:199-336).

A dense [K, W] matrix (round-1 design) breaks at W ~ 10^5-10^6 words
(the reference's orbVoc.bin scale); the sparse form is O(present words).
L1 similarity of two L1-normalized sparse vectors reduces to
s = sum over shared words of min(a_w, b_w) (identical to DBoW2's
1 - 0.5 * ||a - b||_1 given both are normalized).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import jax

from . import tree
from .tree import Vocabulary


class SparseBow(NamedTuple):
    """L1-normalized sparse BoW vector (words sorted ascending)."""

    words: np.ndarray  # [n] int32
    weights: np.ndarray  # [n] float32, sums to 1


def _sparse_from_transform(word: np.ndarray, weight: np.ndarray) -> SparseBow:
    ok = word >= 0
    w = word[ok]
    wt = weight[ok]
    uw, inv = np.unique(w, return_inverse=True)
    acc = np.zeros(len(uw), np.float32)
    np.add.at(acc, inv, wt)
    s = acc.sum()
    if s > 1e-12:
        acc /= s
    return SparseBow(words=uw.astype(np.int32), weights=acc)


def sparse_l1_score(a: SparseBow, b: SparseBow) -> float:
    """s(a, b) = sum over shared words of min(a_w, b_w) in [0, 1]."""
    if len(a.words) == 0 or len(b.words) == 0:
        return 0.0
    ia = np.clip(np.searchsorted(a.words, b.words), 0, len(a.words) - 1)
    hit = a.words[ia] == b.words
    return float(np.minimum(a.weights[ia[hit]], b.weights[hit]).sum())


@dataclass
class KeyFrameDatabase:
    vocab: Vocabulary
    max_keyframes: int

    def __post_init__(self):
        self.active = np.zeros(self.max_keyframes, bool)
        self.bows = [None] * self.max_keyframes
        # Inverted file: word -> {kf: weight} (mvInvertedFile analogue).
        self.inverted: dict[int, dict[int, float]] = {}
        self._host_tree = None  # lazy host copy of the vocabulary arrays

    def _host_vocab(self):
        """Host-resident copies of the tree arrays, fetched ONCE. The tree
        may live in device memory, and a per-call copy of ~10^6 nodes would
        cost far more than the native descent itself."""
        if self._host_tree is None:
            # One array at a time, as utils/transfer.fetch does.
            self._host_tree = tuple(
                np.asarray(a) for a in (
                    self.vocab.node_desc, self.vocab.node_children,
                    self.vocab.node_weight, self.vocab.node_word,
                )
            )
        return self._host_tree

    # ------------------------------------------------------------------ #
    def compute_bow(self, desc, valid):
        """(word ids [N], weights [N], SparseBow) for one frame's
        descriptors. The vocabulary-tree descent is keyframe-rate host work
        (the reference runs it on the CPU too, KeyFrame::ComputeBoW) — it
        runs in the native library (~0.3 ms/KF at 10^4 words) so it never
        contends with the tracker's device programs; the JAX descent is the
        fallback when the native library is unavailable."""
        from ..native import bow_transform_native

        valid = np.asarray(valid)
        if not isinstance(desc, np.ndarray):
            desc = jax.device_get(desc)
        nd, nc, nw, nwo = self._host_vocab()
        out = bow_transform_native(
            desc, valid, nd, nc, nw, nwo, self.vocab.branching,
            self.vocab.depth,
        )
        if out is not None:
            word, weight = out
        else:
            import jax.numpy as jnp

            word, weight = tree._descend(
                self.vocab.node_desc, self.vocab.node_children,
                self.vocab.node_word, self.vocab.node_weight,
                jnp.asarray(desc), self.vocab.depth,
            )
            word, weight = jax.device_get((word, weight))
            word = np.where(valid, word, -1)
            weight = np.where(valid, weight, 0.0)
        return word, weight, _sparse_from_transform(word, weight)

    def add(self, kf: int, bow: SparseBow) -> None:
        if self.active[kf]:
            self.erase(kf)
        self.bows[kf] = bow
        self.active[kf] = True
        for w, wt in zip(bow.words.tolist(), bow.weights.tolist()):
            self.inverted.setdefault(w, {})[kf] = wt

    def erase(self, kf: int) -> None:
        bow = self.bows[kf]
        if bow is not None:
            for w in bow.words.tolist():
                post = self.inverted.get(w)
                if post is not None:
                    post.pop(kf, None)
                    if not post:
                        del self.inverted[w]
        self.bows[kf] = None
        self.active[kf] = False

    def clear(self) -> None:
        self.active[:] = False
        self.bows = [None] * self.max_keyframes
        self.inverted.clear()

    def score_kf(self, bow: SparseBow, kf: int) -> float:
        other = self.bows[kf]
        return sparse_l1_score(bow, other) if other is not None else 0.0

    # ------------------------------------------------------------------ #
    def _shared_and_scores(self, bow: SparseBow, exclude=None):
        """Inverted-file walk: (shared-word count, L1 score) per keyframe
        sharing at least one word (KeyFrameDatabase.cc:84-120)."""
        shared = np.zeros(self.max_keyframes, np.int32)
        score = np.zeros(self.max_keyframes, np.float32)
        for w, q_wt in zip(bow.words.tolist(), bow.weights.tolist()):
            for kf, wt in self.inverted.get(w, {}).items():
                shared[kf] += 1
                score[kf] += min(q_wt, wt)
        if exclude is not None and len(exclude):
            shared[np.asarray(exclude, np.int64)] = 0
        shared[~self.active] = 0
        return shared, score

    def query(self, bow: SparseBow, exclude=None, min_score: float = 0.0):
        """Two-stage filter: shared words >= 0.8 * max, score >= min_score.
        Returns (kf ids sorted by score desc, their scores)."""
        shared, score = self._shared_and_scores(bow, exclude)
        max_shared = shared.max() if shared.size else 0
        if max_shared == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        keep = (shared >= 0.8 * max_shared) & (score >= min_score) & (shared > 0)
        ids = np.nonzero(keep)[0]
        order = np.argsort(-score[ids], kind="stable")
        ids = ids[order]
        return ids, score[ids]

    def _accumulate_groups(self, cand_ids, cand_scores, covis_fn,
                           rel_factor: float = 0.75):
        """Covisibility-group score accumulation (KeyFrameDatabase.cc:124-197):
        each candidate's score is summed over its top-10 covisible group
        members that are also candidates; groups below rel_factor * best
        accumulated score are dropped; each surviving group contributes its
        best-scoring member."""
        if len(cand_ids) == 0:
            return np.empty(0, np.int64)
        in_cand = {int(k): float(s) for k, s in zip(cand_ids, cand_scores)}
        groups = []
        best_acc = 0.0
        for k in cand_ids:
            k = int(k)
            acc = in_cand[k]
            best_kf, best_s = k, in_cand[k]
            for k2 in covis_fn(k):
                k2 = int(k2)
                s2 = in_cand.get(k2)
                if s2 is None:
                    continue
                acc += s2
                if s2 > best_s:
                    best_kf, best_s = k2, s2
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        th = rel_factor * best_acc
        out, seen = [], set()
        for acc, best_kf in groups:
            if acc >= th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return np.array(out, np.int64)

    def detect_loop_candidates(self, bow: SparseBow, exclude, min_score,
                               covis_fn):
        """Full DetectLoopCandidates protocol (KeyFrameDatabase.cc:74-197)."""
        ids, scores = self.query(bow, exclude=exclude, min_score=min_score)
        return self._accumulate_groups(ids, scores, covis_fn)

    def detect_reloc_candidates(self, bow: SparseBow, covis_fn):
        """DetectRelocalizationCandidates (KeyFrameDatabase.cc:199-336):
        like the loop protocol but with no minimum-score gate."""
        ids, scores = self.query(bow)
        return self._accumulate_groups(ids, scores, covis_fn)
