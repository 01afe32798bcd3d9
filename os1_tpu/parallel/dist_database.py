"""Keyframe-sharded BoW place-recognition database over a device mesh.

Config 5 of BASELINE.json: a multi-session map can accumulate 10^4+
keyframes; querying the place-recognition database then dominates loop
detection and relocalization. The host inverted file (vocab/database.py) is
O(shared words) per query — great at single-session scale, but it walks
Python dicts serially. Here every keyframe's bag-of-words lives as a
fixed-width sorted array row, the keyframe axis is sharded across the mesh,
and one device program scores a query against EVERY keyframe (sorted-array
intersection via two-pointer-free broadcast compare) with a psum-free
sharded top-k: each shard returns its local top-k, the host merges n_dev
small lists.

Parity contract: scores match the host inverted file's L1 min-intersection
scores (vocab.database.KeyFrameDatabase) exactly; tests/test_parallel.py
checks it against the host DB. Each keyframe row holds ``max_words`` words:
a bow has at most one word per feature, so the extractor's feature count is
the capacity. A larger bow is refused rather than truncated (truncation
would drop words by id, not by weight, and change the scores).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "kfs"


def _score_kernel(kf_words, kf_weights, q_words, q_weights):
    """[Ks] L1 min-intersection scores of one query against a keyframe
    shard. Word arrays are sorted, -1-padded."""
    # match[w, q] — exact-word hits (padded slots are -1 on both sides and
    # never match because query padding is -2).
    hit = kf_words[:, :, None] == q_words[None, None, :]
    m = jnp.minimum(kf_weights[:, :, None], q_weights[None, None, :])
    return jnp.sum(jnp.where(hit, m, 0.0), axis=(1, 2))


class DistKeyFrameDatabase:
    """Sharded mirror of the place-recognition database.

    Host side keeps the authoritative padded arrays; `publish()` pushes them
    to the mesh (sharded over keyframes); `query()` runs the scoring program
    and merges per-shard top-k on the host. Use alongside the host inverted
    file: the host DB answers single-session-scale queries faster; this one
    scales the multi-session regime across chips.
    """

    def __init__(self, mesh: Mesh, max_keyframes: int, max_words: int):
        assert max_keyframes % mesh.devices.size == 0, (
            "keyframe capacity must divide the mesh"
        )
        self.mesh = mesh
        self.max_keyframes = max_keyframes
        self.max_words = max_words
        self.words = np.full((max_keyframes, max_words), -1, np.int32)
        self.weights = np.zeros((max_keyframes, max_words), np.float32)
        self.active = np.zeros(max_keyframes, bool)
        self._device = None  # (words, weights, active) on the mesh
        kf = P(AXIS)

        def score_all(kf_words, kf_weights, kf_active, q_words, q_weights):
            s = _score_kernel(kf_words, kf_weights, q_words, q_weights)
            s = jnp.where(kf_active, s, -1.0)
            k = min(64, kf_words.shape[0])
            vals, idx = jax.lax.top_k(s, k)
            return vals, idx  # LOCAL indices within the shard

        self._score = jax.jit(jax.shard_map(
            score_all, mesh=mesh,
            in_specs=(kf, kf, kf, P(), P()),
            out_specs=(kf, kf),
            check_vma=False,
        ))

    # ---------------- host-side bookkeeping --------------------------- #
    def _checked_size(self, bow) -> int:
        n = len(bow.words)
        if n > self.max_words:
            raise ValueError(
                f"bow has {n} words; the sharded database holds {self.max_words}"
            )
        return n

    def add(self, kf: int, bow) -> None:
        """Insert/replace a keyframe's sparse bow (words sorted ascending)."""
        n = self._checked_size(bow)
        self.words[kf] = -1
        self.weights[kf] = 0.0
        self.words[kf, :n] = bow.words[:n]
        self.weights[kf, :n] = bow.weights[:n]
        self.active[kf] = True
        self._device = None

    def erase(self, kf: int) -> None:
        self.active[kf] = False
        self._device = None

    def clear(self) -> None:
        self.active[:] = False
        self.words[:] = -1
        self._device = None

    def publish(self) -> None:
        """Push the current database to the mesh (amortize over queries)."""
        kf = NamedSharding(self.mesh, P(AXIS))
        self._device = (
            jax.device_put(self.words, kf),
            jax.device_put(self.weights, kf),
            jax.device_put(self.active, kf),
        )

    # ---------------- queries ----------------------------------------- #
    def query(self, bow, exclude=None, min_score: float = 0.0, top: int = 64):
        """(ids, scores) of the best-matching keyframes, best first."""
        if self._device is None:
            self.publish()
        qw = np.full(self.max_words, -2, np.int32)  # -2: never matches kf padding
        qv = np.zeros(self.max_words, np.float32)
        n = self._checked_size(bow)
        qw[:n] = bow.words[:n]
        qv[:n] = bow.weights[:n]
        vals, idx = jax.device_get(
            self._score(*self._device, jnp.asarray(qw), jnp.asarray(qv))
        )
        # Per-shard local top-k -> global ids, merged on host.
        n_dev = self.mesh.devices.size
        shard = self.max_keyframes // n_dev
        k = vals.shape[0] // n_dev
        gids = (idx.reshape(n_dev, k) + np.arange(n_dev)[:, None] * shard).ravel()
        gvals = vals.reshape(-1)
        keep = gvals > min_score
        if exclude is not None and len(exclude):
            keep &= ~np.isin(gids, np.asarray(exclude))
        gids, gvals = gids[keep], gvals[keep]
        order = np.argsort(-gvals, kind="stable")[:top]
        return gids[order], gvals[order]
