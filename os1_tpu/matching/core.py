"""Core batched matching machinery shared by every matcher variant.

The reference's ORBmatcher (ORBmatcher.cc, 1623 LoC) is eight hand-written
scalar loops that differ only in (a) which candidate pairs are considered
(projection window / BoW bucket / epipolar band / search window) and (b) the
accept thresholds. Here that structure is made explicit: every variant is

    distance matrix (±1 int8 dot)  +  boolean gate  +  row argmin
    + ratio test + optional mutual-best + rotation-consistency histogram

over fixed-shape masked arrays. Distances of gated-out pairs are +BIG so a
single argmin implements the candidate search.

Thresholds mirror the reference: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30
(ORBmatcher.cc:37-39).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import hamming

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = 1 << 20


class MatchResult(NamedTuple):
    """Per-row match outcome: row i of A matched to ``idx[i]`` of B."""

    idx: jnp.ndarray  # [N] int32 index into B (undefined where ~ok)
    dist: jnp.ndarray  # [N] int32 best Hamming distance
    ok: jnp.ndarray  # [N] bool


def distance_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """[N, 8] x [M, 8] packed descriptors -> [N, M] int32 distances, by the
    ±1 int8 dot (ops/hamming.py) on every platform and shape."""
    return hamming.hamming_matrix_mxu(desc_a, desc_b)


def match_with_gate(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    gate: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    dist: jnp.ndarray | None = None,
) -> MatchResult:
    """Best gated match in B for every row of A.

    gate: [N, M] bool — candidate pairs (False pairs are never matched).
    ratio: best/second-best Lowe ratio (1.0 disables; reference uses
      mfNNratio, typically 0.9 for tracking and 0.75 for BoW matching).
    dist: optional precomputed [N, M] distance matrix to reuse across
      variants in one pipeline step.
    """
    d = distance_matrix(desc_a, desc_b) if dist is None else dist
    d = jnp.where(gate, d, BIG)
    # Top-2 smallest per row via two passes of argmin (M is a few thousand;
    # two passes beat a full sort).
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(BIG)
    second = jnp.min(d2, axis=1)
    ok = (best <= max_dist) & (best.astype(jnp.float32) <= ratio * second.astype(jnp.float32))
    return MatchResult(idx=best_idx.astype(jnp.int32), dist=best.astype(jnp.int32), ok=ok)


def mutual_best(result: MatchResult, m: int) -> MatchResult:
    """Keep at most one row of A per column of B (the best-distance one).

    Equivalent to the reference's vnMatches21 bookkeeping in
    SearchForInitialization (ORBmatcher.cc:400-515): a later, worse match to
    an already-claimed feature is dropped.
    """
    n = result.idx.shape[0]
    # For every column, the min distance among rows claiming it.
    claimed = jnp.where(result.ok, result.idx, m)  # invalid rows claim slot m
    col_best = jnp.full(m + 1, BIG, jnp.int32).at[claimed].min(result.dist)
    # Winner = the single lowest-index row achieving that distance.
    is_best = result.ok & (result.dist == col_best[claimed])
    row_ids = jnp.arange(n, dtype=jnp.int32)
    col_winner = jnp.full(m + 1, n, jnp.int32).at[claimed].min(
        jnp.where(is_best, row_ids, n)
    )
    ok = is_best & (col_winner[claimed] == row_ids)
    return MatchResult(idx=result.idx, dist=result.dist, ok=ok)


def rotation_consistency(
    angle_a: jnp.ndarray,
    angle_b: jnp.ndarray,
    result: MatchResult,
    n_keep_bins: int = 3,
) -> MatchResult:
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (reference ComputeThreeMaxima, ORBmatcher.cc:1554-1602,
    with the same 10%-of-max bin cutoff)."""
    rot = angle_a - angle_b[result.idx]
    # Wrap to [0, 2pi) then bin into HISTO_LENGTH bins.
    two_pi = 2.0 * jnp.pi
    rot = jnp.mod(rot, two_pi)
    bins = jnp.clip((rot * (HISTO_LENGTH / two_pi)).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    counts = jnp.zeros(HISTO_LENGTH, jnp.int32).at[jnp.where(result.ok, bins, 0)].add(
        result.ok.astype(jnp.int32)
    )
    top_counts, top_bins = jax.lax.top_k(counts, n_keep_bins)
    # Reference drops 2nd/3rd bins below 0.1 * max.
    keep = top_counts.astype(jnp.float32) >= 0.1 * top_counts[0].astype(jnp.float32)
    keep_mask = jnp.zeros(HISTO_LENGTH, bool).at[top_bins].set(keep)
    ok = result.ok & keep_mask[bins]
    return MatchResult(idx=result.idx, dist=result.dist, ok=ok)


def window_gate(
    xy_a: jnp.ndarray,
    xy_b: jnp.ndarray,
    radius: jnp.ndarray | float,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
) -> jnp.ndarray:
    """[N, M] gate: B within ``radius`` (per-row scalar or [N]) of A (L_inf).

    The reference's GetFeaturesInArea grid lookup (Frame.cc:209-262) exists
    to avoid an O(N*M) scan on CPU; on the device the dense comparison is
    the fast path — the [N, M, 2] subtraction fuses with the distance gate,
    so no 64x48 grid structure is needed.
    """
    r = jnp.asarray(radius)
    if r.ndim == 1:
        r = r[:, None]
    diff = jnp.abs(xy_a[:, None, :] - xy_b[None, :, :])
    near = (diff[..., 0] <= r) & (diff[..., 1] <= r)
    return near & valid_a[:, None] & valid_b[None, :]


def octave_gate(
    octave_a: jnp.ndarray, octave_b: jnp.ndarray, lo: int = -1, hi: int = 1
) -> jnp.ndarray:
    """[N, M] gate: octave of B within [octave_a + lo, octave_a + hi]
    (the reference's minLevel/maxLevel checks in projection search)."""
    d = octave_b[None, :] - octave_a[:, None]
    return (d >= lo) & (d <= hi)
