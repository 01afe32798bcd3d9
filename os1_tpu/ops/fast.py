"""FAST-9/16 corner scoring as a dense, data-parallel map.

The reference runs OpenCV's scalar FAST per 30x30 cell with a threshold
fallback 20->7 (ORBextractor.cc:848-856). Here the whole level is scored at
once: the 16 Bresenham-circle neighbors become 16 shifted views of the image,
the "9 contiguous brighter/darker" test becomes a windowed reduction over a
[16, H, W] stack, and non-max suppression is a 3x3 reduce_window. Output is
a dense score map (zero = not a corner) — downstream spatial balancing picks
keypoints from it (ops/topk.py).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (dx, dy), clockwise from 12 o'clock — the
# standard FAST-16 ring (same geometry OpenCV uses).
CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

ARC = 9  # contiguous run length for FAST-9


def _ring_views(img: jnp.ndarray) -> list:
    """[..., H, W] -> 16 shifted views (neighbor intensity at each circle
    offset; leading axes, e.g. a pyramid-level stack, pass through).

    A Python LIST of lazy pad+slice views, not a stacked [16, ...] array:
    stacking materializes ~40 MB per pyramid stack and every roll of it in
    device memory; as separate views XLA fuses all ring reads into the elementwise
    min/max chain that follows — one pass over the image."""
    h, w = img.shape[-2], img.shape[-1]
    pad = [(0, 0)] * (img.ndim - 2) + [(3, 3), (3, 3)]
    padded = jnp.pad(img, pad, mode="edge")
    return [
        padded[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in CIRCLE
    ]


def _arc_min9(x: list) -> jnp.ndarray:
    """Min over every circular window of ARC=9 consecutive ring positions,
    maxed over the 16 window starts. Doubling trick on the unrolled list:
    window-min of length 9 from mins of lengths 1,2,4,8 — 64 fused
    elementwise mins, no [16, 9, H, W] window stack."""
    n = len(x)
    m2 = [jnp.minimum(x[k], x[(k + 1) % n]) for k in range(n)]
    m4 = [jnp.minimum(m2[k], m2[(k + 2) % n]) for k in range(n)]
    m8 = [jnp.minimum(m4[k], m4[(k + 4) % n]) for k in range(n)]
    m9 = [jnp.minimum(m8[k], x[(k + 8) % n]) for k in range(n)]
    out = m9[0]
    for k in range(1, n):
        out = jnp.maximum(out, m9[k])
    return out  # [..., H, W]


def fast_margin(img: jnp.ndarray, bounds=None) -> jnp.ndarray:
    """Threshold-free FAST-9/16 corner margin map, [..., H, W] float32.

    margin = max over contiguous 9-arcs of min |ring - p| (signed per
    bright/dark direction). The score at threshold t is max(margin - t, 0):
    one margin computation serves every threshold (the reference's 20->7
    fallback re-runs OpenCV FAST; here it is a subtraction).

    bounds: optional ([...] h, [...] w) per-slice valid extents (a padded
    pyramid stack); defaults to the full array shape."""
    # bf16 halves the bandwidth of the [16, ..., H, W] ring traffic; for
    # 0-255 intensities the quantization error is <= 1 gray level, well under
    # the FAST thresholds (margins only rank corners for top-k selection).
    img = img.astype(jnp.bfloat16)
    ring = _ring_views(img)  # 16 lazy shifted views
    margin = jnp.maximum(
        _arc_min9([r - img for r in ring]),
        _arc_min9([img - r for r in ring]),
    ).astype(jnp.float32)
    # Kill the 3px border (ring reads clamp there and are meaningless).
    h, w = img.shape[-2], img.shape[-1]
    shape = img.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, shape, img.ndim - 2)
    xs = jax.lax.broadcasted_iota(jnp.int32, shape, img.ndim - 1)
    if bounds is None:
        hb, wb = h, w
    else:
        hb = jnp.reshape(bounds[0], bounds[0].shape + (1, 1))
        wb = jnp.reshape(bounds[1], bounds[1].shape + (1, 1))
    interior = (ys >= 3) & (ys < hb - 3) & (xs >= 3) & (xs < wb - 3)
    return jnp.where(interior, margin, 0.0)


def fast_scores(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9/16 corner score map, [H, W] float32 (0 = no corner).

    Matches OpenCV's "highest threshold at which the pixel is still a
    corner" score up to the constant offset t."""
    return jnp.maximum(fast_margin(img) - threshold, 0.0)


def nms3x3(scores: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression over the last two axes: keep strict local
    maxima, zero the rest."""
    one = (1,) * (scores.ndim - 2)
    neigh_max = jax.lax.reduce_window(
        scores,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=one + (3, 3),
        window_strides=one + (1, 1),
        padding="SAME",
    )
    return jnp.where((scores >= neigh_max) & (scores > 0.0), scores, 0.0)


def fast_with_fallback(img: jnp.ndarray, hi: float, lo: float, bounds=None) -> jnp.ndarray:
    """Score with high threshold; where an image region yields nothing, the
    low-threshold response is used (branchless version of the reference's
    20->7 per-cell fallback, ORBextractor.cc:848-856). Operates on [..., H, W]
    (a pyramid stack scores every level in the same ops).

    Returned scores from the fallback pass are down-weighted so genuine
    high-threshold corners always outrank fallback ones in top-k selection.
    """
    margin = fast_margin(img, bounds=bounds)
    s_hi = jnp.maximum(margin - hi, 0.0)
    s_lo = jnp.maximum(margin - lo, 0.0)
    # Region emptiness test at 32x32 granularity via max-pool.
    region = 32
    h, w = img.shape[-2], img.shape[-1]
    lead = img.ndim - 2
    ph = (region - h % region) % region
    pw = (region - w % region) % region
    pad = jnp.pad(s_hi, [(0, 0)] * lead + [(0, ph), (0, pw)])
    one = (1,) * lead
    pooled = jax.lax.reduce_window(
        pad, -jnp.inf, jax.lax.max,
        window_dimensions=one + (region, region),
        window_strides=one + (region, region),
        padding="VALID",
    )
    empty = pooled <= 0.0
    # Broadcast each region flag back over its region (reshape, no gather).
    hp, wp = pooled.shape[-2], pooled.shape[-1]
    empty_full = jnp.broadcast_to(
        empty[..., :, None, :, None],
        empty.shape[:-2] + (hp, region, wp, region),
    ).reshape(empty.shape[:-2] + (hp * region, wp * region))[..., :h, :w]
    # Fallback scores are scaled into (0, lo] so they sort below real ones.
    peak = jnp.max(s_lo, axis=(-2, -1), keepdims=True)
    s_fb = s_lo / (1.0 + peak) * lo
    return jnp.where(empty_full, s_fb, s_hi)
