"""Batched ORB feature extraction: pyramid FAST -> spatial balance ->
orientation -> rotated binary descriptors, as one jitted device program.

Re-designs the reference's ORBextractor (ORBextractor.cc:907-996: 8-level
pyramid, per-cell FAST with 20->7 fallback, octree balancing, IC-angle
orientation, Gaussian blur + rotated BRIEF) for an accelerator: every stage is a dense
data-parallel map over the whole level, keypoint lists are fixed-capacity
masked arrays, and the per-level loop is unrolled at trace time (static
shapes per level).

Descriptor note: the sampling pattern is a seeded isotropic-Gaussian BRIEF
pattern generated at build time — NOT OpenCV's learned bit_pattern_31 table.
The framework is self-contained (its own matcher thresholds and its own BoW
vocabulary are calibrated to this pattern); parity with the reference is at
the capability level (256-bit rotated binary descriptors), not bit level.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import fast, image, topk, hamming

# Keep keypoints this far from the level border so orientation patches and
# rotated descriptor samples stay in-bounds (reference EDGE_THRESHOLD=19).
BORDER = 19
PATCH = 31  # orientation patch (radius 15), same as reference HALF_PATCH_SIZE*2+1
BRIEF_RADIUS = 13.0  # max offset of a descriptor sample from the keypoint


class OrbConfig(NamedTuple):
    """Static extractor configuration (hashable; one compiled program each).

    Defaults mirror the reference's webcam.yaml ORBextractor.* block:
    nFeatures=1000 (rounded to 1024 for tiling), scaleFactor=1.2, nLevels=8,
    iniThFAST=20, minThFAST=7.
    """

    height: int = 480
    width: int = 640
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_hi: float = 20.0
    fast_lo: float = 7.0
    cell: int = 16
    k_per_cell: int = 4
    seed: int = 42

    @property
    def scales(self) -> tuple:
        return tuple(self.scale_factor**l for l in range(self.n_levels))

    @property
    def sigma2(self) -> tuple:
        """Per-octave squared scale (reference Frame mvLevelSigma2)."""
        return tuple(s * s for s in self.scales)

    @property
    def level_sizes(self) -> tuple:
        return tuple(
            (int(round(self.height / s)), int(round(self.width / s)))
            for s in self.scales
        )

    @property
    def features_per_level(self) -> tuple:
        """Geometric budget split across levels (reference ORBextractor ctor)."""
        f = 1.0 / self.scale_factor
        raw = np.array([f**l for l in range(self.n_levels)])
        raw = raw / raw.sum() * self.n_features
        counts = np.floor(raw).astype(int)
        counts[0] += self.n_features - counts.sum()
        return tuple(int(c) for c in counts)


class FrameFeatures(NamedTuple):
    """Fixed-capacity masked keypoint set for one image.

    All arrays have leading dim n_features; invalid lanes have valid=False.
    ``xy`` is in level-0 (full-resolution) pixel coordinates, pre-undistortion
    (the reference's mvKeys; undistortion to mvKeysUn happens in the frame
    builder, see pipeline/frame.py).
    """

    xy: jnp.ndarray  # [N, 2] float32 (x, y)
    response: jnp.ndarray  # [N] float32
    angle: jnp.ndarray  # [N] float32 radians
    octave: jnp.ndarray  # [N] int32
    desc: jnp.ndarray  # [N, 8] uint32 packed 256-bit
    valid: jnp.ndarray  # [N] bool


N_ORIENT = 64  # discrete BRIEF pattern orientations (5.6 deg steps, max 2.8 deg rounding error)


def _brief_pattern(seed: int) -> np.ndarray:
    """[256, 2, 2] float32 sample-pair offsets, isotropic Gaussian (sigma =
    patch/5), clipped to BRIEF_RADIUS — the BRIEF-I construction."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(hamming.BITS, 2, 2))
    return np.clip(pts, -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.float32)


PS = 32  # keypoint patch size (covers the radius-15 orientation disc and
#          the +-14 nearest-pixel rotated BRIEF samples); a power of two,
#          so per-patch reductions stay aligned
_PC = 15  # patch center (row/col of the keypoint inside its patch)


def _rotated_patch_table(seed: int) -> np.ndarray:
    """[N_ORIENT, 256*2] int32: PATCH-LOCAL flat offsets (row * PS + col) of
    every BRIEF sample for each discrete pattern orientation, nearest-pixel
    rounded (this is also how OpenCV's ORB steers BRIEF: nearest-pixel reads
    of a rotated pattern, ORBextractor.cc computeOrbDescriptor).

    The steered pattern is precomputed per orientation bin; descriptors are
    sampled from per-keypoint 32x32 patches with one-hot matmuls. Premise:
    random flat gathers from the pyramid stack cost more than the patch
    materialization + matmuls. That held on the accelerator the system was
    first built on; on an NVIDIA GPU it is not measured."""
    pat = _brief_pattern(seed)  # [256, 2, 2] (x, y)
    r = BRIEF_RADIUS + 1
    tables = []
    for a in range(N_ORIENT):
        th = 2.0 * np.pi * a / N_ORIENT
        c, s = np.cos(th), np.sin(th)
        x = pat[..., 0] * c - pat[..., 1] * s
        y = pat[..., 0] * s + pat[..., 1] * c
        xi = np.clip(np.round(x), -r, r).astype(np.int64) + _PC
        yi = np.clip(np.round(y), -r, r).astype(np.int64) + _PC
        tables.append((yi * PS + xi).reshape(-1))
    return np.stack(tables).astype(np.int32)


def _ic_weights(patch: int = PATCH) -> tuple[np.ndarray, np.ndarray]:
    """x- and y-moment weight masks over the circular orientation patch
    (radius = reference HALF_PATCH_SIZE = 15 regardless of patch size)."""
    r = patch // 2
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    disc = (xs * xs + ys * ys) <= (PATCH // 2) ** 2
    return (xs * disc).astype(np.float32), (ys * disc).astype(np.float32)


def _ic_patch_weights() -> tuple[np.ndarray, np.ndarray]:
    """Dense x-/y-moment weight masks [PS, PS] over the radius-15
    orientation disc centered at the patch center — the reference's full
    IC_Angle disc (ORBextractor.cc:86-113), evaluated as two [PS*PS] dot
    products per patch (cheap once the patch is materialized)."""
    ys, xs = np.mgrid[0:PS, 0:PS]
    dy, dx = ys - _PC, xs - _PC
    disc = (dx * dx + dy * dy) <= (PATCH // 2) ** 2
    return (dx * disc).astype(np.float32), (dy * disc).astype(np.float32)


@functools.lru_cache(maxsize=8)
def make_extractor(cfg: OrbConfig):
    """Build a jitted extractor: float32 [H, W] grayscale -> FrameFeatures.

    All pyramid levels live in one padded [L, H, W] stack and every stage
    (pyramid resize as two matmuls, FAST, NMS, balanced top-k, patches,
    orientation, blur, rotated BRIEF) runs ONCE over the whole stack — the
    per-level loop version (reference ORBextractor.cc:907-969 structure) is
    dominated by per-op dispatch overhead on an accelerator, not compute.
    """
    sizes = cfg.level_sizes
    budgets = cfg.features_per_level
    scales = cfg.scales
    L = cfg.n_levels
    n_max = max(budgets)
    Ry, Rx = (jnp.asarray(a) for a in image.pyramid_matrices(cfg.height, cfg.width, sizes))
    hb = jnp.asarray(np.array([h for h, _ in sizes], np.int32))
    wb = jnp.asarray(np.array([w for _, w in sizes], np.int32))
    wx_np, wy_np = _ic_patch_weights()
    ic_wx, ic_wy = jnp.asarray(wx_np.reshape(-1)), jnp.asarray(wy_np.reshape(-1))
    sample_table = jnp.asarray(_rotated_patch_table(cfg.seed))

    @jax.jit
    def extract(img: jnp.ndarray) -> FrameFeatures:
        img = img.astype(jnp.float32)
        pyr = image.build_pyramid_stack(img, Ry, Rx)  # [L, H, W]

        scores = fast.nms3x3(
            fast.fast_with_fallback(img=pyr, hi=cfg.fast_hi, lo=cfg.fast_lo, bounds=(hb, wb))
        )
        ys = jax.lax.broadcasted_iota(jnp.int32, pyr.shape, 1)
        xs = jax.lax.broadcasted_iota(jnp.int32, pyr.shape, 2)
        interior = (
            (ys >= BORDER) & (ys < hb[:, None, None] - BORDER)
            & (xs >= BORDER) & (xs < wb[:, None, None] - BORDER)
        )
        scores = jnp.where(interior, scores, 0.0)

        xy, resp, valid = topk.balanced_cell_topk_batch(
            scores, cfg.cell, cfg.k_per_cell, n_max
        )  # [L, n_max, ...]

        # Per-level budget selection FIRST: the orientation/descriptor
        # stages below run on exactly n_features lanes, not L * n_max (the
        # unselected ~1.8x padding lanes were paying the same patch and
        # sampling cost as real keypoints).
        xy_o = jnp.concatenate([xy[l, : budgets[l]] for l in range(L)], axis=0)
        resp_o = jnp.concatenate([resp[l, : budgets[l]] for l in range(L)], 0)
        val_o = jnp.concatenate([valid[l, : budgets[l]] for l in range(L)], 0)
        oct_o = jnp.concatenate(
            [jnp.full(budgets[l], l, jnp.int32) for l in range(L)], 0
        )

        # The blurred stack feeds BOTH the orientation moments and the
        # descriptor samples (the blur is isotropic, so the intensity-
        # centroid direction matches the raw-image one; the reference blurs
        # before BRIEF too, ORBextractor.cc:898). Level edges are replicated
        # into the stack padding first so the blur cannot bleed zeros into
        # border samples on the upper levels. Keypoints sit >= BORDER from
        # their level bounds, so one 32x32 patch per keypoint covers the
        # orientation disc and every rotated BRIEF sample; the patches are
        # materialized with vmapped dynamic_slice, on the premise that this
        # is cheaper than random flat gathers from the stack (see
        # _rotated_patch_table).
        blurred = image.gaussian_blur(image.replicate_level_edges(pyr, hb, wb))
        cx = jnp.round(xy_o[:, 0]).astype(jnp.int32)
        cy = jnp.round(xy_o[:, 1]).astype(jnp.int32)

        def one_patch(l, y, x):
            return jax.lax.dynamic_slice(
                blurred, (l, y - _PC, x - _PC), (1, PS, PS)
            )[0]

        patches = jax.vmap(one_patch)(oct_o, cy, cx)  # [N, PS, PS]
        pflat = patches.reshape(-1, PS * PS)

        # Orientation: dense intensity-centroid disc as two dot products.
        m10 = pflat @ ic_wx
        m01 = pflat @ ic_wy
        angle = jnp.arctan2(m01, m10)  # [N]

        # Descriptors: steered BRIEF via the per-orientation patch-local
        # sample table; the 512 samples per keypoint are picked with one-hot
        # matmuls (row select) + a masked column sum — no gathers.
        two_pi = 2.0 * jnp.pi
        abin = (
            jnp.round(jnp.mod(angle, two_pi) * (N_ORIENT / two_pi)).astype(jnp.int32)
            % N_ORIENT
        )
        idx = sample_table[abin]  # [N, 512] patch-flat sample indices
        ir, ic = idx // PS, idx % PS
        lanes = jnp.arange(PS, dtype=jnp.int32)
        # Row-select via matmul: T[n, s, c] = patches[n, ir[n, s], c]. bf16 is
        # exact for the one-hot side; the blurred intensities round at
        # 2^-8 relative — flipping only BRIEF comparisons of near-equal
        # pixels, far below sensor noise.
        ohr = (ir[:, :, None] == lanes).astype(jnp.bfloat16)
        T = jnp.einsum(
            "nsr,nrc->nsc", ohr, patches.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        samples = jnp.sum(
            jnp.where(ic[:, :, None] == lanes, T, 0.0), axis=-1
        )  # [N, 512]
        samples = samples.reshape(-1, hamming.BITS, 2)
        desc_o = hamming.pack_bits(samples[..., 0] < samples[..., 1])

        scale_per_lane = jnp.concatenate(
            [jnp.full(budgets[l], scales[l], jnp.float32) for l in range(L)], 0
        )
        return FrameFeatures(
            xy=xy_o * scale_per_lane[:, None], response=resp_o, angle=angle,
            octave=oct_o, desc=desc_o, valid=val_o,
        )

    return extract
