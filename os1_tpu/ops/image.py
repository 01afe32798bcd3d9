"""Image-plane ops for the feature pipeline: grayscale, separable Gaussian
blur, bilinear pyramid resize, and batched patch extraction.

These replace the OpenCV calls in the reference's ORBextractor
(cvtColor Tracking.cc:96-109, cv::resize ComputePyramid ORBextractor.cc:971,
GaussianBlur ORBextractor.cc:898) with XLA-fusable jnp code; everything
operates on float32 [H, W] images.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def rgb_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    """[H, W, 3] (RGB, any float/int dtype) -> [H, W] float32 luminance.

    Uses the same BT.601 weights as cv::cvtColor(BGR2GRAY)'s RGB ordering,
    matching the reference's grayscale conversion (Tracking.cc:96-109).
    """
    img = img.astype(jnp.float32)
    if img.ndim == 2:
        return img
    w = jnp.array([0.299, 0.587, 0.114], dtype=jnp.float32)
    return img @ w


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with replicate-edge padding over the last two
    axes of [..., H, W] float32.

    Matches the 7x7 sigma=2 blur applied before BRIEF sampling in the
    reference (ORBextractor.cc:898).
    """
    # Separable taps as shifted static slices: XLA fuses the weighted adds
    # into two elementwise passes. A conv_general_dilated with C=1 channels
    # took a degenerate (slow) convolution path on the accelerator the
    # system was first built on; not measured on an NVIDIA GPU.
    k = _gaussian_kernel(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    zero = [(0, 0)] * (img.ndim - 2)
    x = jnp.pad(img, zero + [(pad, pad), (0, 0)], mode="edge")
    x = sum(float(k[i]) * x[..., i : i + h, :] for i in range(ksize))
    x = jnp.pad(x, zero + [(0, 0), (pad, pad)], mode="edge")
    x = sum(float(k[i]) * x[..., :, i : i + w] for i in range(ksize))
    return x


def replicate_level_edges(stack: jnp.ndarray, hb: jnp.ndarray, wb: jnp.ndarray) -> jnp.ndarray:
    """Replicate each level's last valid row/col into the padding of a
    [L, H, W] pyramid stack (level l's content occupies the top-left
    (hb[l], wb[l]) corner, the rest is zero).

    Needed before any spatial filter over the stack: a blur would otherwise
    bleed the zero padding into each level's content near its right/bottom
    boundary, darkening descriptor patches of border keypoints (the per-level
    reference blur uses replicate edges at true level bounds,
    ORBextractor.cc:898).
    """
    L, H, W = stack.shape
    ys = jnp.minimum(jnp.arange(H, dtype=jnp.int32)[None, :], hb[:, None] - 1)
    out = jnp.take_along_axis(stack, ys[:, :, None], axis=1)
    xs = jnp.minimum(jnp.arange(W, dtype=jnp.int32)[None, :], wb[:, None] - 1)
    return jnp.take_along_axis(out, xs[:, None, :], axis=2)


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize [H, W] -> [out_h, out_w] (pyramid downscale)."""
    return jax.image.resize(img, (out_h, out_w), method="bilinear")


def _resize_matrix(n_in: int, n_out: int, n_pad: int) -> np.ndarray:
    """[n_pad, n_in] bilinear interpolation matrix (half-pixel centers), rows
    past n_out are zero. Separable resize as a dense matmul, which the
    matrix units take at full rate where a gather-based resize is
    latency-bound (chosen on the accelerator the system was first built on;
    the H100 comparison is open)."""
    R = np.zeros((n_pad, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        j0 = int(np.floor(src))
        t = src - j0
        ja, jb = np.clip(j0, 0, n_in - 1), np.clip(j0 + 1, 0, n_in - 1)
        R[i, ja] += 1.0 - t
        R[i, jb] += t
    return R


def pyramid_matrices(h: int, w: int, level_sizes) -> tuple[np.ndarray, np.ndarray]:
    """(Ry [L, h, h], Rx [L, w, w]) such that level l of the padded pyramid
    stack is Ry[l] @ img @ Rx[l].T — every level computed straight from the
    base image in two batched matmuls (reference ComputePyramid,
    ORBextractor.cc:971-996, resizes level-to-level sequentially)."""
    Ry = np.stack([_resize_matrix(h, hl, h) for hl, _ in level_sizes])
    Rx = np.stack([_resize_matrix(w, wl, w) for _, wl in level_sizes])
    return Ry, Rx


def build_pyramid_stack(img: jnp.ndarray, Ry: jnp.ndarray, Rx: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> padded pyramid stack [L, H, W] (level l occupies the
    top-left (h_l, w_l) corner; the rest is zero).

    The resize matmuls run in bf16 (f32 accumulation): for 0-255 intensities
    the rounding is <= 0.5 gray level on the DOWNSCALED levels only — level 0
    is injected exactly, so full-resolution FAST scores stay bit-faithful."""
    t = jnp.einsum(
        "lhy,yx->lhx", Ry[1:].astype(jnp.bfloat16), img.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    rest = jnp.einsum(
        "lhx,lwx->lhw", t.astype(jnp.bfloat16), Rx[1:].astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return jnp.concatenate([img[None], rest], axis=0)


def extract_patches_stack(
    stack: jnp.ndarray, level: jnp.ndarray, centers: jnp.ndarray, patch: int
) -> jnp.ndarray:
    """Gather square patches from a [L, H, W] pyramid stack.

    level: [N] int32 pyramid level per keypoint; centers: [N, 2] (x, y) in
    level-local coordinates. Returns [N, patch, patch]."""
    half = patch // 2
    cx = jnp.round(centers[..., 0]).astype(jnp.int32)
    cy = jnp.round(centers[..., 1]).astype(jnp.int32)
    _, h, w = stack.shape
    y0 = jnp.clip(cy - half, 0, h - patch)
    x0 = jnp.clip(cx - half, 0, w - patch)

    def one(lyx):
        return jax.lax.dynamic_slice(
            stack, (lyx[0], lyx[1], lyx[2]), (1, patch, patch)
        )[0]

    return jax.vmap(one)(jnp.stack([level, y0, x0], axis=-1))


def extract_patches(img: jnp.ndarray, centers: jnp.ndarray, patch: int) -> jnp.ndarray:
    """Gather square patches around integer centers.

    img: [H, W] float32. centers: [N, 2] float32/int (x, y). patch: odd size.
    Returns [N, patch, patch]. Out-of-bounds reads are clamped to the border
    (callers mask keypoints inside the valid border anyway, mirroring the
    reference's EDGE_THRESHOLD=19 margin).
    """
    half = patch // 2
    cx = jnp.round(centers[..., 0]).astype(jnp.int32)
    cy = jnp.round(centers[..., 1]).astype(jnp.int32)
    h, w = img.shape
    y0 = jnp.clip(cy - half, 0, h - patch)
    x0 = jnp.clip(cx - half, 0, w - patch)

    def one(yx):
        return jax.lax.dynamic_slice(img, (yx[0], yx[1]), (patch, patch))

    return jax.vmap(one)(jnp.stack([y0, x0], axis=-1))


def bilinear_sample_patches(patches: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation inside per-keypoint patches.

    patches: [N, S, S]; xy: [N, ..., 2] float patch-local coords (x, y).
    Returns [N, ...]. Much faster than gathering from the full image: the
    gather reads a [N, S*S] operand with per-row indices instead of scattered
    2D image locations.
    """
    n, s, _ = patches.shape
    flat = patches.reshape(n, s * s)
    shape = xy.shape[:-1]  # (N, ...)
    xy2 = xy.reshape(n, -1, 2)
    x = jnp.clip(xy2[..., 0], 0.0, s - 1.001)
    y = jnp.clip(xy2[..., 1], 0.0, s - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    base = y0 * s + x0

    def take(idx):
        return jnp.take_along_axis(flat, idx, axis=1)

    v00 = take(base)
    v01 = take(base + 1)
    v10 = take(base + s)
    v11 = take(base + s + 1)
    out = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    return out.reshape(shape)


def bilinear_sample(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation of [H, W] at float coords xy [..., 2] (x, y)."""
    h, w = img.shape
    x = jnp.clip(xy[..., 0], 0.0, w - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
