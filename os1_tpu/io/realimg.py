"""Real-photograph scene: sequences with REAL image statistics.

The reference is a live-webcam system (README.md:8) and its accuracy class
is quoted on real footage (BASELINE.md: TUM fr1/desk). This build runs in a
zero-egress environment — no TUM download, no camera — so the closest
honest substitute is rendering a known trajectory over REAL photographs:
natural texture spectra, edge/corner statistics, illumination gradients and
photometric clutter come from actual camera images, while ground truth
stays exact. FAST thresholds, the BRIEF pattern, matcher gates and the
vocabulary are thereby exercised against real-world descriptor
distributions, not the band-limited synthetic textures of io/synthetic.py.

Sources: data/photos.npz holds the three photographs as uint8 arrays,
taken from the copies that ship inside scikit-learn and matplotlib:
  * china, flower — 427x640 RGB, as sklearn.datasets.load_sample_image
    returns them. Both CC BY 2.0, by Flickr users danielbuechele and
    vultilion, retrieved 2011 by Robert Layton (scikit-learn's
    datasets/images/README.txt).
  * grace_hopper — 600x512 gray, as cv2.imread(IMREAD_GRAYSCALE) decodes
    matplotlib's sample_data/grace_hopper.jpg. U.S. Navy photograph,
    public domain.

The same photos feed the vocabulary-validation corpus (scripts/
validate_vocab_real.py): ORB descriptors extracted from them measure word
coverage / quantization balance of the shipped DBoW2 tree on real imagery.
"""
from __future__ import annotations

import os

import numpy as np

from .synthetic import TexturedPlane

PHOTOS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "photos.npz"
)


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = img[..., :3] @ np.array([0.299, 0.587, 0.114])
    return img.astype(np.float32)


def load_photos() -> list[np.ndarray]:
    """The three bundled photographs as float32 grayscale arrays: china,
    flower (BT.601 luminance of the RGB arrays) and grace_hopper."""
    with np.load(PHOTOS_PATH) as z:
        return [_to_gray(z["china"]), _to_gray(z["flower"]),
                z["grace_hopper"].astype(np.float32)]


def _tile_to(tex: np.ndarray, h: int, w: int, flip: bool = False) -> np.ndarray:
    """Tile/crop a photo to [h, w] (mirror-tiled so seams stay continuous)."""
    if flip:
        tex = tex[:, ::-1]
    th, tw = tex.shape
    ry = -(-h // th)
    rx = -(-w // tw)
    rows = []
    for i in range(ry):
        row = tex if i % 2 == 0 else tex[::-1]
        cells = [row if j % 2 == 0 else row[:, ::-1] for j in range(rx)]
        rows.append(np.concatenate(cells, axis=1))
    return np.concatenate(rows, axis=0)[:h, :w].copy()


def photo_room_scene(half_size: float = 6.0, half_h: float = 2.5):
    """Four inward-facing walls textured with real photographs — the
    real-imagery analogue of synthetic.room_scene for the loop-closure
    circuit."""
    photos = load_photos()
    S, hh = half_size, half_h
    specs = [
        (np.array([-S, -hh, S]), np.array([2 * S, 0.0, 0.0])),   # z = +S
        (np.array([S, -hh, -S]), np.array([-2 * S, 0.0, 0.0])),  # z = -S
        (np.array([S, -hh, S]), np.array([0.0, 0.0, -2 * S])),   # x = +S
        (np.array([-S, -hh, -S]), np.array([0.0, 0.0, 2 * S])),  # x = -S
    ]
    walls = []
    for i, (origin, u) in enumerate(specs):
        tex = photos[i % len(photos)]
        walls.append(TexturedPlane(
            origin=origin,
            u_axis=u,
            v_axis=np.array([0.0, 2 * hh, 0.0]),
            texture=_tile_to(tex, 512, 1024, flip=i >= len(photos)),
        ))
    return walls


def photo_scene():
    """Two photo planes at different depths + a photo floor (the general
    non-planar layout of synthetic.default_scene with real textures) for
    forward/orbit tracking sequences."""
    photos = load_photos()
    p = [photos[i % len(photos)] for i in range(3)]
    return [
        TexturedPlane(
            origin=np.array([-4.0, -3.0, 8.0]),
            u_axis=np.array([8.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 6.0, 0.0]),
            texture=_tile_to(p[0], 512, 768),
        ),
        TexturedPlane(
            origin=np.array([-5.0, -3.5, 12.0]),
            u_axis=np.array([10.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 7.0, 0.0]),
            texture=_tile_to(p[1], 512, 768, flip=True),
        ),
        TexturedPlane(  # floor
            origin=np.array([-5.0, 2.0, 4.0]),
            u_axis=np.array([10.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 0.5, 9.0]),
            texture=_tile_to(p[2], 512, 768),
        ),
    ]
