"""Frame construction: image -> features + undistorted coordinates.

The reference's Frame constructor (Frame.cc:60-112: ORB extraction,
UndistortKeyPoints, grid assignment) as one device program. No 64x48 grid is
built — window queries are dense masked comparisons on the device (see
matching/core.py window_gate).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..features.orb import FrameFeatures, OrbConfig, make_extractor
from ..geometry import camera as cam_mod


class FrameData(NamedTuple):
    feats: FrameFeatures  # raw pixel coords (reference mvKeys)
    xy_un: jnp.ndarray  # [N, 2] undistorted coords (reference mvKeysUn)
    sigma2: jnp.ndarray  # [N] per-feature squared octave scale
    # Everything keyframe insertion needs, pre-packed into ONE [N, 13] f32
    # array (xy_un | angle | octave | valid | desc bits x8): one
    # device->host transfer at keyframe creation instead of five, each with
    # its own fixed latency.
    host_pack: jnp.ndarray = None


def unpack_host(pack: "np.ndarray"):
    """Host-side split of FrameData.host_pack ->
    (xy_un, angle, octave, desc, valid)."""
    import numpy as np

    pack = np.ascontiguousarray(pack)
    xy_un = pack[:, :2]
    angle = pack[:, 2]
    octave = pack[:, 3].astype(np.int32)
    valid = pack[:, 4] > 0.5
    desc = np.ascontiguousarray(pack[:, 5:13]).view(np.uint32)
    return xy_un, angle, octave, desc, valid


@functools.lru_cache(maxsize=8)
def make_frame_builder(orb_cfg: OrbConfig):
    extractor = make_extractor(orb_cfg)
    sigma2_table = jnp.asarray(orb_cfg.sigma2)

    @jax.jit
    def build(img: jnp.ndarray, cam: cam_mod.Camera) -> FrameData:
        # Accept uint8 uploads: a quarter of the bytes of a float32 frame on
        # the host->device path. The grayscale conversion the reference does on host
        # (Tracking.cc:96-109) happens here on device for free.
        feats = extractor(img.astype(jnp.float32))
        xy_un = cam_mod.undistort_pixels(cam, feats.xy)
        sigma2 = sigma2_table[feats.octave]
        pack = jnp.concatenate(
            [
                xy_un,
                feats.angle[:, None],
                feats.octave.astype(jnp.float32)[:, None],
                feats.valid.astype(jnp.float32)[:, None],
                jax.lax.bitcast_convert_type(feats.desc, jnp.float32),
            ],
            axis=1,
        )
        return FrameData(feats=feats, xy_un=xy_un, sigma2=sigma2, host_pack=pack)

    return build
