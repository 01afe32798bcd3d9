"""Synthetic textured-scene renderer: ground-truth image sequences for
end-to-end pipeline tests and benchmarks.

The reference's de-facto regression mechanism is deterministic video replay
(SURVEY.md §4); with no camera or dataset available, this renderer is the
equivalent: known geometry + known trajectory -> images, so ATE can be
asserted against exact ground truth.

Scene model: N textured planes in world space. Per camera pose, each pixel's
ray is intersected with every plane; the nearest positive hit samples that
plane's texture bilinearly. Pure numpy, vectorized per plane.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class TexturedPlane:
    origin: np.ndarray  # [3] a point on the plane (texture (0,0))
    u_axis: np.ndarray  # [3] in-plane axis, |u| = world width of texture
    v_axis: np.ndarray  # [3] in-plane axis
    texture: np.ndarray  # [Ht, Wt] float32 intensities


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bicubic interpolation weights with OpenCV INTER_CUBIC's
    conventions: Keys kernel with a = -0.75, half-pixel centre mapping
    src = (dst + 0.5) * n_in / n_out - 0.5, and replicated borders."""
    a = -0.75
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = np.stack([
        ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
        ((a + 2) * t - (a + 3)) * t * t + 1,
        ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1,
    ], axis=1)
    w = np.concatenate([w, 1.0 - w.sum(1, keepdims=True)], axis=1)
    m = np.zeros((n_out, n_in))
    for k in range(4):
        np.add.at(m, (np.arange(n_out), np.clip(i0 + k - 1, 0, n_in - 1)), w[:, k])
    return m


def resize_cubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bicubic resize of a 2-D array to [h, w] float32 (cv2.resize with
    INTER_CUBIC, in numpy)."""
    img = np.asarray(img, np.float64)
    ry = _cubic_resize_matrix(img.shape[0], h)
    rx = _cubic_resize_matrix(img.shape[1], w)
    return (ry @ img @ rx.T).astype(np.float32)


def smooth_texture(h, w, cells, lo=20.0, hi=235.0, seed=0):
    """Band-limited random texture with strong corners at every scale."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(lo, hi, size=(cells, cells)).astype(np.float32)
    return np.clip(resize_cubic(base, h, w), 0, 255)


def default_scene(seed=0) -> list[TexturedPlane]:
    """Two fronto-parallel planes at different depths + a floor: general
    (non-planar) structure so initialization takes the fundamental path."""
    t1 = smooth_texture(512, 512, 48, seed=seed)
    t2 = smooth_texture(512, 512, 40, seed=seed + 1)
    t3 = smooth_texture(512, 512, 56, seed=seed + 2)
    return [
        TexturedPlane(
            origin=np.array([-4.0, -3.0, 8.0]),
            u_axis=np.array([8.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 6.0, 0.0]),
            texture=t1,
        ),
        TexturedPlane(
            origin=np.array([-5.0, -3.5, 12.0]),
            u_axis=np.array([10.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 7.0, 0.0]),
            texture=t2,
        ),
        TexturedPlane(  # floor
            origin=np.array([-5.0, 2.0, 4.0]),
            u_axis=np.array([10.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 0.5, 9.0]),
            texture=t3,
        ),
    ]


def render(scene, Tcw: np.ndarray, K: np.ndarray, h: int, w: int,
           background: float = 10.0, fisheye: bool = False) -> np.ndarray:
    """Render one grayscale frame [h, w] float32 from camera pose Tcw.

    fisheye=True renders through the equidistant model (distorted radius =
    angle from axis — the os1 fisheye extension, Frame.cc:355-384): each
    pixel's ray is bent by tan(theta_d)/theta_d, exactly the inverse the
    camera model undistorts with, so a fisheye System on these frames sees
    geometrically consistent input."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    C = -R.T @ t  # camera center (world)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xn = (xs - K[0, 2]) / K[0, 0]
    yn = (ys - K[1, 2]) / K[1, 1]
    if fisheye:
        theta_d = np.sqrt(xn * xn + yn * yn)
        safe = np.clip(np.where(theta_d < 1e-8, 1.0, theta_d),
                       None, np.pi / 2.0 - 1e-3)
        scale = np.where(theta_d < 1e-8, 1.0, np.tan(safe) / safe)
        xn, yn = xn * scale, yn * scale
    d_cam = np.stack([xn, yn, np.ones_like(xn)], axis=-1)
    d_world = d_cam @ R  # R^T @ d per pixel

    img = np.full((h, w), background, np.float64)
    depth = np.full((h, w), np.inf)
    for plane in scene:
        n = np.cross(plane.u_axis, plane.v_axis)
        denom = d_world @ n
        tt = ((plane.origin - C) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        hit = C + tt[..., None] * d_world
        rel = hit - plane.origin
        uu = rel @ plane.u_axis / (plane.u_axis @ plane.u_axis)
        vv = rel @ plane.v_axis / (plane.v_axis @ plane.v_axis)
        ok = (tt > 0.05) & (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1) & (tt < depth)
        th, tw = plane.texture.shape
        px = np.clip(uu * (tw - 1), 0, tw - 1.001)
        py = np.clip(vv * (th - 1), 0, th - 1.001)
        x0 = px.astype(int)
        y0 = py.astype(int)
        fx = px - x0
        fy = py - y0
        tex = plane.texture
        val = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, np.minimum(x0 + 1, tw - 1)] * fx * (1 - fy)
            + tex[np.minimum(y0 + 1, th - 1), x0] * (1 - fx) * fy
            + tex[np.minimum(y0 + 1, th - 1), np.minimum(x0 + 1, tw - 1)] * fx * fy
        )
        img = np.where(ok, val, img)
        depth = np.where(ok, tt, depth)
    return img.astype(np.float32)


def room_scene(seed=0, half_size: float = 6.0, half_h: float = 2.5) -> list[TexturedPlane]:
    """Four inward-facing textured walls of a square room — the rendered rig
    for end-to-end loop-closure tests: a camera circling inside revisits its
    starting view after 360 degrees."""
    S, hh = half_size, half_h
    walls = []
    specs = [
        (np.array([-S, -hh, S]), np.array([2 * S, 0.0, 0.0])),   # z = +S
        (np.array([S, -hh, -S]), np.array([-2 * S, 0.0, 0.0])),  # z = -S
        (np.array([S, -hh, S]), np.array([0.0, 0.0, -2 * S])),   # x = +S
        (np.array([-S, -hh, -S]), np.array([0.0, 0.0, 2 * S])),  # x = -S
    ]
    for i, (origin, u) in enumerate(specs):
        walls.append(TexturedPlane(
            origin=origin, u_axis=u, v_axis=np.array([0.0, 2 * hh, 0.0]),
            texture=smooth_texture(512, 512, 44 + 6 * i, seed=seed + i),
        ))
    return walls


def loop_trajectory(n_frames: int, radius: float = 1.5,
                    revolutions: float = 1.15) -> list[np.ndarray]:
    """Closed-circuit trajectory: the camera moves on a circle in the x-z
    plane looking radially outward, covering ``revolutions`` turns — the
    final ~0.15 turn revisits the start and exercises loop closure.
    Returns Tcw matrices (world = circle center frame)."""
    poses = []
    for i in range(n_frames):
        th = 2.0 * np.pi * revolutions * i / max(n_frames - 1, 1)
        fwd = np.array([np.sin(th), 0.0, np.cos(th)])
        right = np.array([np.cos(th), 0.0, -np.sin(th)])
        down = np.array([0.0, 1.0, 0.0])
        Rwc = np.stack([right, down, fwd], axis=1)  # columns = camera axes
        pos = radius * fwd + np.array([0.0, 0.05 * np.sin(3 * th), 0.0])
        Tcw = np.eye(4)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ pos
        poses.append(Tcw.astype(np.float32))
    return poses


def orbit_trajectory(n_frames: int, radius: float = 0.04,
                     advance: float = 0.06) -> list[np.ndarray]:
    """Sideways-dominant smooth trajectory with small rotations: good
    parallax for initialization, realistic for handheld motion.
    Returns a list of Tcw matrices (world = first-camera frame)."""
    from scipy.spatial.transform import Rotation

    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        pos = np.array(
            [advance * i, radius * np.sin(2 * np.pi * s), 0.15 * np.sin(np.pi * s)]
        )
        yaw = -0.15 * s  # slowly turn toward the scene
        Rwc = Rotation.from_euler("yxz", [yaw, 0.02 * np.sin(4 * s), 0.0]).as_matrix()
        Tcw = np.eye(4)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ pos
        poses.append(Tcw.astype(np.float32))
    return poses


FRAME_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".frame_cache",
)


def _render_key(scene, poses, K, h, w, noise_sigma, seed) -> str:
    """Digest of everything a rendered stack depends on, this module's own
    source included, so a changed scene or renderer never hits a stale
    entry."""
    hsh = hashlib.sha256()
    with open(__file__, "rb") as f:
        hsh.update(f.read())
    for plane in scene:
        for arr in (plane.origin, plane.u_axis, plane.v_axis, plane.texture):
            arr = np.ascontiguousarray(arr)
            hsh.update(str((arr.dtype, arr.shape)).encode())
            hsh.update(arr.tobytes())
    hsh.update(np.ascontiguousarray(np.stack(poses), np.float64).tobytes())
    hsh.update(np.ascontiguousarray(K, np.float64).tobytes())
    hsh.update(repr((h, w, float(noise_sigma), int(seed))).encode())
    return hsh.hexdigest()[:32]


def render_sequence(scene, poses, K, h: int, w: int,
                    noise_sigma: float = 0.0, seed: int = 0) -> np.ndarray:
    """Render a whole trajectory to a [n, h, w] uint8 stack, cached in
    FRAME_CACHE_DIR and keyed by the render's inputs (rendering 300 frames
    with the pure-numpy ray tracer takes minutes; the cache makes every
    rerun start in seconds).

    noise_sigma > 0 adds per-frame Gaussian photometric noise (deterministic
    per seed) — the synthetic stand-in for sensor noise asked of the
    accuracy gates when no real dataset is available."""
    key = _render_key(scene, poses, K, h, w, noise_sigma, seed)
    path = os.path.join(FRAME_CACHE_DIR, f"{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["frames"]
    frames = np.stack([
        np.clip(render(scene, T, K, h, w), 0, 255) for T in poses
    ])
    if noise_sigma > 0.0:
        rng = np.random.default_rng(seed)
        frames = frames + rng.normal(0.0, noise_sigma, frames.shape)
    frames = np.clip(frames, 0, 255).astype(np.uint8)
    os.makedirs(FRAME_CACHE_DIR, exist_ok=True)
    tmp = path[:-4] + f".tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, frames=frames)
    os.replace(tmp, path)
    return frames


def aligned_errors(est: list[np.ndarray], gt: list[np.ndarray]) -> np.ndarray:
    """Per-frame position error after Sim3 (Umeyama) alignment of the
    estimated camera centers onto ground truth (scale is unobservable in
    monocular SLAM). Returns [n] distances; ate_rmse is their RMS."""
    pe = np.array([-T[:3, :3].T @ T[:3, 3] for T in est])
    pg = np.array([-T[:3, :3].T @ T[:3, 3] for T in gt])
    mu_e, mu_g = pe.mean(0), pg.mean(0)
    ec, gc = pe - mu_e, pg - mu_g
    cov = gc.T @ ec / len(pe)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (ec**2).sum() / len(pe)
    scale = np.trace(np.diag(d) @ S) / max(var_e, 1e-12)
    t = mu_g - scale * R @ mu_e
    aligned = (scale * (R @ pe.T)).T + t
    return np.linalg.norm(aligned - pg, axis=1)


def ate_rmse(est: list[np.ndarray], gt: list[np.ndarray]) -> float:
    """Absolute trajectory error after Sim3 (Umeyama) alignment — the
    standard monocular evaluation (scale is unobservable)."""
    return float(np.sqrt((aligned_errors(est, gt) ** 2).mean()))
