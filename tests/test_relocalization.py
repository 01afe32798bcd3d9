"""PnP solver unit tests + end-to-end relocalization after tracking loss."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from os1_tpu.geometry import se3
from os1_tpu.solvers.pnp import solve_pnp

INTR = jnp.asarray([400.0, 400.0, 320.0, 240.0])


def make_pnp_case(rng, n=200, outliers=0):
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    xi = np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 0.15, 3)]).astype(np.float32)
    T = np.asarray(se3.exp(jnp.asarray(xi)))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack(
        [400 * pc[:, 0] / pc[:, 2] + 320, 400 * pc[:, 1] / pc[:, 2] + 240], -1
    ).astype(np.float32)
    if outliers:
        bad = rng.choice(n, outliers, replace=False)
        uv[bad] = rng.uniform([0, 0], [640, 480], size=(outliers, 2))
    return pts, uv, T


class TestPnP:
    def test_exact(self, rng):
        pts, uv, T = make_pnp_case(rng)
        res = solve_pnp(
            jnp.asarray(pts), jnp.asarray(uv), jnp.ones(len(pts)),
            jnp.ones(len(pts), bool), INTR, jax.random.PRNGKey(0),
        )
        assert bool(res.success)
        assert np.abs(np.asarray(res.Tcw) - T).max() < 5e-3
        assert int(res.n_inliers) > 190

    def test_with_outliers(self, rng):
        pts, uv, T = make_pnp_case(rng, n=200, outliers=80)
        res = solve_pnp(
            jnp.asarray(pts), jnp.asarray(uv), jnp.ones(200),
            jnp.ones(200, bool), INTR, jax.random.PRNGKey(1),
        )
        assert bool(res.success)
        assert np.abs(np.asarray(res.Tcw) - T).max() < 1e-2
        assert int(res.n_inliers) > 100

    def test_too_few_points(self, rng):
        pts, uv, T = make_pnp_case(rng, n=20)
        valid = np.zeros(20, bool)
        valid[:5] = True  # below the 6-point sample size
        res = solve_pnp(
            jnp.asarray(pts), jnp.asarray(uv), jnp.ones(20),
            jnp.asarray(valid), INTR, jax.random.PRNGKey(2),
        )
        assert not bool(res.success)

    def test_deterministic(self, rng):
        pts, uv, T = make_pnp_case(rng, outliers=40)
        args = (
            jnp.asarray(pts), jnp.asarray(uv), jnp.ones(len(pts)),
            jnp.ones(len(pts), bool), INTR, jax.random.PRNGKey(3),
        )
        r1 = solve_pnp(*args)
        r2 = solve_pnp(*args)
        np.testing.assert_array_equal(np.asarray(r1.Tcw), np.asarray(r2.Tcw))


class TestRelocalizationE2E:
    @pytest.mark.slow
    def test_relocalize_after_loss(self):
        from os1_tpu.geometry.camera import Camera
        from os1_tpu.features.orb import OrbConfig
        from os1_tpu.io import synthetic
        from os1_tpu.map.store import MapConfig
        from os1_tpu.pipeline import System, SlamConfig, TrackingState

        H, W = 240, 320
        K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
        cam = Camera.make(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=W, height=H)
        cfg = SlamConfig(
            camera=cam,
            orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
            map=MapConfig(max_keyframes=64, max_points=8192, n_features=512),
        )
        sys_ = System(cfg=cfg)
        scene = synthetic.default_scene(seed=3)
        poses = synthetic.orbit_trajectory(25, advance=0.08)
        frames = [synthetic.render(scene, T, K, H, W) for T in poses]
        for i, f in enumerate(frames):
            sys_.track_monocular(f, timestamp=i / 30.0)
        assert sys_.state == TrackingState.OK

        # Blind the camera -> LOST.
        blank = np.zeros((H, W), np.float32)
        for i in range(3):
            state, _ = sys_.track_monocular(blank, timestamp=(25 + i) / 30.0)
        assert sys_.state == TrackingState.LOST

        # Return to a previously-seen viewpoint -> must relocalize.
        reloc_frame = synthetic.render(scene, poses[10], K, H, W)
        state, Tcw = sys_.track_monocular(reloc_frame, timestamp=1.0)
        assert state == TrackingState.OK
        # Pose close to the ground-truth pose at frame 10 (same scale as the
        # map, so compare against the tracked estimate from the first pass).
        est10 = [T for (ts, fid, T) in sys_.tracker.frame_trajectory() if fid == 10][0]
        # Rotation should agree tightly.
        dR = Tcw[:3, :3] @ est10[:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 0.05, ang
        assert np.linalg.norm(Tcw[:3, 3] - est10[:3, 3]) < 0.2
