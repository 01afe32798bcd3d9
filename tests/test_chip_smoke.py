"""chip_smoke.py off the card: it must refuse a CPU backend, and its
comparison helpers must pass when both sides are CPU devices."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_device_phase_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs 1 NVIDIA GPU" in out.stderr


def _fused_inputs(sys_):
    """The fused step's arguments for a fresh (empty) map, as System.warmup
    builds them."""
    cfg = sys_.cfg
    frame = sys_.tracker._build(
        jnp.zeros((cfg.orb.height, cfg.orb.width), jnp.uint8), cfg.camera)
    mir, n, L = sys_.mirror, cfg.orb.n_features, cfg.th.max_local_points
    eye = jnp.eye(4)
    return (
        mir.pt_xyz, mir.pt_desc, mir.pt_valid, mir.pt_normal,
        mir.pt_min_dist, mir.pt_max_dist,
        mir.kf_desc, mir.kf_angle, mir.kf_obs_point,
        frame, cfg.camera, jnp.asarray(cfg.intr),
        eye, eye, jnp.full(n, -1, jnp.int32), frame.feats.octave,
        jnp.int32(0), jnp.bool_(False),
        jnp.zeros(L, jnp.int32), jnp.zeros(L, bool), jnp.bool_(False),
    )


def test_comparison_helpers_pass_cpu_against_cpu():
    import chip_smoke as cs
    from os1_tpu.features.orb import OrbConfig
    from os1_tpu.geometry.camera import Camera
    from os1_tpu.io import synthetic
    from os1_tpu.map.store import MapConfig
    from os1_tpu.pipeline import SlamConfig, System, tracking_fused
    from os1_tpu.pipeline.config import TrackingThresholds

    a, b = jax.devices("cpu")[:2]
    cs.check_hamming(37, 300, a)

    H, W = 96, 128
    K = np.array([[100.0, 0, 64.0], [0, 100.0, 48.0], [0, 0, 1.0]])
    cam = Camera.make(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=W, height=H)
    orb = OrbConfig(height=H, width=W, n_features=128, n_levels=3)
    img = np.clip(synthetic.render(synthetic.default_scene(seed=1), np.eye(4),
                                   K, H, W), 0, 255).astype(np.uint8)
    frame = cs.compare_extractor(orb, cam, img, a, b)
    cs.check_host_pack(frame, a)

    cfg = SlamConfig(camera=cam, orb=orb,
                     map=MapConfig(max_keyframes=8, max_points=256,
                                   n_features=128),
                     th=TrackingThresholds(max_local_points=256))
    sys_ = System(cfg=cfg, distributed=False)
    cs.compare_fused(tracking_fused.make_fused_tracker(cfg),
                     _fused_inputs(sys_), 128, 256, a, b)

    cs.compare_ba(cs.ba_problem(8, 256, 4), a, b)
    cs.check_geometry(a, b, n=64)
    cs.compare_pose_graph(cs.pose_graph_case(16, 64), a, b, iters=3)

    rng = np.random.default_rng(0)
    for k in range(6):
        d = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
        sys_.db.add(k, sys_.db.compute_bow(d, np.ones(300, bool))[2])
    cs.compare_dist_database(sys_.db, Mesh(np.array([a, b]), ("kfs",)),
                             max_words=300)
