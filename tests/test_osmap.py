"""Osmap persistence tests: wire-format roundtrip, delimited features
layout, and full save -> load -> relocalize resume."""
import numpy as np
import pytest

from os1_tpu.geometry.camera import Camera
from os1_tpu.features.orb import OrbConfig
from os1_tpu.io import osmap_io, synthetic
from os1_tpu.map.store import MapConfig, MapStore
from os1_tpu.pipeline import System, SlamConfig, TrackingState

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])


def make_system():
    cam = Camera.make(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=W, height=H)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
        map=MapConfig(max_keyframes=64, max_points=8192, n_features=512),
    )
    return System(cfg=cfg)


@pytest.fixture(scope="module")
def mapped_system():
    sys_ = make_system()
    scene = synthetic.default_scene(seed=3)
    poses = synthetic.orbit_trajectory(30, advance=0.08)
    frames = [synthetic.render(scene, T, K, H, W) for T in poses]
    for i, f in enumerate(frames):
        sys_.track_monocular(f, timestamp=i / 30.0)
    assert sys_.state == TrackingState.OK
    return sys_, scene, poses, frames


class TestRoundtrip:
    def test_save_load_identical(self, mapped_system, tmp_path):
        sys_, scene, poses, frames = mapped_system
        base = str(tmp_path / "testmap")
        header = sys_.save_map(base)
        assert header["nKeyframes"] == sys_.store.n_keyframes()
        assert header["nMappoints"] == sys_.store.n_points()

        st2 = MapStore(sys_.cfg.map)
        osmap_io.load_map(st2, sys_.cfg, base)
        st1 = sys_.store
        assert st2.n_keyframes() == st1.n_keyframes()
        assert st2.n_points() == st1.n_points()
        live = np.nonzero(st1.kf_valid)[0]
        np.testing.assert_allclose(st2.kf_T[live], st1.kf_T[live], atol=1e-6)
        pts = np.nonzero(st1.pt_valid)[0]
        np.testing.assert_allclose(st2.pt_xyz[pts], st1.pt_xyz[pts], atol=1e-6)
        # Distinctive descriptors are RECOMPUTED by rebuild (as in the
        # reference) and median tie-breaks depend on observation order — so
        # check each is a descriptor of one of the point's observations.
        for p in pts[:50]:
            kfs = st2.pt_obs_kf[p][: st2.pt_n_obs[p]]
            fts = st2.pt_obs_feat[p][: st2.pt_n_obs[p]]
            obs_descs = st2.kf_desc[kfs, fts]
            assert (obs_descs == st2.pt_desc[p]).all(axis=1).any()
        # Observation structure reconstructed.
        np.testing.assert_array_equal(
            st2.kf_obs_point[live], st1.kf_obs_point[live]
        )
        # Derived state rebuilt (normals nonzero for observed points).
        assert (np.linalg.norm(st2.pt_normal[pts], axis=1) > 0.5).all()

    def test_delimited_features_layout(self, mapped_system, tmp_path):
        sys_, *_ = mapped_system
        base = str(tmp_path / "delim")
        sys_.save_map(base, options=osmap_io.FEATURES_FILE_DELIMITED)
        st2 = MapStore(sys_.cfg.map)
        osmap_io.load_map(st2, sys_.cfg, base)
        assert st2.n_keyframes() == sys_.store.n_keyframes()
        live = np.nonzero(sys_.store.kf_valid)[0]
        np.testing.assert_array_equal(
            st2.kf_obs_point[live], sys_.store.kf_obs_point[live]
        )

    def test_only_mappoint_features(self, mapped_system, tmp_path):
        sys_, *_ = mapped_system
        base = str(tmp_path / "small")
        h = sys_.save_map(base, options=osmap_io.ONLY_MAPPOINTS_FEATURES)
        import os

        full = str(tmp_path / "full")
        h2 = sys_.save_map(full)
        assert os.path.getsize(base + ".features") < os.path.getsize(full + ".features")
        assert h["nFeatures"] < h2["nFeatures"]


class TestResume:
    def test_load_and_relocalize(self, mapped_system, tmp_path):
        sys_, scene, poses, frames = mapped_system
        base = str(tmp_path / "resume")
        sys_.save_map(base)

        sys2 = make_system()
        sys2.load_map(base)
        assert sys2.state == TrackingState.LOST
        assert sys2.store.n_keyframes() == sys_.store.n_keyframes()
        # Feed a frame from the mapped region: must relocalize.
        state, Tcw = sys2.track_monocular(frames[12], timestamp=99.0)
        assert state == TrackingState.OK
        est12 = [T for (ts, fid, T) in sys_.tracker.frame_trajectory() if fid == 12][0]
        dR = Tcw[:3, :3] @ est12[:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 0.05
        assert np.linalg.norm(Tcw[:3, 3] - est12[:3, 3]) < 0.2


class TestMultiSession:
    def test_two_session_mapping(self, mapped_system, tmp_path):
        """Config-5 multi-session protocol: session B loads session A's map,
        relocalizes into it, CONTINUES MAPPING new territory, and saves the
        union; a third session loads B's save and relocalizes in the region
        only B mapped (the reference's Osmap-based multi-session story,
        Osmap.cpp:180-291 + LOST->relocalize resume)."""
        sys_a, scene, poses, frames = mapped_system
        n_kf_a = sys_a.store.n_keyframes()
        base_a = str(tmp_path / "session_a")
        sys_a.save_map(base_a)

        # Session B: resume A's map, track A's region, then extend into
        # frames A never saw (the trajectory continues past frame 30).
        more_poses = synthetic.orbit_trajectory(60, advance=0.08)[30:]
        more_frames = [synthetic.render(scene, T, K, H, W) for T in more_poses]
        sys_b = make_system()
        sys_b.load_map(base_a)
        state, _ = sys_b.track_monocular(frames[12], timestamp=50.0)
        assert state == TrackingState.OK
        n_ok = 0
        for j, f in enumerate(frames[13:] + more_frames):
            state, _ = sys_b.track_monocular(f, timestamp=51.0 + j / 30.0)
            n_ok += state == TrackingState.OK
        assert n_ok > 30
        assert sys_b.store.n_keyframes() > n_kf_a  # B extended A's map
        base_b = str(tmp_path / "session_b")
        sys_b.save_map(base_b)

        # Session C: load the union and relocalize in B's NEW region.
        sys_c = make_system()
        sys_c.load_map(base_b)
        assert sys_c.store.n_keyframes() == sys_b.store.n_keyframes()
        state, Tcw = sys_c.track_monocular(more_frames[20], timestamp=99.0)
        assert state == TrackingState.OK
