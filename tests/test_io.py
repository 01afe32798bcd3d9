"""I/O layer tests: reference-YAML config parsing (against the actual
reference calibration files), dataset loaders, video source semantics,
viewer rendering, CLI smoke run."""
import os

import numpy as np
import pytest

REF_YAML = "/root/reference/webcam.yaml"


class TestConfig:
    @pytest.mark.skipif(not os.path.exists(REF_YAML), reason="reference absent")
    def test_reads_reference_yaml(self):
        from os1_tpu.io.config import load_slam_config, config_fps

        cfg = load_slam_config(REF_YAML)
        assert abs(float(cfg.camera.fx) - 719.0) < 1e-3
        assert abs(float(cfg.camera.cx) - 319.5) < 1e-3
        d = np.asarray(cfg.camera.dist)
        assert abs(d[0] - 0.063870314171528386) < 1e-9
        assert abs(d[4] - 0.72288795670281047) < 1e-9  # k3 in slot 4
        assert cfg.orb.n_levels == 8
        assert cfg.orb.fast_hi == 20.0
        assert cfg.orb.n_features == 1024  # 1000 rounded up to tile size
        assert abs(config_fps(REF_YAML) - 30.0) < 1e-6

    @pytest.mark.skipif(not os.path.exists(REF_YAML), reason="reference absent")
    def test_resolution_rescale(self):
        from os1_tpu.io.config import load_slam_config

        cfg = load_slam_config(REF_YAML, width=1280, height=960)
        assert abs(float(cfg.camera.fx) - 719.0 * 2) < 1e-3
        assert abs(float(cfg.camera.cx) - 639.0) < 1e-3


class TestDatasets:
    def test_tum_layout(self, tmp_path, rng):
        import cv2

        d = tmp_path / "tum"
        (d / "rgb").mkdir(parents=True)
        lines = ["# comment"]
        for i in range(3):
            img = rng.integers(0, 255, (48, 64), np.uint8)
            cv2.imwrite(str(d / "rgb" / f"{i}.png"), img)
            lines.append(f"{1234.5 + i * 0.033:.4f} rgb/{i}.png")
        (d / "rgb.txt").write_text("\n".join(lines))
        from os1_tpu.io.datasets import tum_sequence, open_sequence

        frames = list(tum_sequence(str(d)))
        assert len(frames) == 3
        assert abs(frames[1][0] - 1234.533) < 1e-3
        assert frames[0][1].shape == (48, 64)
        assert len(list(open_sequence(str(d)))) == 3

    def test_euroc_layout(self, tmp_path, rng):
        import cv2

        d = tmp_path / "euroc" / "mav0" / "cam0" / "data"
        d.mkdir(parents=True)
        csv = ["#timestamp [ns],filename"]
        for i in range(2):
            img = rng.integers(0, 255, (32, 32), np.uint8)
            cv2.imwrite(str(d / f"{i}.png"), img)
            csv.append(f"{1403636579763555584 + i * 50000000},{i}.png")
        (d.parent / "data.csv").write_text("\n".join(csv))
        from os1_tpu.io.datasets import euroc_sequence

        frames = list(euroc_sequence(str(tmp_path / "euroc")))
        assert len(frames) == 2
        assert abs(frames[0][0] - 1403636579.763555584) < 1e-3

    def test_kitti_layout(self, tmp_path, rng):
        import cv2

        d = tmp_path / "kitti" / "image_0"
        d.mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(d / f"{i:06d}.png"), rng.integers(0, 255, (32, 32), np.uint8))
        (d.parent / "times.txt").write_text("0.0\n0.1\n")
        from os1_tpu.io.datasets import kitti_sequence

        frames = list(kitti_sequence(str(d.parent)))
        assert len(frames) == 2 and abs(frames[1][0] - 0.1) < 1e-9


class TestVideoSource:
    def test_lossless_video_mode(self, tmp_path, rng):
        import cv2

        path = str(tmp_path / "test.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
        for i in range(10):
            frame = np.full((48, 64, 3), i * 20, np.uint8)
            wr.write(frame)
        wr.release()
        from os1_tpu.io.video import VideoSource, StreamMode

        src = VideoSource(path, mode=StreamMode.VIDEO)
        frames = []
        while True:
            f = src.get_image(timeout=5.0)
            if f is None:
                break
            frames.append(f)
        src.stop()
        assert len(frames) == 10  # lossless: every frame delivered
        # Frames in order (monotonic brightness).
        means = [f.mean() for f in frames]
        assert all(b >= a - 1 for a, b in zip(means, means[1:]))

    def test_black_mode(self):
        from os1_tpu.io.video import VideoSource

        src = VideoSource(None, width=32, height=24)
        f = src.get_image(timeout=2.0)
        src.stop()
        assert f is not None and f.shape == (24, 32) and (f == 0).all()


class TestViz:
    def test_draw_frame(self, rng):
        from os1_tpu.viz import draw_frame

        img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
        xy = rng.uniform(10, 100, (20, 2)).astype(np.float32)
        out = draw_frame(img, xy, np.ones(20, bool), np.ones(20, bool),
                         "OK", 5, 100, 42)
        assert out.shape == (142, 160, 3) and out.dtype == np.uint8

    def test_draw_map(self):
        from os1_tpu.map.store import MapConfig, MapStore
        from os1_tpu.viz import draw_map

        st = MapStore(MapConfig(max_keyframes=4, max_points=64, n_features=8))
        k = st.add_keyframe(np.eye(4), np.zeros((8, 2)), np.zeros(8),
                            np.zeros(8, np.int32), np.zeros((8, 8), np.uint32),
                            np.ones(8, bool))
        p = st.alloc_points(10)
        st.pt_xyz[p] = np.random.default_rng(0).uniform(-1, 1, (10, 3)) + [0, 0, 4]
        out = draw_map(st, np.eye(4, dtype=np.float32), size=(160, 120))
        assert out.shape == (120, 160, 3)


class TestCLI:
    def test_synthetic_smoke(self, capsys):
        from os1_tpu.run_slam import main

        rc = main(["--synthetic", "--frames", "12", "--no-loop-closing"])
        assert rc == 0
        import json

        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["frames"] == 12
        assert out["final_state"] in ("OK", "NOT_INITIALIZED")


class TestFrameDrawer:
    def test_parity_drawer_states(self):
        """FrameDrawer draws all three states (init flow lines, per-point
        taxonomy colors, LOST overlay) and the mouse inspect reports a
        clicked map point (reference FrameDrawer.cc:52-313)."""
        from os1_tpu.geometry.camera import Camera
        from os1_tpu.features.orb import OrbConfig
        from os1_tpu.io import synthetic
        from os1_tpu.map.store import MapConfig
        from os1_tpu.pipeline import System, SlamConfig
        from os1_tpu.viz.frame_drawer import FrameDrawer

        H, W = 240, 320
        K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
        cam = Camera.make(fx=260, fy=260, cx=160, cy=120, width=W, height=H)
        cfg = SlamConfig(
            camera=cam, orb=OrbConfig(height=H, width=W, n_features=512,
                                      n_levels=4),
            map=MapConfig(max_keyframes=32, max_points=4096, n_features=512),
        )
        sys_ = System(cfg=cfg)
        fd = FrameDrawer(sys_)
        scene = synthetic.default_scene(seed=3)
        poses = synthetic.orbit_trajectory(14, advance=0.1)
        drew_init = False
        for i, T in enumerate(poses):
            img = synthetic.render(scene, T, K, H, W)
            state, _ = sys_.track_monocular(img, timestamp=i / 30.0)
            fd.update(img, state)
            out = fd.draw()
            assert out.shape == (H + 22, W, 3)
            if state.name == "NOT_INITIALIZED":
                drew_init = True
        assert drew_init  # the init-flow branch rendered at least once
        assert fd.n_tracked > 50  # taxonomy-colored tracked points drawn

        # Mouse inspect: click on a tracked keypoint -> a report.
        tr = sys_.tracker
        bound_feats = np.nonzero(tr.last.bind >= 0)[0]
        assert len(bound_feats)
        xy = np.asarray(tr.last.data.feats.xy)[bound_feats[0]]
        hits = fd.inspect(float(xy[0]), float(xy[1]), radius=1.0)
        assert hits and hits[0]["n_obs"] >= 1
        assert hits[0]["origen"] in ("normal", "umbralCosBajo",
                                     "umbralCos", "svdInf")

        # LOST overlay renders with the reloc-candidate count in the bar.
        from os1_tpu.pipeline.tracking import TrackingState

        fd._state_name = "LOST"
        out = fd.draw()
        assert out.shape == (H + 22, W, 3)
        sys_.shutdown()


@pytest.mark.parametrize("shape", [(48, 48, 512, 512), (7, 11, 100, 57), (100, 80, 37, 53)])
def test_resize_cubic_matches_cv2(shape):
    """The numpy bicubic that renders every synthetic texture reproduces
    cv2.resize(INTER_CUBIC) within 1e-3 gray levels, upscaling and down."""
    cv2 = pytest.importorskip("cv2")
    from os1_tpu.io.synthetic import resize_cubic

    hi, wi, h, w = shape
    base = np.random.default_rng(1).uniform(20, 235, (hi, wi)).astype(np.float32)
    ref = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    out = resize_cubic(base, h, w)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
