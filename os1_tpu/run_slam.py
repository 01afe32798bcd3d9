"""CLI entry point — the reference's main.cc re-imagined:

    python -m os1_tpu.run_slam [settings.yaml] [sequence] [options]

sequence may be a video file, a TUM/EuRoC/KITTI dataset directory, an image
directory, a webcam index, or ``--synthetic`` for the built-in rendered
scene. Runs the full SLAM pipeline, optionally with a live viewer or
snapshot dumps, and exports trajectories / the map on exit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="os1_tpu.run_slam",
        description="Monocular SLAM in JAX (capability parity with os1)",
    )
    p.add_argument("settings", nargs="?", default=None,
                   help="calibration YAML (reference webcam.yaml schema)")
    p.add_argument("sequence", nargs="?", default=None,
                   help="video file / dataset dir / webcam index")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the built-in synthetic scene")
    p.add_argument("--frames", type=int, default=0, help="max frames (0 = all)")
    p.add_argument("--save-map", default=None, help="save Osmap map to base path")
    p.add_argument("--load-map", default=None, help="load Osmap map before start")
    p.add_argument("--save-trajectory", default=None,
                   help="write TUM keyframe trajectory")
    p.add_argument("--localization", action="store_true",
                   help="localization-only mode (frozen map)")
    p.add_argument("--no-loop-closing", action="store_true")
    p.add_argument("--viewer", action="store_true", help="live viewer windows")
    p.add_argument("--sync", action="store_true",
                   help="synchronous single-thread pipeline (deterministic; "
                        "default is the pipelined tracker + mapping/loop "
                        "worker threads, as the reference runs)")
    p.add_argument("--snapshots", default=None, help="snapshot directory")
    p.add_argument("--warmup", action="store_true",
                   help="compile every pipeline program into the persistent "
                        "XLA cache ($JAX_COMPILATION_CACHE_DIR, else .jax_cache "
                        "in the checkout) and exit; later runs reuse it")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .pipeline import System, SlamConfig, TrackingState

    gt_poses = None
    if args.synthetic or (args.settings is None and args.sequence is None):
        from .features.orb import OrbConfig
        from .geometry.camera import Camera
        from .io import synthetic
        from .map.store import MapConfig

        H, W = 480, 640
        K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
        cfg = SlamConfig(
            camera=Camera.make(fx=400.0, fy=400.0, cx=320.0, cy=240.0,
                               width=W, height=H),
            orb=OrbConfig(height=H, width=W),
            map=MapConfig(max_keyframes=128, max_points=16384, n_features=1024),
        )
        scene = synthetic.default_scene(seed=1)
        n = args.frames or 120
        gt_poses = synthetic.orbit_trajectory(n, advance=0.04)
        seq = ((i / 30.0, synthetic.render(scene, T, K, H, W))
               for i, T in enumerate(gt_poses))
    else:
        from .io.config import load_slam_config
        from .io.datasets import open_sequence

        cfg = load_slam_config(args.settings)
        if args.sequence is None and not args.warmup:
            # --warmup needs only the config (it builds the System and
            # compiles every device program); a sequence is required for
            # actual tracking.
            print("no sequence given", file=sys.stderr)
            return 2
        if args.sequence is None:
            seq = iter(())  # --warmup: no frames to track
        elif args.sequence.isdigit() or args.sequence.endswith(
            (".mp4", ".avi", ".mkv", ".mov", ".webm")
        ):
            # Webcam or video file through the VideoSource thread — the
            # viewer's pause/reverse/seek controls drive it live
            # (Video.cpp:60-73,154-159; Viewer trackbar Viewer.cc:128).
            from .io.video import VideoSource

            video_src = VideoSource(
                int(args.sequence) if args.sequence.isdigit() else args.sequence
            )

            def cam_seq():
                t0 = time.time()
                while True:
                    f = video_src.get_image()
                    if f is None:
                        return
                    yield time.time() - t0, f

            seq = cam_seq()
        else:
            seq = open_sequence(args.sequence)

    sys_ = System(
        cfg=cfg, enable_loop_closing=not args.no_loop_closing,
        pipelined=not args.sync, async_mapping=not args.sync,
    )
    if args.warmup:
        warm_s = sys_.warmup()
        sys_.shutdown()
        print(f"warmup: {warm_s:.1f}s — persistent cache populated; "
              f"cold start on this machine is now cache-replay")
        return 0
    if args.load_map:
        sys_.load_map(args.load_map)
    if args.localization:
        sys_.activate_localization_mode()

    from .viz.viewer import Viewer

    viewer = Viewer(sys_, live=args.viewer, snapshot_dir=args.snapshots,
                    video_source=locals().get("video_src"))

    n_frames = 0
    n_ok = 0
    t_start = time.time()
    est, gt = [], []
    for ts, img in seq:
        state, Tcw = sys_.track_monocular(img, timestamp=ts)
        viewer.update(img, state, Tcw)
        n_frames += 1
        if state == TrackingState.OK:
            n_ok += 1
            if gt_poses is not None and Tcw is not None:
                est.append(Tcw)
                gt.append(gt_poses[n_frames - 1])
        if args.frames and n_frames >= args.frames:
            break
        if viewer.quit_requested:
            break
    wall = time.time() - t_start
    viewer.close()
    sys_.flush()  # drain the in-flight frame + keyframe queues

    if args.save_trajectory:
        sys_.save_keyframe_trajectory_tum(args.save_trajectory)
    if args.save_map:
        sys_.save_map(args.save_map)

    summary = {
        "frames": n_frames,
        "tracked_fraction": round(n_ok / max(n_frames, 1), 3),
        "fps": round(n_frames / max(wall, 1e-9), 2),
        "keyframes": sys_.store.n_keyframes(),
        "map_points": sys_.store.n_points(),
        "loops_closed": sys_.loop_closer.n_loops_closed,
        "final_state": sys_.state.name,
    }
    if est:
        from .io.synthetic import ate_rmse

        summary["ate_rmse_vs_groundtruth"] = round(ate_rmse(est, gt), 5)
    print(json.dumps(summary))
    sys_.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
