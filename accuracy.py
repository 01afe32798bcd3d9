"""Deterministic accuracy rig: sync-mode bench-scale ATE with repeatability.

The reference is deterministic by construction — seeded RANSAC
(DUtils::Random::SeedRandOnce(0), src/Initializer.cc:80) plus video-file
replay (src/Video.cpp:60-73) is its de-facto regression mechanism. This tool
is that rig for this build: run the FULL bench sequence with inline
(synchronous) mapping and fixed PRNG keys, where two runs must produce
bit-identical trajectories, so a single run is a trustworthy accuracy
measurement and any delta IS the code change.

Usage:
  python accuracy.py                      # sync orbit, 300 frames, 1 run
  python accuracy.py --runs 2             # + determinism check
  python accuracy.py --async --runs 3     # async (bench timing) spread
  python accuracy.py --seq loop           # loop-closure sequence
  python accuracy.py --pose-ref           # reference 4x10-LM pose schedule
  python accuracy.py --debt 0             # pure drain gating (no BA debt)
  python accuracy.py --frames 150         # shorter sequence
"""
import argparse
import hashlib
import json
import sys

import numpy as np


def _force_cpu():
    """Through jax.config, which still applies after jax is imported (an
    env var read at import would not)."""
    import jax

    jax.config.update("jax_platforms", "cpu")

from bench import (
    FPS_BASELINE, N_FRAMES, build_system, loop_frames, orbit_frames,
    photo_frames,
)


def run_once(frames, poses, sync, th_overrides, threaded=False,
             log_lost=True):
    from os1_tpu.io import synthetic
    from os1_tpu.pipeline import TrackingState

    sys_ = build_system(sync=sync, threaded=threaded, **th_overrides)
    sys_.warmup()
    states = []
    for i, img in enumerate(frames):
        state, _ = sys_.track_monocular(img, timestamp=i / FPS_BASELINE)
        states.append(state)
    sys_.flush()

    traj = sys_.frame_trajectory()
    est = [T for (_, fid, T) in traj]
    gt = [poses[fid] for (_, fid, _) in traj]
    ate = synthetic.ate_rmse(est, gt) if len(est) >= 10 else float("nan")
    lost = [i for i, s in enumerate(states) if s != TrackingState.OK]
    if log_lost and sys_.tracker.loss_log:
        print("   loss events:", sys_.tracker.loss_log[:12])
    digest = hashlib.sha256(
        np.ascontiguousarray(np.stack(est)).tobytes()
    ).hexdigest()[:16]
    out = dict(
        ate=ate,
        n_tracked=len(est),
        n_lost=len(lost),
        lost=lost[:40],
        n_keyframes=sys_.store.n_keyframes(),
        n_points=sys_.store.n_points(),
        n_loops=sys_.loop_closer.n_loops_closed,
        traj_sha=digest,
    )
    sys_.shutdown()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--seq", choices=("orbit", "loop", "photo"),
                    default="orbit")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="bench configuration (pipelined + cooperative "
                         "mapping) — deterministic, like sync")
    ap.add_argument("--threaded", action="store_true",
                    help="worker-thread topology (scheduler-dependent; "
                         "implies --async)")
    ap.add_argument("--pose-ref", action="store_true",
                    help="reference 4x10-LM pose-opt schedule w/ reclassify")
    ap.add_argument("--debt", type=int, default=None,
                    help="ba_debt_max override (0 = pure drain gating)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VAL", help="TrackingThresholds override")
    ap.add_argument("--cpu", action="store_true",
                    help="run on host CPU (frees the card; relative A/B only)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="per-frame Gaussian photometric noise sigma (gray "
                         "levels); distinct --noise-seed values estimate the "
                         "ATE spread across feature realizations")
    ap.add_argument("--noise-seed", type=int, default=0)
    args = ap.parse_args()
    if args.cpu:
        _force_cpu()

    th = {}
    if args.pose_ref:
        th.update(pose_opt_rounds=4, pose_opt_iters=10, pose_opt_reject=True)
    if args.debt is not None:
        th.update(ba_debt_max=args.debt)
    for kv in args.set:
        k, v = kv.split("=", 1)
        th[k] = json.loads(v)

    frames, poses = {
        "orbit": orbit_frames, "loop": loop_frames, "photo": photo_frames,
    }[args.seq](args.frames)
    if args.noise > 0.0:
        rng = np.random.default_rng(args.noise_seed)
        frames = np.clip(
            frames.astype(np.float32)
            + rng.normal(0.0, args.noise, frames.shape).astype(np.float32),
            0, 255,
        ).astype(np.uint8)
    path_len = sum(
        float(np.linalg.norm(
            (-poses[i + 1][:3, :3].T @ poses[i + 1][:3, 3])
            - (-poses[i][:3, :3].T @ poses[i][:3, 3])
        ))
        for i in range(len(poses) - 1)
    )

    if args.threaded:
        args.async_ = True
    results = []
    for r in range(args.runs):
        out = run_once(frames, poses, sync=not args.async_, th_overrides=th,
                       threaded=args.threaded)
        results.append(out)
        print(
            f"run {r}: ATE {out['ate']:.4f} ({out['ate'] / path_len * 100:.2f}% "
            f"of {path_len:.1f}-unit path)  tracked {out['n_tracked']}/"
            f"{len(frames)}  lost {out['lost'] if out['n_lost'] else '[]'}  "
            f"KFs {out['n_keyframes']}  pts {out['n_points']}  "
            f"loops {out['n_loops']}  sha {out['traj_sha']}",
            flush=True,
        )

    if args.runs > 1:
        shas = {o["traj_sha"] for o in results}
        ates = [o["ate"] for o in results]
        mode = ("threaded" if args.threaded
                else "coop" if args.async_ else "sync")
        print(f"{mode}: {len(shas)} distinct trajectories over {args.runs} runs; "
              f"ATE spread [{min(ates):.4f}, {max(ates):.4f}]")
        # Sync AND coop are deterministic by construction; only the
        # worker-thread topology is scheduler-dependent.
        if not args.threaded and len(shas) != 1:
            print(f"DETERMINISM VIOLATION: {mode} runs differ", file=sys.stderr)
            sys.exit(1)


if __name__ == "__main__":
    main()
