"""Benchmark: steady-state monocular SLAM on one accelerator card.

Runs the full pipeline (ORB extraction -> fused tracking -> keyframe events:
triangulation, fusion, Schur local BA -> loop closing) over a rendered
synthetic 640x480 sequence and reports the full metric triple of
BASELINE.json ("ATE RMSE; tracked frames/s/chip; local-BA iters/s") plus
frame-latency percentiles and a per-stage wall-time breakdown.

Protocol: the WHOLE sequence runs once as warmup (every device program,
including all BA bucket shapes hit on this trajectory, compiles there), the
system is reset, and the timed pass re-runs the identical sequence — so the
timed region measures steady state, not compilation.

Baseline: the reference's design target is real-time at camera fps
(30 fps, BASELINE.md "Live webcam operation"); vs_baseline = fps / 30.
North-star target is >= 5x real time per chip (BASELINE.json).

Prints exactly one JSON line on stdout (stage table goes to stderr).
"""
import json
import sys
import time

import numpy as np

N_FRAMES = 300
FPS_BASELINE = 30.0


def build_system(sync: bool = False, threaded: bool = False, **th_overrides):
    """The benchmark system.

    Default (the SHIPPED configuration): pipelined tracking + cooperative
    mapping — keyframe events advance as generator micro-steps between
    tracked frames, the device overlapping mapping stages with tracking.
    Deterministic: two runs produce bit-identical trajectories (the
    reference's seeded-replay property, src/Video.cpp:60-73 +
    Initializer.cc:80, preserved at full speed).

    sync=True: inline mapping, no frame pipelining (the strictest rig —
    every stage completes before the next frame; see accuracy.py).
    threaded=True: the reference's worker-thread topology instead of the
    cooperative scheduler (scheduler-dependent timing; parity mode).
    th_overrides patch TrackingThresholds fields (A/B experiments)."""
    from os1_tpu.features.orb import OrbConfig
    from os1_tpu.geometry.camera import Camera
    from os1_tpu.map.store import MapConfig
    from os1_tpu.pipeline import System, SlamConfig
    from os1_tpu.pipeline.config import TrackingThresholds

    H, W = 480, 640
    cam = Camera.make(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=W, height=H)
    th = TrackingThresholds(**th_overrides) if th_overrides else TrackingThresholds()
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(height=H, width=W, n_features=1024, n_levels=8),
        map=MapConfig(max_keyframes=128, max_points=16384, n_features=1024),
        th=th,
    )
    return System(
        cfg=cfg,
        pipelined=not sync,
        async_mapping=threaded,
        coop_mapping=not sync and not threaded,
    )


def orbit_frames(n_frames: int = N_FRAMES):
    """The benchmark's rendered orbit sequence (cached, see
    synthetic.render_sequence) + ground truth."""
    from os1_tpu.io import synthetic

    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    scene = synthetic.default_scene(seed=1)
    poses = synthetic.orbit_trajectory(n_frames, advance=0.05)
    frames = synthetic.render_sequence(scene, poses, K, 480, 640)
    return frames, poses


def loop_frames(n_frames: int = N_FRAMES):
    """The loop-closure sequence: camera circling inside a textured room,
    revisiting its start (synthetic.room_scene + loop_trajectory)."""
    from os1_tpu.io import synthetic

    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    scene = synthetic.room_scene(seed=3)
    poses = synthetic.loop_trajectory(n_frames)
    frames = synthetic.render_sequence(scene, poses, K, 480, 640)
    return frames, poses


def photo_frames(n_frames: int = N_FRAMES):
    """REAL-imagery sequence: a room whose walls are real photographs
    (io/realimg.py — natural texture/edge statistics from actual camera
    images; zero-egress substitute for TUM footage) on the loop circuit.
    Exercises FAST thresholds, the BRIEF pattern, matcher gates and the
    vocabulary against real-world descriptor distributions with exact
    ground truth. Returns (None, None) if no photos are bundled."""
    from os1_tpu.io import realimg, synthetic

    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    scene = realimg.photo_room_scene()
    poses = synthetic.loop_trajectory(n_frames)
    frames = synthetic.render_sequence(scene, poses, K, 480, 640)
    return frames, poses


def run_sequence(sys_, frames):
    """Track every frame; returns (wall dt, per-frame latencies, ok fraction
    over post-initialization frames). Monocular SLAM cannot track before the
    two-view bootstrap completes (frames 0..~3 are NOT_INITIALIZED by
    construction, Tracking.cc:344-419), so the ok fraction denominator
    starts at the first OK frame — a mid-run tracking loss lowers it, the
    unavoidable init window does not."""
    from os1_tpu.pipeline import TrackingState

    lat = np.zeros(len(frames))
    states = []
    t0 = time.time()
    for i, img in enumerate(frames):
        f0 = time.perf_counter()
        state, _ = sys_.track_monocular(img, timestamp=i / FPS_BASELINE)
        lat[i] = time.perf_counter() - f0
        states.append(state)
    sys_.flush()  # drain the pipelined in-flight frame
    dt = time.time() - t0
    ok = np.array([s == TrackingState.OK for s in states])
    first = int(np.argmax(ok)) if ok.any() else len(ok)
    ok_fraction = float(ok[first:].mean()) if first < len(ok) else 0.0
    return dt, lat, ok_fraction


# Accuracy gates. The orbit path is ~15 units: 0.5% of path mirrors
# ORB-SLAM2-class ATE on fr1/desk-scale trajectories (BASELINE.md) and is
# the bound round-2/3 VERDICTs prescribed. The async bench must hold 2x the
# deterministic sync-mode bound (accuracy.py measures that one).
GATE_ATE_ORBIT = 0.2  # ~2x the deterministic sync-mode ATE (accuracy.py: 0.097)
GATE_ATE_LOOP = 0.22  # 2% of the ~10.9-unit loop path (pre-GBA convergence)
GATE_OK_FRACTION = 1.0
GATE_MIN_LOOPS = 1
# Real-imagery circuit (photo-textured room): repetitive mirror-tiled
# photo walls are harder than the synthetic scenes (ratio-test ambiguity,
# one mid-run excursion into unmapped territory while LOST) — gates lock in
# the demonstrated level: a closed loop, ATE ~2.3% of the 10.9-unit path,
# and >= 70% tracked after the (slow, ~17-frame) real-texture bootstrap.
GATE_ATE_PHOTO = 0.25
GATE_OK_PHOTO = 0.70
GATE_MIN_LOOPS_PHOTO = 1


def _traj_ate(sys_, poses):
    from os1_tpu.io import synthetic

    traj = sys_.frame_trajectory()
    est = [T for (_, fid, T) in traj]
    gt = [poses[fid] for (_, fid, _) in traj]
    return synthetic.ate_rmse(est, gt) if len(est) >= 10 else float("nan")


def main():
    import jax

    # uint8 frames: what a camera delivers, and a quarter of the float32
    # upload (the frame builder converts on device).
    frames, poses = orbit_frames()

    # Warmup: explicit compile of every device program + bucket shape, then
    # one full pass for anything data-dependent.
    sys_ = build_system()
    warm_s = sys_.warmup()
    run_sequence(sys_, frames)
    sys_.shutdown()

    # Timed pass on a fresh system: identical shapes, zero compiles.
    sys_ = build_system()
    dt, lat, ok_frac = run_sequence(sys_, frames)
    fps = len(frames) / dt

    # ---- metric triple ----
    # ATE RMSE vs the rendered ground truth (Sim3-aligned, monocular).
    ate = _traj_ate(sys_, poses)

    # Local-BA iters/s: LM iterations executed / local-BA wall time (the
    # dispatch + fetch + apply stage sections; the device-overlap intervals
    # between them belong to tracking, not BA).
    ba_wall = sum(
        sys_.timer.totals.get(k, 0.0)
        for k in ("lm.ba.assemble", "lm.ba.dispatch", "lm.ba.fetch",
                  "lm.local_ba")
    )
    ba_iters_s = sys_.mapper.ba_iters / ba_wall if ba_wall > 0 else 0.0

    stage_ms = {
        name: round(tot / max(sys_.timer.counts[name], 1) * 1e3, 2)
        for name, tot in sorted(sys_.timer.totals.items(), key=lambda kv: -kv[1])
    }
    print(sys_.timer.report(), file=sys.stderr)
    sys_.shutdown()

    # ---- loop-closure sequence (room scene, closed circuit) ----
    # The reference's defining steady-state behavior (LoopClosing.cc:407-592)
    # exercised at bench scale under real async timing: detect -> Sim3 ->
    # correct -> essential graph -> GBA must fire at least once.
    lframes, lposes = loop_frames()
    lsys = build_system()
    run_sequence(lsys, lframes)  # warmup pass (loop-path programs compile here)
    lsys.shutdown()
    lsys = build_system()
    ldt, _, l_ok_frac = run_sequence(lsys, lframes)
    lsys.flush()
    ate_loop = _traj_ate(lsys, lposes)
    n_loops = lsys.loop_closer.n_loops_closed
    lsys.shutdown()

    # ---- REAL-imagery sequence (photo-textured room, same circuit) ----
    # Config 2's spirit (BASELINE.json: ATE on real footage) in a
    # zero-egress environment: real photographs as scene textures exercise
    # the extractor/matcher/vocabulary against real descriptor statistics
    # with exact ground truth (io/realimg.py).
    pframes, pposes = photo_frames()
    psys = build_system()
    run_sequence(psys, pframes)  # warmup pass
    psys.shutdown()
    psys = build_system()
    pdt, _, p_ok_frac = run_sequence(psys, pframes)
    psys.flush()
    ate_photo = _traj_ate(psys, pposes)
    photo = {
        "ate_rmse": round(ate_photo, 5),
        "n_loops_closed": psys.loop_closer.n_loops_closed,
        "fps": round(len(pframes) / pdt, 2),
        "ok_fraction": round(p_ok_frac, 3),
        "loss_events": [[int(f), r] for f, r in psys.tracker.loss_log],
    }
    psys.shutdown()

    gates = {
        "ate_orbit": [round(ate, 5), GATE_ATE_ORBIT, bool(ate <= GATE_ATE_ORBIT)],
        "ok_fraction": [round(ok_frac, 3), GATE_OK_FRACTION,
                        bool(ok_frac >= GATE_OK_FRACTION)],
        "ate_loop": [round(ate_loop, 5), GATE_ATE_LOOP,
                     bool(ate_loop <= GATE_ATE_LOOP)],
        "n_loops_closed": [n_loops, GATE_MIN_LOOPS, bool(n_loops >= GATE_MIN_LOOPS)],
    }
    gates["ate_photo"] = [photo["ate_rmse"], GATE_ATE_PHOTO,
                          bool(photo["ate_rmse"] <= GATE_ATE_PHOTO)]
    gates["ok_photo"] = [photo["ok_fraction"], GATE_OK_PHOTO,
                         bool(photo["ok_fraction"] >= GATE_OK_PHOTO)]
    gates["n_loops_photo"] = [photo["n_loops_closed"], GATE_MIN_LOOPS_PHOTO,
                              bool(photo["n_loops_closed"]
                                   >= GATE_MIN_LOOPS_PHOTO)]
    failures = [k for k, (_, _, ok) in gates.items() if not ok]

    print(
        json.dumps(
            {
                "metric": "tracked_frames_per_s_per_chip",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / FPS_BASELINE, 3),
                "detail": {
                    "ate_rmse": round(ate, 5),
                    "local_ba_iters_per_s": round(ba_iters_s, 1),
                    "frame_latency_ms_p50": round(float(np.percentile(lat, 50)) * 1e3, 2),
                    "frame_latency_ms_p99": round(float(np.percentile(lat, 99)) * 1e3, 2),
                    "frames_timed": len(frames),
                    "ok_fraction": round(ok_frac, 3),
                    "n_keyframes": sys_.store.n_keyframes(),
                    "n_points": sys_.store.n_points(),
                    # Every tracking-loss event with its reason (frame id,
                    # cause) — ok_fraction failures must be attributable.
                    "loss_events": [
                        [int(f), r] for f, r in sys_.tracker.loss_log
                    ],
                    "loop_seq": {
                        "ate_rmse": round(ate_loop, 5),
                        "n_loops_closed": n_loops,
                        "fps": round(len(lframes) / ldt, 2),
                        "ok_fraction": round(l_ok_frac, 3),
                        "loss_events": [
                            [int(f), r] for f, r in lsys.tracker.loss_log
                        ],
                    },
                    "photo_seq": photo,
                    "gates": gates,
                    "gate_failures": failures,
                    "stage_ms_per_call": stage_ms,
                    "platform": str(jax.devices()[0]),
                },
            }
        )
    )
    if failures:
        print(f"ACCURACY GATES FAILED: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
