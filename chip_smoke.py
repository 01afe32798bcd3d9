"""Bring-up smoke test of the SLAM main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: device, kernels, main path
    python chip_smoke.py --four-cards  # four cards: the sharded back-end only

One process drives every card: a JAX process reserves most of a card's
memory, so a second one on the same card fails. Phases run in order and
print their results, each with its tolerance, on lines of their own. Any
failed check raises, which exits non-zero before the result line is printed.
A passing run ends with one JSON line:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

References are numpy, or the same jitted function with its inputs placed on
jax.devices("cpu") in this process. Frames and problems are made from fixed
seeds (bench.py renders the sequences).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


class SmokeFailure(AssertionError):
    pass


def log(*parts):
    print(*parts, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def on(dev, fn, *args):
    """Run fn on ``dev``: inputs committed there, new arrays created there."""
    with jax.default_device(dev):
        return jax.block_until_ready(fn(*jax.device_put(args, dev)))


@contextlib.contextmanager
def no_cache_writes():
    """Compile without storing entries in the persistent cache. CPU
    references run under it: an XLA CPU entry is built for this host's CPU
    features and can crash (SIGILL) a process on another host that loads it
    from a shared cache directory."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, old)


# --------------------------------------------------------------------- #
# Device
# --------------------------------------------------------------------- #
def device_phase(n_cards: int) -> str:
    """Refuse anything but ``n_cards`` NVIDIA GPUs; print what was found.
    Returns the card's nvidia-smi name and power limit."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        sys.exit(
            f"chip_smoke: needs {n_cards} NVIDIA GPU(s); JAX found "
            f"{len(devs)} {devs[0].platform} device(s)"
        )
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    # nvidia-smi from a child that does not import JAX.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    for line in smi:
        log(f"nvidia-smi: {line}")
    import os1_tpu  # noqa: F401  (enables the compile cache, f32 matmuls)
    from os1_tpu import native

    log(f"jax {jax.__version__}; compile cache "
        f"{jax.config.jax_compilation_cache_dir}; default matmul precision "
        f"{jax.config.jax_default_matmul_precision}")
    found = {}
    for mod in ("cv2", "yaml", "google.protobuf"):
        try:
            importlib.import_module(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    log(f"optional packages importable: {found}; native library "
        f"available: {native.available()}")
    return smi[0]


# --------------------------------------------------------------------- #
# Kernels against their references
# --------------------------------------------------------------------- #
_POP8 = np.array([bin(v).count("1") for v in range(256)], np.int32)


def np_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy XOR+popcount distance table of packed [N, 8] x [M, 8] uint32."""
    out = np.zeros((len(a), len(b)), np.int32)
    for w in range(a.shape[1]):
        x = np.bitwise_xor(a[:, None, w], b[None, :, w])
        out += _POP8[x.view(np.uint8)].reshape(x.shape + (4,)).sum(-1)
    return out


def check_hamming(n: int, m: int, dev, seed: int = 0):
    from os1_tpu.matching import core

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    got = np.asarray(on(dev, jax.jit(core.distance_matrix), a, b))
    exact = np.array_equal(got, np_hamming(a, b))
    log(f"hamming distance_matrix {n}x{m}: "
        f"{'equal' if exact else 'DIFFERS'} to numpy XOR+popcount "
        f"(tolerance: exact, int32)")
    check(exact, f"Hamming table {n}x{m} differs from numpy")


def _keypoints(frame) -> dict:
    valid = np.asarray(frame.feats.valid)
    xy = np.asarray(frame.feats.xy)[valid]
    octave = np.asarray(frame.feats.octave)[valid]
    desc = np.asarray(frame.feats.desc)[valid]
    return {(float(x), float(y), int(o)): d
            for (x, y), o, d in zip(xy, octave, desc)}


def compare_extractor(orb_cfg, cam, img, dev, ref, min_agree: float = 0.99):
    """Frame builder on dev and ref. Keypoints must agree in (x, y, octave),
    and the descriptor bits of the shared keypoints must agree, each at
    ``min_agree``. Returns the dev frame."""
    from os1_tpu.pipeline.frame import make_frame_builder

    build = make_frame_builder(orb_cfg)
    got = on(dev, build, img, cam)
    with no_cache_writes():
        want = on(ref, build, img, cam)
    kg, kr = _keypoints(got), _keypoints(want)
    shared = kg.keys() & kr.keys()
    kp_agree = len(shared) / max(len(kg), len(kr), 1)
    diff_bits = sum(int(_POP8[(kg[k] ^ kr[k]).view(np.uint8)].sum())
                    for k in shared)
    bit_agree = 1.0 - diff_bits / max(256 * len(shared), 1)
    log(f"extractor {orb_cfg.width}x{orb_cfg.height}, {orb_cfg.n_features} "
        f"features, {orb_cfg.n_levels} levels: {len(kg)} vs {len(kr)} "
        f"keypoints, {kp_agree:.6f} identical in (x, y, octave); descriptor "
        f"bits equal {bit_agree:.6f} (tolerance: >= {min_agree} each)")
    check(kp_agree >= min_agree, f"keypoint agreement {kp_agree}")
    check(bit_agree >= min_agree, f"descriptor bit agreement {bit_agree}")
    return got


@jax.jit
def _bitcast_pack(desc):
    """The frame builder's descriptor packing (pipeline/frame.py)."""
    return jnp.concatenate(
        [jnp.zeros((desc.shape[0], 5), jnp.float32),
         jax.lax.bitcast_convert_type(desc, jnp.float32)], axis=1,
    )


def check_host_pack(frame, dev):
    """Descriptors ride the host pack as uint32 bits in float32 lanes: NaN
    and subnormal patterns must come back unchanged."""
    from os1_tpu.pipeline.frame import unpack_host

    desc = np.asarray(frame.feats.desc)
    back = unpack_host(np.asarray(frame.host_pack))[3]
    as_f = desc.view(np.float32)
    n_nan = int(np.isnan(as_f).sum())
    n_sub = int(((as_f != 0) & (np.abs(as_f) < np.finfo(np.float32).tiny)).sum())
    special = np.array(
        [0x7FC00001, 0x7F800001, 0xFFC00000, 0x7F800000, 0x00000001,
         0x807FFFFF, 0x80000000, 0xFFFFFFFF], np.uint32,
    ).reshape(1, 8).repeat(4, axis=0)
    special_back = unpack_host(np.asarray(on(dev, _bitcast_pack, special)))[3]
    ok = np.array_equal(back, desc) and np.array_equal(special_back, special)
    log(f"host pack round trip: {'bit-identical' if ok else 'CHANGED'} "
        f"({desc.size} words, {n_nan} NaN and {n_sub} subnormal patterns, "
        f"plus 8 crafted NaN/inf/subnormal words; tolerance: bit-exact)")
    check(ok, "host pack changed descriptor bits")


def compare_fused(step, args, n_feat: int, n_local: int, dev, ref,
                  tol: float = 1e-4, inlier_frac: float = 0.01):
    """One fused tracker step on dev and ref with the same inputs."""
    from os1_tpu.pipeline.tracking_fused import unpack_result

    got = unpack_result(on(dev, step, *args)["packed"], n_feat, n_local)
    with no_cache_writes():
        want = unpack_result(on(ref, step, *args)["packed"], n_feat, n_local)
    dt = float(np.abs(got["Tcw"][:3, 3] - want["Tcw"][:3, 3]).max())
    dr = float(np.abs(got["Tcw"][:3, :3] - want["Tcw"][:3, :3]).max())
    ni, nr = got["n_inliers"], want["n_inliers"]
    log(f"fused tracker step: |dt| {dt:.3g}, |dR| {dr:.3g} (tolerance {tol}); "
        f"inliers {ni} vs {nr} (tolerance {inlier_frac:.0%})")
    check(dt <= tol and dr <= tol, f"fused step pose differs: {dt}, {dr}")
    check(abs(ni - nr) <= inlier_frac * max(nr, 1),
          f"fused step inliers {ni} vs {nr}")


def ba_problem(C: int, P: int, O: int, seed: int = 0, pixel_sigma: float = 1.0):
    """The multi-device dry run's synthetic BA problem plus Gaussian pixel
    noise on the observations, so the optimum keeps a cost well above
    float32 round-off and a relative comparison of costs means something."""
    from __graft_entry__ import _build_ba_problem

    rng = np.random.default_rng(seed)
    prob = _build_ba_problem(rng, C, P, O)
    noise = rng.normal(0.0, pixel_sigma, prob.obs_uv.shape).astype(np.float32)
    return prob._replace(obs_uv=prob.obs_uv + noise)


@jax.jit
def _local_ba(prob):
    from os1_tpu.optim import ba_core

    state = ba_core.ba_begin(prob)
    state = ba_core.ba_iterate(prob, state, 5)
    return ba_core.ba_result(prob, state)


def compare_ba(prob, dev, ref, cost_rtol: float = 1e-3, pose_tol: float = 1e-4):
    """One 5-iteration local-BA solve (ba_core begin/iterate/result)."""
    got = on(dev, _local_ba, prob)
    with no_cache_writes():
        want = on(ref, _local_ba, prob)
    cg, cr = float(got.cost), float(want.cost)
    rel = abs(cg - cr) / max(abs(cr), 1e-12)
    dp = float(np.abs(np.asarray(got.cam_T) - np.asarray(want.cam_T)).max())
    log(f"local BA C={prob.cam_T.shape[0]} P={prob.points.shape[0]} "
        f"O={prob.obs_cam.shape[1]}: cost {cg:.6g} vs {cr:.6g} (rel {rel:.3g}, "
        f"tolerance {cost_rtol}); poses |d| {dp:.3g} (tolerance {pose_tol})")
    check(rel <= cost_rtol, f"BA cost differs by {rel}")
    check(dp <= pose_tol, f"BA poses differ by {dp}")


@jax.jit
def _sim3_roundtrip_err(xi):
    from os1_tpu.geometry import sim3

    S = sim3.exp_batch(xi)
    return jnp.max(jnp.abs(sim3.exp_batch(sim3.log_batch(S)) - S))


def _triangulation_case(n: int, seed: int):
    from os1_tpu.geometry import se3

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    T2 = np.asarray(se3.exp(jnp.asarray(
        np.array([0.5, 0.05, -0.02, 0.02, -0.3, 0.01], np.float32))))
    P1 = (K @ np.eye(4)[:3]).astype(np.float32)
    P2 = (K @ T2[:3].astype(np.float64)).astype(np.float32)

    def proj(P):
        x = np.c_[pts, np.ones(n)] @ P.astype(np.float64).T
        return (x[:, :2] / x[:, 2:]).astype(np.float32)

    return (np.broadcast_to(P1, (n, 3, 4)), np.broadcast_to(P2, (n, 3, 4)),
            proj(P1), proj(P2)), pts


def check_geometry(dev, ref, n: int = 1024, tol: float = 5e-5,
                   tri_tol: float = 1e-4, seed: int = 0):
    """Sim3 exp/log round trip and two-view DLT triangulation: both go wrong
    by orders of magnitude when a float32 dot runs at reduced precision."""
    from os1_tpu.geometry import triangulation

    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.5, (n, 3)), rng.uniform(-2, 2, (n, 3)),
                         rng.uniform(-0.7, 0.7, (n, 1))], 1).astype(np.float32)
    tri_args, pts = _triangulation_case(n, seed)
    tri = jax.jit(triangulation.triangulate_dlt)
    errs = {}
    for name, d in (("dev", dev), ("ref", ref)):
        with no_cache_writes() if d is ref else contextlib.nullcontext():
            s_err = float(on(d, _sim3_roundtrip_err, xi))
            t_err = float(np.linalg.norm(
                np.asarray(on(d, tri, *tri_args)) - pts, axis=1).max())
        errs[name] = (s_err, t_err)
    (sg, tg), (sr, tr) = errs["dev"], errs["ref"]
    log(f"sim3 exp(log(exp)) max error {sg:.3g} (ref {sr:.3g}, tolerance {tol}); "
        f"triangulation max error {tg:.3g} (ref {tr:.3g}, tolerance {tri_tol})")
    check(sg <= tol, f"Sim3 round trip error {sg}")
    check(tg <= tri_tol, f"triangulation error {tg}")


def pose_graph_case(K: int, E: int, seed: int = 0):
    """A ring of K Sim3 keyframes with E edges to up to 4 successors, exact
    measurements, and initial poses perturbed off the solution."""
    from os1_tpu.geometry import sim3

    rng = np.random.default_rng(seed)
    xs = np.array([[0, 0, 2 * np.pi * i / K, np.cos(2 * np.pi * i / K) - 1,
                    np.sin(2 * np.pi * i / K), 0, 0] for i in range(K)],
                  np.float32)
    S = np.asarray(sim3.exp_batch(jnp.asarray(xs)))
    ei = rng.integers(0, K - 1, E).astype(np.int32)
    ej = (ei + 1 + rng.integers(0, 4, E)).clip(max=K - 1).astype(np.int32)
    eS = np.einsum("eij,ejk->eik", S[ej], np.linalg.inv(S[ei])).astype(np.float32)
    noise = np.concatenate([rng.normal(0, 0.01, (K, 6)),
                            rng.normal(0, 0.005, (K, 1))], 1).astype(np.float32)
    noise[0] = 0.0
    S0 = np.asarray(sim3.exp_batch(jnp.asarray(noise))) @ S
    fixed = np.arange(K) == 0
    return (S0, np.ones(K, bool), fixed, ei, ej, eS, ei != ej)


def compare_pose_graph(case, dev, ref, iters: int = 10, tol: float = 1e-3):
    """The essential-graph solve (float scatter-adds, atomics in no fixed
    order on the GPU) against the reference, within ``tol`` on the Sim3
    matrix entries (scene units ~1)."""
    from os1_tpu.optim.pose_graph import optimize_pose_graph

    solve = jax.jit(lambda *a: optimize_pose_graph(*a, iters=iters))
    got = np.asarray(on(dev, solve, *case))
    with no_cache_writes():
        want = np.asarray(on(ref, solve, *case))
    d = float(np.abs(got - want).max())
    moved = float(np.abs(want - case[0]).max())
    log(f"pose graph K={case[0].shape[0]} E={case[3].shape[0]}: |dS| {d:.3g} "
        f"(tolerance {tol}; the solve moved poses by up to {moved:.3g})")
    check(d <= tol, f"pose graph differs by {d}")


def kernel_phase(card: str):
    """Every kernel family of the main path at its real width, against its
    reference. The fused step's inputs are captured from a short tracked
    prefix of the orbit sequence."""
    import bench
    from os1_tpu.pipeline import tracking_fused

    t0 = time.time()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    frames, _ = bench.orbit_frames()
    sys_ = bench.build_system(sync=True)
    cfg = sys_.cfg
    n_feat, n_local = cfg.orb.n_features, cfg.th.max_local_points

    check_hamming(n_feat, n_local, gpu)  # tracker: features x local points
    check_hamming(n_feat, 5 * n_feat, gpu)  # relocalization: x 5 keyframes
    frame = compare_extractor(cfg.orb, cfg.camera, frames[0], gpu, cpu)
    check_host_pack(frame, gpu)

    step = tracking_fused.make_fused_tracker(cfg)
    seen = []

    def recorder(*args):
        seen[:] = [args]
        return step(*args)

    sys_.tracker._fused = recorder
    for i, img in enumerate(frames[:40]):
        sys_.track_monocular(img, timestamp=i / bench.FPS_BASELINE)
    sys_.flush()
    check(bool(seen), "the tracked prefix never reached the fused tracker")
    compare_fused(step, seen[0], n_feat, n_local, gpu, cpu)
    sys_.shutdown()

    compare_ba(ba_problem(64, 8192, cfg.map.max_obs_per_point), gpu, cpu)
    check_geometry(gpu, cpu)
    compare_pose_graph(pose_graph_case(cfg.map.max_keyframes, 2048), gpu, cpu)
    log(f"kernels phase: {time.time() - t0:.1f} s including compiles ({card})")


# --------------------------------------------------------------------- #
# Main path
# --------------------------------------------------------------------- #
def run_sequence_gated(name, sys_, frames, poses, card, ate_gate,
                       ok_gate=None, min_loops=0):
    """Track a whole sequence through the shipped scheduler and hold it to
    bench.py's gates."""
    import bench

    dt, lat, ok_frac = bench.run_sequence(sys_, frames)
    ate = bench._traj_ate(sys_, poses)
    loops = sys_.loop_closer.n_loops_closed
    sys_.shutdown()
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    log(f"{name}: {len(frames) / dt:.2f} frames/s, frame latency p50 "
        f"{p50:.2f} ms p99 {p99:.2f} ms, first pass after warmup ({card})")
    log(f"{name}: ATE {ate:.5f} (gate <= {ate_gate}), tracked fraction "
        f"{ok_frac:.3f} (gate >= {ok_gate}), loops closed {loops} "
        f"(gate >= {min_loops}), {sys_.store.n_keyframes()} keyframes, "
        f"{sys_.store.n_points()} points, losses {sys_.tracker.loss_log[:8]}")
    check(ate <= ate_gate, f"{name} ATE {ate} > {ate_gate}")
    if ok_gate is not None:
        check(ok_frac >= ok_gate, f"{name} tracked fraction {ok_frac}")
    check(loops >= min_loops, f"{name} closed {loops} loops")


def main_path_phase(card: str):
    import bench
    from os1_tpu import run_slam

    t0 = time.time()
    sys_ = bench.build_system()
    log(f"set-up: System.warmup() compiled the pipeline in "
        f"{sys_.warmup():.1f} s")
    frames, poses = bench.orbit_frames()
    run_sequence_gated("orbit", sys_, frames, poses, card,
                       ate_gate=bench.GATE_ATE_ORBIT,
                       ok_gate=bench.GATE_OK_FRACTION)
    frames, poses = bench.loop_frames()
    run_sequence_gated("loop", bench.build_system(), frames, poses, card,
                       ate_gate=bench.GATE_ATE_LOOP,
                       min_loops=bench.GATE_MIN_LOOPS)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_slam.main(["--synthetic", "--frames", "120"])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"run_slam --synthetic --frames 120: {json.dumps(summary)} "
        f"(gates: tracked fraction >= 0.9 counting the bootstrap frames, "
        f"ATE <= {bench.GATE_ATE_ORBIT})")
    check(rc == 0, f"run_slam exited {rc}")
    check(summary["tracked_fraction"] >= 0.9, "run_slam tracked fraction")
    check(summary.get("ate_rmse_vs_groundtruth", np.inf) <= bench.GATE_ATE_ORBIT,
          "run_slam ATE")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"main path phase: {time.time() - t0:.1f} s; peak_bytes_in_use "
        f"{peak} ({card})")


# --------------------------------------------------------------------- #
# Four cards: the sharded back-end
# --------------------------------------------------------------------- #
def compare_dist_database(host_db, mesh, max_words: int, tol: float = 1e-5):
    """The keyframe-sharded BoW database against the host inverted file,
    probing with every live keyframe. The host query keeps keyframes sharing
    >= 0.8x the best shared-word count before ranking, the sharded one ranks
    every keyframe; so the contract is equal L1 scores for the host's
    candidates, and the host's top-1 being the sharded best among them."""
    from os1_tpu.parallel import DistKeyFrameDatabase

    ddb = DistKeyFrameDatabase(mesh, max_keyframes=host_db.max_keyframes,
                               max_words=max_words)
    live = np.nonzero(host_db.active)[0].tolist()
    for k in live:
        ddb.add(k, host_db.bows[k])
    worst, agree = 0.0, 0
    for probe in live:
        bow, excl = host_db.bows[probe], np.array([probe])
        h_ids, h_sc = host_db.query(bow, exclude=excl)
        d_ids, d_sc = ddb.query(bow, exclude=excl, top=ddb.max_keyframes)
        d_map = dict(zip(d_ids.tolist(), d_sc.tolist()))
        for k, s in zip(h_ids.tolist(), h_sc.tolist()):
            worst = max(worst, abs(d_map.get(k, np.inf) - s))
        if len(h_ids) == 0:
            agree += 1
            continue
        best = max(h_ids.tolist(), key=lambda k: d_map.get(k, -np.inf))
        agree += d_map.get(best) == d_map.get(int(h_ids[0]))
    log(f"sharded keyframe database over {mesh.devices.size} devices: L1 "
        f"scores of the host's candidates within {worst:.3g} (tolerance "
        f"{tol}); host top-1 is the sharded best among them for "
        f"{agree}/{len(live)} keyframes (tolerance: all)")
    check(worst <= tol, "sharded database scores differ from host")
    check(agree == len(live), "sharded database ranks differently from host")


def four_card_phase(card: str, n: int = 4):
    """Distributed Schur BA, edge-sharded pose graph, System on the loop
    sequence (which shards BA and the essential graph over every device when
    more than one exists), and the keyframe-sharded BoW database, each
    against its single-device counterpart."""
    import bench
    from jax.sharding import Mesh

    from os1_tpu.optim import ba_core
    from os1_tpu.optim.pose_graph import optimize_pose_graph
    from os1_tpu.parallel import (
        distributed_pose_graph, make_distributed_ba, shard_problem,
    )

    devs = np.array(jax.devices()[:n])
    one = devs[0]

    # Distributed BA at the multi-device dry run's shapes: C=64, 4096 points
    # per card, 4 observations per point.
    iters = 10
    prob = ba_problem(64, 4096 * n, 4)
    mesh = Mesh(devs, ("points",))
    runner = make_distributed_ba(mesh, iters=iters)
    sp = shard_problem(prob, mesh)
    cam_d, _, cost_d = jax.block_until_ready(runner(sp))
    single = jax.jit(lambda p: ba_core.ba_iterate(p, ba_core.ba_begin(p), iters))
    st = on(one, single, prob)
    rel = abs(float(cost_d) - float(st.cost)) / abs(float(st.cost))
    dp = float(np.abs(np.asarray(cam_d) - np.asarray(st.cam_T)).max())
    log(f"distributed BA over {n} cards, C=64 P={4096 * n} O=4, {iters} LM "
        f"iterations: cost {float(cost_d):.6g} vs single-card "
        f"{float(st.cost):.6g} (rel {rel:.3g}, tolerance 1e-3); poses |d| "
        f"{dp:.3g} (tolerance 1e-4)")
    check(rel <= 1e-3 and dp <= 1e-4, "distributed BA disagrees")

    case = pose_graph_case(128, 2048)
    emesh = Mesh(devs, ("edges",))
    got = np.asarray(distributed_pose_graph(
        *[jnp.asarray(a) for a in case], mesh=emesh, iters=10))
    want = np.asarray(on(one, jax.jit(
        lambda *a: optimize_pose_graph(*a, iters=10)), *case))
    d = float(np.abs(got - want).max())
    log(f"distributed pose graph over {n} cards K=128 E=2048: |dS| {d:.3g} "
        f"vs single card (tolerance 1e-3)")
    check(d <= 1e-3, "distributed pose graph disagrees")

    frames, poses = bench.loop_frames()
    sys_ = bench.build_system()
    check(sys_.mesh_backend is not None
          and sys_.mesh_backend.mesh.devices.size == n,
          "System's mesh back-end does not span the cards")
    log(f"set-up: System.warmup() over {n} cards compiled the pipeline in "
        f"{sys_.warmup():.1f} s")
    run_sequence_gated(
        f"loop, System over {n} cards", sys_, frames, poses,
        card, ate_gate=bench.GATE_ATE_LOOP, min_loops=bench.GATE_MIN_LOOPS,
    )

    compare_dist_database(sys_.db, Mesh(devs, ("kfs",)),
                          max_words=sys_.cfg.orb.n_features)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded back-end on four cards")
    args = ap.parse_args(argv)
    # The CPU references need the CPU backend beside the card's.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    n_cards = 4 if args.four_cards else 1
    card = device_phase(n_cards)
    if args.four_cards:
        four_card_phase(card)
    else:
        kernel_phase(card)
        main_path_phase(card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
