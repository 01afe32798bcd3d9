"""Distributed-BA tests on the virtual 8-device CPU mesh: convergence and
agreement with the single-device solver."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from os1_tpu.geometry import se3
from os1_tpu.optim import BAProblem, run_ba
from os1_tpu.parallel import distributed_ba

INTR = jnp.asarray([400.0, 400.0, 320.0, 240.0])


def build_problem(rng, n_pts=512, n_cams=8):
    pts = rng.uniform(-2, 2, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    poses = []
    for i in range(n_cams):
        xi = np.concatenate(
            [rng.normal(0, 0.3, 3), rng.normal(0, 0.05, 3)]
        ).astype(np.float32)
        poses.append(np.asarray(se3.exp(jnp.asarray(xi))))
    poses = np.stack(poses)
    O = 4
    obs_cam = rng.integers(0, n_cams, size=(n_pts, O)).astype(np.int32)
    Tsel = poses[obs_cam]
    pc = np.einsum("poij,pj->poi", Tsel[:, :, :3, :3], pts) + Tsel[:, :, :3, 3]
    uv = np.stack(
        [400 * pc[..., 0] / pc[..., 2] + 320, 400 * pc[..., 1] / pc[..., 2] + 240],
        -1,
    ).astype(np.float32)
    valid = pc[..., 2] > 0.5
    pts0 = pts + rng.normal(0, 0.04, pts.shape).astype(np.float32)
    poses0 = poses.copy()
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    for i in range(2, n_cams):
        xi = np.concatenate(
            [rng.normal(0, 0.02, 3), rng.normal(0, 0.008, 3)]
        ).astype(np.float32)
        poses0[i] = np.asarray(se3.exp(jnp.asarray(xi))) @ poses0[i]
    prob = BAProblem(
        cam_T=jnp.asarray(poses0),
        cam_fixed=jnp.asarray(fixed),
        points=jnp.asarray(pts0),
        point_valid=jnp.ones(n_pts, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.asarray(uv),
        obs_sigma2=jnp.ones((n_pts, O)),
        obs_valid=jnp.asarray(valid),
        intr=INTR,
    )
    return prob, poses, pts


@pytest.fixture
def mesh():
    devs = np.array(jax.devices())
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    return Mesh(devs[:8], ("points",))


class TestDistributedBA:
    def test_converges(self, rng, mesh):
        prob, poses, pts = build_problem(rng)
        cam_T, points, cost = distributed_ba(prob, mesh, iters=10)
        err = np.abs(np.asarray(cam_T)[2:] - poses[2:]).max()
        assert err < 5e-3, err
        perr = np.abs(np.asarray(points) - pts).max()
        assert perr < 3e-2, perr

    def test_matches_single_device(self, rng, mesh):
        prob, poses, pts = build_problem(rng)
        cam_T, points, cost = distributed_ba(prob, mesh, iters=8)
        res = run_ba(prob, iters=8)
        # Same algorithm, same schedule -> near-identical results.
        np.testing.assert_allclose(
            np.asarray(cam_T), np.asarray(res.cam_T), atol=5e-4
        )
        np.testing.assert_allclose(
            np.asarray(points), np.asarray(res.points), atol=5e-3
        )

    def test_output_shardings(self, rng, mesh):
        prob, poses, pts = build_problem(rng)
        from os1_tpu.parallel import shard_problem
        from os1_tpu.parallel.dist_ba import make_distributed_ba

        runner = make_distributed_ba(mesh, iters=2)
        sp = shard_problem(prob, mesh)
        cam_T, points, cost = runner(sp)
        # Points stay sharded over the mesh; cameras replicated.
        assert len(points.sharding.device_set) == 8
        assert cam_T.sharding.is_fully_replicated

    def test_two_host_mesh_matches_single_device(self, rng):
        """Config 5's multi-host layout on the virtual mesh: a ("dcn",
        "ici") 2x4 mesh — two simulated hosts of four devices — must run
        the full resumable BA protocol and match the single-device solver.
        On a real cluster the outer axis crosses the network between hosts;
        the hierarchical psum (within each host first, then across hosts on
        the reduced [C,C,6,6] block) is the same compiled program."""
        from os1_tpu.parallel.backend import two_level_backend

        prob, poses, pts = build_problem(rng)
        be = two_level_backend(n_hosts=2)
        assert be.mesh.devices.shape == (2, 4)
        sp = be.shard(prob)
        state = be.begin(sp)
        state = be.iterate(sp, state, 5)
        state = be.reclassify(sp, state)
        state = be.iterate(sp, state, 5)
        res = jax.device_get(be.result(sp, state))

        ref = run_ba(prob, iters=5, reclassify_and_continue=5)
        np.testing.assert_allclose(res.cam_T, np.asarray(ref.cam_T), atol=5e-4)
        np.testing.assert_allclose(res.points, np.asarray(ref.points), atol=5e-3)


def build_pose_graph(K=24):
    """Drifted circular trajectory + odometry edges + one true loop edge
    (same construction as test_loop_solvers.TestPoseGraph)."""
    from os1_tpu.geometry import sim3

    gt = []
    for i in range(K):
        th = 2 * np.pi * i / K
        xi = np.array([0, 0, th, np.cos(th) - 1, np.sin(th), 0, 0], np.float32)
        gt.append(np.asarray(sim3.exp(jnp.asarray(xi))))
    gt = np.stack(gt)
    bias = np.asarray(
        sim3.exp(jnp.asarray([0.01, 0.005, 0.0, 0.0, 0.008, 0.0, 0.01], jnp.float32))
    )
    drift = [gt[0].copy()]
    for i in range(1, K):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        drift.append((bias @ rel @ drift[-1]).astype(np.float32))
    drift = np.stack(drift)
    ei, ej, eS = [], [], []
    for i in range(K - 1):
        ei.append(i)
        ej.append(i + 1)
        eS.append(drift[i + 1] @ np.linalg.inv(drift[i]))
    ei.append(0)
    ej.append(K - 1)
    eS.append(gt[K - 1] @ np.linalg.inv(gt[0]))
    return gt, drift, np.array(ei, np.int32), np.array(ej, np.int32), np.stack(eS)


class TestDistributedPoseGraph:
    def test_matches_single_device(self, mesh):
        from os1_tpu.optim.pose_graph import optimize_pose_graph
        from os1_tpu.parallel import distributed_pose_graph
        from jax.sharding import Mesh as _Mesh

        gt, drift, ei, ej, eS = build_pose_graph()
        K = len(gt)
        args = (
            jnp.asarray(drift), jnp.ones(K, bool),
            jnp.asarray(np.arange(K) == 0),
            jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(eS.astype(np.float32)), jnp.ones(len(ei), bool),
        )
        single = optimize_pose_graph(*args, iters=15)
        emesh = _Mesh(np.asarray(jax.devices())[:8], ("edges",))
        dist = distributed_pose_graph(*args, mesh=emesh, iters=15)
        np.testing.assert_allclose(
            np.asarray(dist), np.asarray(single), atol=2e-3
        )
        # And it actually corrects the drift.
        end_before = np.abs(drift[K - 1] - gt[K - 1]).max()
        end_after = np.abs(np.asarray(dist)[K - 1] - gt[K - 1]).max()
        assert end_after < 0.25 * end_before, (end_before, end_after)


class TestMeshPipeline:
    """The FULL live pipeline on the device mesh (VERDICT r2 item 5): with
    more than one device, System auto-routes local BA / global BA through
    the landmark-sharded protocol and the essential graph through the
    edge-sharded solver. The whole synthetic sequence must track with the
    same accuracy as the forced single-device run."""

    def test_full_pipeline_mesh_matches_single(self):
        from os1_tpu.features.orb import OrbConfig
        from os1_tpu.geometry.camera import Camera
        from os1_tpu.io import synthetic
        from os1_tpu.map.store import MapConfig
        from os1_tpu.pipeline import SlamConfig, System, TrackingState

        H, W = 240, 320
        K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
        scene = synthetic.default_scene(seed=3)
        poses = synthetic.orbit_trajectory(40, advance=0.08)
        frames = [synthetic.render(scene, T, K, H, W) for T in poses]

        def run(distributed):
            cam = Camera.make(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2],
                              cy=K[1, 2], width=W, height=H)
            cfg = SlamConfig(
                camera=cam,
                orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                map=MapConfig(max_keyframes=64, max_points=8192,
                              n_features=512),
            )
            sys = System(cfg=cfg, distributed=distributed)
            est, gt = [], []
            for i, f in enumerate(frames):
                state, Tcw = sys.track_monocular(f, timestamp=i / 30.0)
                if state == TrackingState.OK and Tcw is not None:
                    est.append(Tcw)
                    gt.append(poses[i])
            assert len(est) > 25
            return synthetic.ate_rmse(est, gt)

        ate_mesh = run(distributed=True)  # requires the 8-device mesh
        ate_single = run(distributed=False)
        # Same pipeline, same inputs; the sharded solves differ only by
        # psum summation order -> float-level divergence that the next
        # LM accept/reject step can amplify slightly.
        assert ate_mesh < max(2.0 * ate_single, ate_single + 0.01), (
            ate_mesh, ate_single,
        )


class TestDistDatabase:
    def test_matches_host_database(self, mesh):
        """Sharded BoW scoring must reproduce the host inverted file's L1
        scores and ranking (config 5's sharded keyframe database)."""
        from jax.sharding import Mesh as _Mesh

        from os1_tpu.parallel import DistKeyFrameDatabase
        from os1_tpu.vocab.database import KeyFrameDatabase
        from os1_tpu.vocab.train import build_vocabulary

        rng = np.random.default_rng(0)
        vocab = build_vocabulary(
            rng.integers(0, 2**32, size=(3000, 8), dtype=np.uint32),
            branching=5, depth=3, seed=1,
        )
        host = KeyFrameDatabase(vocab, max_keyframes=64)
        kmesh = _Mesh(np.asarray(jax.devices())[:8], ("kfs",))
        dist = DistKeyFrameDatabase(kmesh, max_keyframes=64, max_words=200)

        bows = []
        for k in range(40):
            d = rng.integers(0, 2**32, size=(200, 8), dtype=np.uint32)
            _, _, bow = host.compute_bow(d, np.ones(200, bool))
            host.add(k, bow)
            dist.add(k, bow)
            bows.append(bow)

        for probe in (0, 7, 23):
            h_ids, h_scores = host.query(bows[probe], exclude=np.array([probe]))
            d_ids, d_scores = dist.query(bows[probe], exclude=np.array([probe]))
            # Same scores for the keyframes both rank (host may return more).
            h_map = dict(zip(h_ids.tolist(), h_scores.tolist()))
            for i, s in zip(d_ids[:10].tolist(), d_scores[:10].tolist()):
                assert i in h_map
                np.testing.assert_allclose(s, h_map[i], atol=1e-5)
            if len(h_ids) and len(d_ids):
                assert int(d_ids[0]) == int(h_ids[0])

    @staticmethod
    def _big_bows(rng, n_kf, n_words=900, universe=4000):
        from os1_tpu.vocab.database import SparseBow

        bows = []
        for _ in range(n_kf):
            w = np.sort(rng.choice(universe, n_words, replace=False)).astype(np.int32)
            v = rng.uniform(0.1, 1.0, n_words).astype(np.float32)
            bows.append(SparseBow(words=w, weights=v / v.sum()))
        return bows

    def test_bench_scale_bows_score_exactly(self, mesh):
        """Bows of a 1024-feature frame hold up to 1024 words; the sharded
        scores must equal the host inverted file's for all of them (a cap
        below the feature count would drop words by id and change the
        scores)."""
        from jax.sharding import Mesh as _Mesh

        from os1_tpu.parallel import DistKeyFrameDatabase
        from os1_tpu.vocab.database import KeyFrameDatabase
        from os1_tpu.vocab.train import build_vocabulary

        rng = np.random.default_rng(3)
        vocab = build_vocabulary(
            rng.integers(0, 2**32, size=(500, 8), dtype=np.uint32),
            branching=4, depth=2, seed=1,
        )
        host = KeyFrameDatabase(vocab, max_keyframes=16)
        dist = DistKeyFrameDatabase(
            _Mesh(np.asarray(jax.devices())[:8], ("kfs",)), max_keyframes=16,
            max_words=1024)
        bows = self._big_bows(rng, 16)
        for k, bow in enumerate(bows):
            host.add(k, bow)
            dist.add(k, bow)
        for probe in (0, 5, 11):
            excl = np.array([probe])
            h_ids, h_sc = host.query(bows[probe], exclude=excl)
            d_ids, d_sc = dist.query(bows[probe], exclude=excl, top=16)
            d_map = dict(zip(d_ids.tolist(), d_sc.tolist()))
            assert len(h_ids)
            for k, sc in zip(h_ids.tolist(), h_sc.tolist()):
                np.testing.assert_allclose(d_map[k], sc, atol=1e-5)

    def test_oversized_bow_is_refused(self, mesh):
        from jax.sharding import Mesh as _Mesh

        from os1_tpu.parallel import DistKeyFrameDatabase

        dist = DistKeyFrameDatabase(
            _Mesh(np.asarray(jax.devices())[:8], ("kfs",)), max_keyframes=8,
            max_words=64)
        big = self._big_bows(np.random.default_rng(0), 1, n_words=65)[0]
        with pytest.raises(ValueError):
            dist.add(0, big)
        with pytest.raises(ValueError):
            dist.query(big)

    def test_erase_and_min_score(self, mesh):
        from jax.sharding import Mesh as _Mesh

        from os1_tpu.parallel import DistKeyFrameDatabase
        from os1_tpu.vocab.database import KeyFrameDatabase
        from os1_tpu.vocab.train import build_vocabulary

        rng = np.random.default_rng(5)
        vocab = build_vocabulary(
            rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint32),
            branching=5, depth=3, seed=2,
        )
        host = KeyFrameDatabase(vocab, max_keyframes=16)
        kmesh = _Mesh(np.asarray(jax.devices())[:8], ("kfs",))
        dist = DistKeyFrameDatabase(kmesh, max_keyframes=16, max_words=100)
        d = rng.integers(0, 2**32, size=(100, 8), dtype=np.uint32)
        _, _, bow = host.compute_bow(d, np.ones(100, bool))
        dist.add(3, bow)
        ids, _ = dist.query(bow)
        assert 3 in ids
        dist.erase(3)
        ids, _ = dist.query(bow)
        assert 3 not in ids
