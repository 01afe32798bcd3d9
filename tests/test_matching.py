"""Matching-engine tests: gated matching semantics, mutual uniqueness,
rotation consistency, epipolar gating, and a synthetic two-view recall test."""
import numpy as np
import jax.numpy as jnp
import pytest

from os1_tpu.features.orb import FrameFeatures
from os1_tpu.matching import core, matchers
from os1_tpu.geometry import se3, camera


def make_feats(xy, desc_bits, octave=None, angle=None, valid=None):
    from os1_tpu.ops import hamming

    n = len(xy)
    return FrameFeatures(
        xy=jnp.asarray(np.asarray(xy, np.float32)),
        response=jnp.ones(n, jnp.float32),
        angle=jnp.asarray(
            np.zeros(n, np.float32) if angle is None else np.asarray(angle, np.float32)
        ),
        octave=jnp.asarray(
            np.zeros(n, np.int32) if octave is None else np.asarray(octave, np.int32)
        ),
        desc=hamming.pack_bits(jnp.asarray(np.asarray(desc_bits, bool))),
        valid=jnp.asarray(
            np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        ),
    )


def random_bits(rng, n):
    return rng.integers(0, 2, size=(n, 256)).astype(bool)


def perturb_bits(rng, bits, flips):
    out = bits.copy()
    for i in range(len(bits)):
        idx = rng.choice(256, size=flips, replace=False)
        out[i, idx] = ~out[i, idx]
    return out


class TestCore:
    def test_gate_blocks_best(self, rng):
        bits = random_bits(rng, 4)
        a = make_feats(np.zeros((2, 2)), bits[:2])
        # b0 identical to a0 but gated out; b1 is 30 bits away and allowed.
        b_bits = np.stack([bits[0], perturb_bits(rng, bits[:1], 30)[0]])
        b = make_feats(np.zeros((2, 2)), b_bits)
        gate = jnp.asarray(np.array([[False, True], [True, True]]))
        res = core.match_with_gate(a.desc, b.desc, gate, max_dist=100)
        assert int(res.idx[0]) == 1 and bool(res.ok[0])

    def test_ratio_test(self, rng):
        bits = random_bits(rng, 1)
        # Two near-identical candidates -> ambiguous -> ratio test kills it.
        b_bits = np.stack([perturb_bits(rng, bits, 10)[0], perturb_bits(rng, bits, 11)[0]])
        a = make_feats([[0, 0]], bits)
        b = make_feats([[0, 0], [0, 0]], b_bits)
        gate = jnp.ones((1, 2), bool)
        res = core.match_with_gate(a.desc, b.desc, gate, max_dist=100, ratio=0.7)
        assert not bool(res.ok[0])
        res2 = core.match_with_gate(a.desc, b.desc, gate, max_dist=100, ratio=1.0)
        assert bool(res2.ok[0])

    def test_mutual_best(self, rng):
        bits = random_bits(rng, 1)
        # Both rows match column 0; row 1 is closer. Row 0 must be dropped.
        a_bits = np.stack([perturb_bits(rng, bits, 20)[0], perturb_bits(rng, bits, 5)[0]])
        a = make_feats(np.zeros((2, 2)), a_bits)
        b = make_feats(np.zeros((1, 2)), bits)
        gate = jnp.ones((2, 1), bool)
        res = core.match_with_gate(a.desc, b.desc, gate, max_dist=100)
        res = core.mutual_best(res, 1)
        assert not bool(res.ok[0]) and bool(res.ok[1])

    def test_rotation_consistency(self, rng):
        n = 60
        bits = random_bits(rng, n)
        angles_a = np.zeros(n, np.float32)
        angles_b = np.full(n, 0.3, np.float32)  # dominant rotation 0.3 rad
        angles_b[:4] = 3.0  # four outliers (<10% of the dominant bin)
        a = make_feats(np.zeros((n, 2)), bits, angle=angles_a)
        b = make_feats(np.zeros((n, 2)), bits, angle=angles_b)
        res = core.MatchResult(
            idx=jnp.arange(n, dtype=jnp.int32),
            dist=jnp.zeros(n, jnp.int32),
            ok=jnp.ones(n, bool),
        )
        out = core.rotation_consistency(a.angle, b.angle, res)
        ok = np.asarray(out.ok)
        assert not ok[:4].any()
        assert ok[4:].all()


class TestVariants:
    def test_initialization_recall(self, rng):
        """Shifted copies of features must be recovered by window search."""
        n = 200
        bits = random_bits(rng, n)
        xy1 = np.stack(
            [rng.uniform(120, 520, size=n), rng.uniform(120, 360, size=n)], axis=1
        )
        shift = np.array([15.0, -8.0])
        noisy_bits = perturb_bits(rng, bits, 12)
        f1 = make_feats(xy1, bits)
        f2 = make_feats(xy1 + shift, noisy_bits)
        res = matchers.search_for_initialization(f1, f2, window=100.0)
        ok = np.asarray(res.ok)
        idx = np.asarray(res.idx)
        assert ok.sum() > 0.9 * n
        assert (idx[ok] == np.nonzero(ok)[0]).mean() > 0.99

    def test_projection_octave_gate(self, rng):
        bits = random_bits(rng, 2)
        f = make_feats([[10, 10], [12, 12]], bits, octave=[0, 5])
        res = matchers.search_by_projection(
            point_desc=f.desc[:1],
            point_uv=jnp.asarray([[11.0, 11.0]]),
            point_valid=jnp.asarray([True]),
            point_octave=jnp.asarray([5]),
            feats=f,
            radius=jnp.asarray([20.0]),
        )
        # Octave gate [4,6] excludes the octave-0 feature even though desc matches.
        assert int(res.idx[0]) == 1

    def test_predicted_octave(self):
        # Point at max distance -> level 0; at max/1.2^3 -> level 3.
        lvl = matchers.predicted_octave(
            jnp.asarray([10.0, 10.0 / 1.2**3]), jnp.asarray([10.0, 10.0]), 1.2, 8
        )
        assert int(lvl[0]) == 0 and int(lvl[1]) == 3

    def test_epipolar_gate_synthetic(self, rng):
        """Pairs violating the epipolar constraint are gated out."""
        cam = camera.Camera.make(fx=400.0, fy=400.0, cx=320.0, cy=240.0)
        K = np.asarray(cam.K)
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.asarray(
            se3.exp(jnp.asarray([0.3, 0.0, 0.0, 0.0, -0.05, 0.0], dtype=jnp.float32))
        )
        n = 100
        pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
        pts[:, 2] += 5.0
        uv1 = np.asarray(camera.project_ideal(cam, se3.transform(jnp.asarray(T1), jnp.asarray(pts))))
        uv2 = np.asarray(camera.project_ideal(cam, se3.transform(jnp.asarray(T2), jnp.asarray(pts))))
        F12 = matchers.compute_f12(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(K), jnp.asarray(K))
        s2 = jnp.ones(n)
        gate = matchers.epipolar_gate(jnp.asarray(uv1), jnp.asarray(uv2), F12, s2)
        g = np.asarray(gate)
        # True correspondences pass.
        assert np.diag(g).mean() > 0.95
        # Random pairs mostly fail.
        off = g[~np.eye(n, dtype=bool)]
        assert off.mean() < 0.2

    def test_triangulation_matcher_end_to_end(self, rng):
        cam = camera.Camera.make(fx=400.0, fy=400.0, cx=320.0, cy=240.0)
        K = np.asarray(cam.K)
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.asarray(
            se3.exp(jnp.asarray([0.4, 0.02, 0.0, 0.0, -0.08, 0.0], dtype=jnp.float32))
        )
        n = 150
        pts = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
        pts[:, 2] += 6.0
        uv1 = np.asarray(camera.project_ideal(cam, se3.transform(jnp.asarray(T1), jnp.asarray(pts))))
        uv2 = np.asarray(camera.project_ideal(cam, se3.transform(jnp.asarray(T2), jnp.asarray(pts))))
        bits = random_bits(rng, n)
        f1 = make_feats(uv1, bits)
        f2 = make_feats(uv2, perturb_bits(rng, bits, 10))
        F12 = matchers.compute_f12(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(K), jnp.asarray(K))
        res = matchers.search_for_triangulation(
            f1, f2, F12, jnp.ones(8, jnp.float32)
        )
        ok = np.asarray(res.ok)
        idx = np.asarray(res.idx)
        assert ok.sum() > 0.85 * n
        assert (idx[ok] == np.nonzero(ok)[0]).mean() > 0.98

    def test_fuse(self, rng):
        bits = random_bits(rng, 3)
        f = make_feats([[100, 100], [200, 200], [300, 300]], bits)
        res = matchers.fuse_candidates(
            point_desc=f.desc,
            point_uv=jnp.asarray([[101.0, 99.0], [210.0, 200.0], [600.0, 600.0]]),
            point_valid=jnp.ones(3, bool),
            point_octave=jnp.zeros(3, jnp.int32),
            feats=f,
            radius_scale=jnp.ones(3, jnp.float32) * 2.0,
        )
        ok = np.asarray(res.ok)
        assert ok[0] and not ok[1] and not ok[2]  # r=6: (10,0) off; far point off


def _np_popcount_table(a, b):
    """numpy XOR+popcount reference, one packed word at a time."""
    pop8 = np.array([bin(v).count("1") for v in range(256)], np.int32)
    out = np.zeros((len(a), len(b)), np.int32)
    for w in range(a.shape[1]):
        x = np.bitwise_xor(a[:, None, w], b[None, :, w])
        out += pop8[x.view(np.uint8)].reshape(x.shape + (4,)).sum(-1)
    return out


@pytest.mark.parametrize("n,m", [(1, 1), (300, 512), (1024, 1000), (1024, 4096)])
def test_hamming_forms_agree(rng, n, m):
    """Both XLA formulations equal numpy popcount exactly, and
    distance_matrix runs the one kept formulation at every M."""
    import jax

    from os1_tpu.ops.hamming import hamming_matrix, hamming_matrix_mxu

    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    ref = _np_popcount_table(a, b)
    da, db = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(np.asarray(hamming_matrix(da, db)), ref)
    np.testing.assert_array_equal(np.asarray(hamming_matrix_mxu(da, db)), ref)
    np.testing.assert_array_equal(np.asarray(core.distance_matrix(da, db)), ref)

    def prims(fn):
        return [e.primitive.name for e in jax.make_jaxpr(fn)(da, db).jaxpr.eqns]

    assert prims(core.distance_matrix) == prims(hamming_matrix_mxu)
