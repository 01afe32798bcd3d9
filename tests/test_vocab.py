"""Vocabulary + place-recognition tests: training determinism, transform
consistency, binary-format roundtrip, database retrieval quality."""
import numpy as np
import jax.numpy as jnp
import pytest

from os1_tpu.vocab import Vocabulary, transform, bow_vector, l1_score
from os1_tpu.vocab.train import build_vocabulary
from os1_tpu.vocab import dbow2
from os1_tpu.vocab.database import KeyFrameDatabase


@pytest.fixture(scope="module")
def small_vocab():
    rng = np.random.default_rng(0)
    descs = rng.integers(0, 2**32, size=(3000, 8), dtype=np.uint32)
    return build_vocabulary(descs, branching=5, depth=3, seed=1)


class TestTraining:
    def test_structure(self, small_vocab):
        v = small_vocab
        assert v.n_words > 50
        word = np.asarray(v.node_word)
        children = np.asarray(v.node_children)
        # Leaves have no children; internal nodes have at least one.
        leaves = word >= 0
        assert (children[leaves] == -1).all()
        assert (children[~leaves][:, 0][1:] >= 0).all() or (~leaves).sum() == 1
        # Word ids are a permutation of range(n_words).
        w = word[leaves]
        assert sorted(w.tolist()) == list(range(v.n_words))

    def test_deterministic(self):
        rng = np.random.default_rng(3)
        descs = rng.integers(0, 2**32, size=(500, 8), dtype=np.uint32)
        v1 = build_vocabulary(descs, branching=4, depth=2, seed=9)
        v2 = build_vocabulary(descs, branching=4, depth=2, seed=9)
        np.testing.assert_array_equal(np.asarray(v1.node_desc), np.asarray(v2.node_desc))

    def test_transform_assigns_near_descriptors_same_word(self, small_vocab):
        rng = np.random.default_rng(5)
        base = rng.integers(0, 2**32, size=(100, 8), dtype=np.uint32)
        w1, _ = transform(small_vocab, jnp.asarray(base), jnp.ones(100, bool))
        # 3-bit perturbation: mostly same word.
        bits = np.unpackbits(base.view(np.uint8), axis=1)
        for i in range(100):
            flip = rng.choice(256, 3, replace=False)
            bits[i, flip] ^= 1
        pert = np.packbits(bits, axis=1).view(np.uint32)
        w2, _ = transform(small_vocab, jnp.asarray(pert), jnp.ones(100, bool))
        agreement = (np.asarray(w1) == np.asarray(w2)).mean()
        assert agreement > 0.55, agreement

    def test_invalid_masked(self, small_vocab):
        rng = np.random.default_rng(1)
        d = rng.integers(0, 2**32, size=(10, 8), dtype=np.uint32)
        valid = np.zeros(10, bool)
        valid[:5] = True
        w, wt = transform(small_vocab, jnp.asarray(d), jnp.asarray(valid))
        assert (np.asarray(w)[5:] == -1).all()
        assert (np.asarray(wt)[5:] == 0).all()


class TestBinaryFormat:
    def test_roundtrip(self, small_vocab, tmp_path):
        path = str(tmp_path / "vocab.bin")
        dbow2.save_binary(small_vocab, path)
        loaded = dbow2.load_binary(path)
        assert loaded.n_words == small_vocab.n_words
        assert loaded.branching == small_vocab.branching
        np.testing.assert_array_equal(
            np.asarray(loaded.node_desc), np.asarray(small_vocab.node_desc)
        )
        np.testing.assert_array_equal(
            np.asarray(loaded.node_children), np.asarray(small_vocab.node_children)
        )
        np.testing.assert_allclose(
            np.asarray(loaded.node_weight), np.asarray(small_vocab.node_weight),
            rtol=1e-6,
        )
        # Same transform results.
        rng = np.random.default_rng(2)
        d = rng.integers(0, 2**32, size=(50, 8), dtype=np.uint32)
        w1, _ = transform(small_vocab, jnp.asarray(d), jnp.ones(50, bool))
        w2, _ = transform(loaded, jnp.asarray(d), jnp.ones(50, bool))
        np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))

    def test_header(self, small_vocab, tmp_path):
        path = str(tmp_path / "vocab.bin")
        dbow2.save_binary(small_vocab, path)
        raw = open(path, "rb").read()
        assert raw[0] == 5 and raw[1] == 3  # k, L
        assert raw[2] == 0 and raw[3] == 0  # L1-NORM, TF_IDF
        assert (len(raw) - 4) % 45 == 0


class TestScoring:
    def test_self_similarity(self, small_vocab):
        rng = np.random.default_rng(4)
        d = rng.integers(0, 2**32, size=(200, 8), dtype=np.uint32)
        w, wt = transform(small_vocab, jnp.asarray(d), jnp.ones(200, bool))
        v = bow_vector(w, wt, small_vocab.n_words)
        s = l1_score(v, v[None, :])
        assert abs(float(s[0]) - 1.0) < 1e-5

    def test_distinct_scenes_low_score(self, small_vocab):
        rng = np.random.default_rng(6)
        d1 = rng.integers(0, 2**32, size=(200, 8), dtype=np.uint32)
        d2 = rng.integers(0, 2**32, size=(200, 8), dtype=np.uint32)
        w1, wt1 = transform(small_vocab, jnp.asarray(d1), jnp.ones(200, bool))
        w2, wt2 = transform(small_vocab, jnp.asarray(d2), jnp.ones(200, bool))
        v1 = bow_vector(w1, wt1, small_vocab.n_words)
        v2 = bow_vector(w2, wt2, small_vocab.n_words)
        same = float(l1_score(v1, v1[None, :])[0])
        diff = float(l1_score(v1, v2[None, :])[0])
        assert diff < 0.6 * same


class TestDatabase:
    def test_retrieval(self, small_vocab):
        """Store BoW of several 'scenes'; a noisy re-observation of scene i
        must retrieve keyframe i as the top candidate."""
        rng = np.random.default_rng(8)
        db = KeyFrameDatabase(small_vocab, max_keyframes=16)
        scene_desc = []
        for k in range(8):
            d = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint32)
            scene_desc.append(d)
            _, _, v = db.compute_bow(d, np.ones(300, bool))
            db.add(k, v)
        for k in range(8):
            # Re-observe with 20% replaced descriptors + bit noise.
            d = scene_desc[k].copy()
            repl = rng.choice(300, 60, replace=False)
            d[repl] = rng.integers(0, 2**32, size=(60, 8), dtype=np.uint32)
            _, _, v = db.compute_bow(d, np.ones(300, bool))
            ids, scores = db.query(v)
            assert len(ids) >= 1
            assert ids[0] == k, (k, ids[:3], scores[:3])

    def test_exclude(self, small_vocab):
        rng = np.random.default_rng(9)
        db = KeyFrameDatabase(small_vocab, max_keyframes=8)
        d = rng.integers(0, 2**32, size=(100, 8), dtype=np.uint32)
        _, _, v = db.compute_bow(d, np.ones(100, bool))
        db.add(0, v)
        db.add(1, v)
        ids, _ = db.query(v, exclude=np.array([0]))
        assert 0 not in ids and 1 in ids

    def test_erase(self, small_vocab):
        rng = np.random.default_rng(10)
        db = KeyFrameDatabase(small_vocab, max_keyframes=8)
        d = rng.integers(0, 2**32, size=(100, 8), dtype=np.uint32)
        _, _, v = db.compute_bow(d, np.ones(100, bool))
        db.add(3, v)
        db.erase(3)
        ids, _ = db.query(v)
        assert len(ids) == 0


class TestDatabaseAtScale:
    """Place-recognition precision with a 500+-keyframe database — the
    regime the reference's inverted file is built for (resizeInvertedFile,
    KeyFrameDatabase.cc:337). Uses the packaged default vocabulary (the
    reference-scale data/vocab_1m.bin)."""

    N_KF = 512
    N_SCENE = 64  # distinct "places"; 8 keyframes re-observe each place

    @pytest.fixture(scope="class")
    def big_db(self):
        vocab = dbow2.default_vocabulary()
        rng = np.random.default_rng(42)
        db = KeyFrameDatabase(vocab, max_keyframes=self.N_KF)
        scene_desc = rng.integers(
            0, 2**32, size=(self.N_SCENE, 256, 8), dtype=np.uint32
        )
        bows = []
        for k in range(self.N_KF):
            place = k % self.N_SCENE
            d = scene_desc[place].copy()
            # Each revisit sees ~15% different descriptors + noise.
            repl = rng.choice(256, 38, replace=False)
            d[repl] = rng.integers(0, 2**32, size=(38, 8), dtype=np.uint32)
            _, _, v = db.compute_bow(d, np.ones(256, bool))
            db.add(k, v)
            bows.append(v)
        return db, bows

    def test_query_precision(self, big_db):
        """Top-1 retrieval must find a keyframe of the SAME place; measured
        over every 8th keyframe to keep runtime bounded."""
        db, bows = big_db
        hits = 0
        probes = list(range(0, self.N_KF, 8))
        for k in probes:
            ids, scores = db.query(bows[k], exclude=np.array([k]))
            assert len(ids) >= 1
            hits += int(ids[0]) % self.N_SCENE == k % self.N_SCENE
        precision = hits / len(probes)
        assert precision > 0.9, f"top-1 place precision {precision:.2f}"

    def test_inverted_file_is_sparse(self, big_db):
        """Query touches only keyframes sharing words — the inverted file
        must not degenerate into scoring every keyframe (the whole point of
        KeyFrameDatabase.cc:74's shared-word counting)."""
        db, bows = big_db
        # Work = total posting-list entries touched by the query. Brute
        # force would score every (word, keyframe) pair; the inverted file
        # must touch well under half of that even with these synthetic
        # descriptors (which cluster into fewer words than real ORB output).
        n_words = db.vocab.n_words
        assert n_words >= 5000
        probe = bows[0]
        work = sum(len(db.inverted.get(int(w), {})) for w in probe.words)
        brute = self.N_KF * len(probe.words)
        assert work < 0.5 * brute, (work, brute)

    def test_loop_protocol_excludes_connected(self, big_db):
        """detect_loop_candidates honors exclusion + relative-score gates at
        scale."""
        db, bows = big_db
        k = 8  # same place as keyframes 8, 72, 136, ...
        same_place = [i for i in range(self.N_KF)
                      if i % self.N_SCENE == k % self.N_SCENE and i != k]
        cands = db.detect_loop_candidates(
            bows[k], exclude=np.array([k] + same_place[:3]),
            min_score=0.01, covis_fn=lambda j: np.array([j]),
        )
        assert all(int(c) not in [k] + same_place[:3] for c in cands)
        if len(cands):
            assert all(int(c) % self.N_SCENE == k % self.N_SCENE
                       for c in cands[:1])


class TestRecallAtScaleRealDescriptors:
    """Precision/recall of the packaged (reference-scale) vocabulary on
    REAL extracted ORB descriptors: 520 database keyframes from distinct
    rendered textures, queried with re-observations (bit noise + 30%
    replaced descriptors — a proxy for viewpoint change). The uniform-random
    descriptor tests above validate the protocol; this validates the
    TRAINED TREE's discriminative power (VERDICT r3 task 8)."""

    N_DB = 520
    N_QUERY = 60

    def test_top1_recall(self):
        import jax.numpy as jnp

        from os1_tpu.features.orb import OrbConfig, make_extractor
        from os1_tpu.io.synthetic import smooth_texture
        from os1_tpu.vocab import dbow2
        from os1_tpu.vocab.database import KeyFrameDatabase

        vocab = dbow2.default_vocabulary()
        db = KeyFrameDatabase(vocab, max_keyframes=self.N_DB)
        cfg = OrbConfig(height=240, width=320, n_features=256, n_levels=3)
        extract = make_extractor(cfg)
        rng = np.random.default_rng(3)

        descs = []
        for i in range(self.N_DB):
            img = smooth_texture(240, 320, 16 + (i * 7) % 80, seed=9000 + i)
            f = extract(jnp.asarray(img))
            v = np.asarray(f.valid)
            d = np.zeros((256, 8), np.uint32)
            d[: v.sum()] = np.asarray(f.desc)[v][:256]
            descs.append(d)
            _, _, bow = db.compute_bow(d, np.ones(256, bool))
            db.add(i, bow)

        hits = 0
        for q in range(self.N_QUERY):
            k = int(rng.integers(self.N_DB))
            d = descs[k].copy()
            # Re-observation: 30% new descriptors + ~2% bit noise on the rest.
            repl = rng.choice(256, 77, replace=False)
            other = int(rng.integers(self.N_DB))
            d[repl] = descs[other][repl]
            noise = rng.integers(0, 2**32, size=d.shape, dtype=np.uint32)
            mask = rng.random(d.shape) < 0.08  # ~2.5% of bits flip
            d = np.where(mask, d ^ (noise & 0x01010101), d)
            _, _, bow = db.compute_bow(d, np.ones(256, bool))
            ids, scores = db.query(bow)
            if len(ids) and int(ids[0]) == k:
                hits += 1
        recall = hits / self.N_QUERY
        assert recall >= 0.9, f"top-1 recall {recall:.2f} at {self.N_DB} KFs"
