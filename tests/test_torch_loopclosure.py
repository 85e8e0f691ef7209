"""The port's loop-closure layer (``airslam_tpu_torch/loopclosure``,
``utils/native.py``) against the JAX package's, on the same descriptors made
from one numpy seed. Mirrors tests/test_loopclosure.py.

Tolerances: the vocabulary's training is numpy on both sides, so the trees
are compared bit for bit; word ids are argmins of float32 distances summed
the same way (``((c - d)**2).sum(-1)``) and must be equal; BoW weights
within 1e-6 (float32 weights summed in Python floats); database counts and
scores equal; the native kernels equal their numpy twins."""

import numpy as np
import pytest
import torch

from airslam_tpu.loopclosure import database as jdb
from airslam_tpu.loopclosure import vocabulary as jvoc
from airslam_tpu_torch.loopclosure import database as tdb
from airslam_tpu_torch.loopclosure import vocabulary as tvoc
from airslam_tpu_torch.utils import native
from tests.test_loopclosure import make_clustered_descriptors

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vocs():
    descs, _, _ = make_clustered_descriptors()
    return (jvoc.train_vocabulary(descs, k=4, depth=3, seed=0),
            tvoc.train_vocabulary(descs, k=4, depth=3, seed=0))


def _noisy(seed, n=600):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 256).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_training_is_bit_equal(vocs):
    jv, tv = vocs
    assert (tv.k, tv.depth, tv.num_words) == (jv.k, jv.depth, jv.num_words)
    for a, b in zip(jv.levels, tv.levels):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jv.valid, tv.valid):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))


@pytest.mark.parametrize("depth", [None, 2])
def test_auto_depth_and_small_trees_bit_equal(depth):
    desc = _noisy(1, 300)[:, :16]
    jv = jvoc.train_vocabulary(desc, k=4, depth=depth, seed=3)
    tv = tvoc.train_vocabulary(desc, k=4, depth=depth, seed=3)
    assert tv.depth == jv.depth == (depth or tvoc.auto_depth(300, 4))
    for a, b in zip(jv.levels, tv.levels):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    for n in (100, 8_000, 30_000, 2_000_000):
        assert tvoc.auto_depth(n) == jvoc.auto_depth(n)


def test_word_ids_and_bow_vectors_equal(vocs):
    jv, tv = vocs
    descs, _, _ = make_clustered_descriptors(seed=4)
    descs = np.concatenate([descs, _noisy(2)])
    mask = np.arange(len(descs)) % 7 != 3
    jw, jwt = jv.transform(descs, mask)
    tw, twt = tv.transform(descs, mask)
    flipped = int((np.asarray(jw) != tw).sum())
    assert flipped == 0, f"{flipped} of {len(tw)} word ids differ"
    np.testing.assert_array_equal(twt, np.asarray(jwt))
    jvec, _ = jv.bow_vector(descs[:200], mask[:200])
    tvec, _ = tv.bow_vector(descs[:200], mask[:200])
    assert sorted(tvec) == sorted(jvec)
    assert max(abs(tvec[k] - jvec[k]) for k in jvec) < 1e-6
    assert tvoc.Vocabulary.score_l1(tvec, tvec) == pytest.approx(1.0, abs=1e-6)


def test_npz_both_ways(vocs, tmp_path):
    jv, tv = vocs
    descs = _noisy(5, 80)
    jv.save(str(tmp_path / "jax.npz"))
    tv.save(str(tmp_path / "port.npz"))
    from_jax = tvoc.Vocabulary.load(str(tmp_path / "jax.npz"))
    from_port = jvoc.Vocabulary.load(str(tmp_path / "port.npz"))
    want = np.asarray(jv.transform(descs)[0])
    np.testing.assert_array_equal(from_jax.transform(descs)[0], want)
    np.testing.assert_array_equal(np.asarray(from_port.transform(descs)[0]), want)
    for a, b in zip(from_port.levels, tv.levels):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_database_query_and_scores_equal(vocs):
    jv, tv = vocs
    j, t = jdb.Database(jv), tdb.Database(tv)
    descs, _, _ = make_clustered_descriptors(seed=5)
    # enough frames that the CSR mirror is rebuilt, plus a delta after it
    for fid in range(14):
        lo = (fid * 40) % 560
        for db in (j, t):
            db.add_frame(fid, descs[lo:lo + 60])
    vec, wids, wf = t.frame_to_bow(descs[0:100])
    jvec, jwids, jwf = j.frame_to_bow(descs[0:100])
    assert vec.keys() == jvec.keys() and wf == jwf
    np.testing.assert_array_equal(wids, np.asarray(jwids))
    for _ in range(2):
        assert t.query(vec) == j.query(jvec)
        for db in (j, t):
            db.add_frame(100 + len(db.frame_bow), descs[200:260])
    ids = sorted(t.frame_bow)
    np.testing.assert_allclose(t.batched_scores(vec, ids), j.batched_scores(jvec, ids),
                               atol=1e-6)
    for f in ids:
        assert t.score(vec, t.frame_bow[f]) == pytest.approx(j.score(jvec, j.frame_bow[f]),
                                                              abs=1e-6)
    # the state dict crosses over both ways
    t2, j2 = tdb.Database(tv), jdb.Database(jv)
    t2.load_state_dict(j.state_dict())
    j2.load_state_dict(t.state_dict())
    assert t2.query(vec) == j2.query(jvec) == j.query(jvec)


def test_database_csr_query_matches_dict_walk_at_scale():
    """tests/test_loopclosure.py's 1,000-frame database on the port: the
    native CSR query equals the inverted-file walk, after the delta too."""
    rng = np.random.RandomState(0)
    desc = rng.randn(60, 256).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    db = tdb.Database(tvoc.train_vocabulary(desc, k=4, depth=2, seed=0))
    for fid in range(1000):
        d = rng.randn(40, 256).astype(np.float32)
        db.add_frame(fid, d / np.linalg.norm(d, axis=1, keepdims=True))
    q = rng.randn(40, 256).astype(np.float32)
    vec, _, _ = db.frame_to_bow(q / np.linalg.norm(q, axis=1, keepdims=True))

    def walk():
        ref = {}
        for wid in vec:
            for fid in db.inverted_file.get(wid, {}):
                ref[fid] = ref.get(fid, 0) + 1
        return ref

    assert db.query(vec) == walk()
    d = rng.randn(40, 256).astype(np.float32)
    db.add_frame(5000, d / np.linalg.norm(d, axis=1, keepdims=True))
    assert db.query(vec) == walk()


def test_native_kernels_equal_their_numpy_twins():
    rng = np.random.RandomState(9)
    offsets = np.concatenate([[0], np.cumsum(rng.randint(0, 6, 40))]).astype(np.int64)
    frames = rng.randint(-2, 30, int(offsets[-1])).astype(np.int32)
    q = rng.randint(-3, 45, 70).astype(np.int32)
    np.testing.assert_array_equal(native.invfile_query(q, offsets, frames, 27),
                                  native.invfile_query_plain(q, offsets, frames, 27))
    pairs = rng.randint(-1, 60, (120, 2))
    roots = native.union_find(pairs, 55)
    np.testing.assert_array_equal(roots, native.union_find_plain(pairs, 55))
    assert all(roots[r] == r and r <= i for i, r in enumerate(roots))
    kp = (rng.rand(300, 2) * [752, 480]).astype(np.float32)
    mask = rng.rand(300) > 0.2
    np.testing.assert_array_equal(native.radius_search(kp, mask, 300.0, 200.0, 45.0),
                                  native.radius_search_plain(kp, mask, 300.0, 200.0, 45.0))
    d = _noisy(3, 50)
    np.testing.assert_allclose(native.descriptor_distances(d[0], d),
                               native.descriptor_distances_plain(d[0], d), atol=1e-5)
    # the JAX package's binding gives the same answers
    from airslam_tpu.utils import native as jnative

    np.testing.assert_array_equal(jnative.union_find(pairs, 55), roots)


def test_native_library_is_the_ports_own():
    """The port builds its copy of the source into its own build directory and
    never loads the JAX package's library."""
    lib = native.get_lib()
    assert native.BUILD_DIR in lib._name
    assert "native/libslam_kernels.so" not in lib._name
    with open(native.SRC) as f:
        port_src = f.read()
    assert "extern \"C\"" in port_src and "union_find" in port_src
