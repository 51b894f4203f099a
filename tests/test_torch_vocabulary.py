"""The port's BoW vocabulary (models/vocabulary.py) on the CPU against the
JAX package's:
- the bundled data/default_voc.npz loads to equal tables in both packages
  (the port reads it by path);
- transform on 2000 seeded descriptors (random ones, and keyframe-like
  ones: perturbed copies of tree nodes, which reach every level's close
  calls) gives exactly JAX's word and node ids, with invalid features at
  -1, for levels_up 0, 2 and the whole depth;
- train(seed) builds the same tree as JAX's;
- bow_vector, score, sparse_bow and sparse_score within 1e-6;
- the text and npz round trips give the same tables, and the port reads
  the files the JAX package writes.
Nothing launches a kernel here."""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models import vocabulary as jvoc
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models import vocabulary as voc_mod
from orb_slam2_commit_tpu_torch.models.vocabulary import BinaryVocabulary

torch.set_num_threads(1)

SCORE_TOL = 1e-6
FIELDS = ("k", "levels", "children", "node_desc", "node_level", "word_id", "word_weight",
          "n_words")


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def _assert_same_tables(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def default_pair():
    return jvoc.default_vocabulary(), voc_mod.default_vocabulary()


@pytest.fixture(scope="module")
def trained_pair():
    train = _rand_desc(np.random.default_rng(0), 3000)
    return (jvoc.BinaryVocabulary.train(train, k=8, levels=3, seed=1),
            BinaryVocabulary.train(train, k=8, levels=3, seed=1))


def test_default_vocabulary_tables(default_pair):
    j, p = default_pair
    assert (p.k, p.levels, p.children.shape[0], p.n_words) == (10, 6, 703481, 614815)
    _assert_same_tables(j, p)
    assert voc_mod.default_vocabulary() is p          # loaded once a process


def _keyframe_like(voc, rng, n):
    """Perturbed copies of random tree nodes (1-12 bits flipped): features
    near the centroids, where the descent's first-minimum rule decides."""
    nodes = voc.node_desc[rng.integers(1, voc.node_desc.shape[0], n)].copy()
    for i in range(n):
        for b in rng.choice(256, rng.integers(1, 13), replace=False):
            nodes[i, b // 32] ^= np.uint32(1 << (b % 32))
    return nodes


@pytest.mark.parametrize("kind", ["random", "keyframe-like"])
@pytest.mark.parametrize("levels_up", [0, 2, 6])
def test_transform_default_exact(default_pair, kind, levels_up):
    j, p = default_pair
    rng = np.random.default_rng(7)
    desc = _rand_desc(rng, 2000) if kind == "random" else _keyframe_like(p, rng, 2000)
    valid = rng.uniform(size=2000) < 0.9
    jw, jn = j.transform(desc, valid, levels_up=levels_up)
    pw, pn = p.transform(desc, valid, levels_up=levels_up, device="cpu")
    np.testing.assert_array_equal(pw, np.asarray(jw))
    np.testing.assert_array_equal(pn, np.asarray(jn))
    assert (pw[~valid] == -1).all() and (pn[~valid] == -1).all()
    assert (pw[valid] >= 0).all()
    # A tensor input descends to the same words.
    tw, _ = p.transform(interop.to_device(desc, "cpu"), valid, levels_up=levels_up,
                        device="cpu")
    np.testing.assert_array_equal(tw, pw)


def test_popcount_matches_numpy():
    rng = np.random.default_rng(3)
    words = _rand_desc(rng, 512)
    want = voc_mod._popcount_rows(words)
    got = voc_mod._popcount32(interop.to_device(words, "cpu")).sum(-1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,levels,seed", [(8, 3, 1), (4, 2, 2), (10, 2, 0)])
def test_train_same_tree(k, levels, seed):
    train = _rand_desc(np.random.default_rng(seed + 10), 1500)
    _assert_same_tables(jvoc.BinaryVocabulary.train(train, k=k, levels=levels, seed=seed),
                        BinaryVocabulary.train(train, k=k, levels=levels, seed=seed))


def test_transform_trained_exact(trained_pair):
    j, p = trained_pair
    rng = np.random.default_rng(4)
    desc = _rand_desc(rng, 2000)
    valid = np.ones(2000, bool)
    valid[::7] = False
    for a, b in zip(p.transform(desc, valid, device="cpu"), j.transform(desc, valid)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_bow_and_scores(trained_pair):
    j, p = trained_pair
    rng = np.random.default_rng(5)
    w1 = rng.integers(-1, p.n_words, 400)
    w2 = np.concatenate([w1[:200], rng.integers(-1, p.n_words, 200)])
    np.testing.assert_allclose(p.bow_vector(w1), j.bow_vector(w1), atol=SCORE_TOL, rtol=0)
    assert abs(p.score(p.bow_vector(w1), p.bow_vector(w2))
               - j.score(j.bow_vector(w1), j.bow_vector(w2))) < SCORE_TOL
    s1, s2 = p.sparse_bow(w1), p.sparse_bow(w2)
    for a, b in zip(s1, j.sparse_bow(w1)):
        np.testing.assert_allclose(a, b, atol=SCORE_TOL, rtol=0)
    got = p.sparse_score(*s1, *s2)
    assert abs(got - j.sparse_score(*j.sparse_bow(w1), *j.sparse_bow(w2))) < SCORE_TOL
    # The sparse score is the dense one.
    assert abs(got - p.score(p.bow_vector(w1), p.bow_vector(w2))) < SCORE_TOL
    # Padding entries and empty vectors.
    pad_uw = np.concatenate([s2[0], -np.ones(5, np.int64)])
    pad_wt = np.concatenate([s2[1], np.zeros(5, np.float32)])
    assert abs(p.sparse_score(*s1, pad_uw, pad_wt) - got) < SCORE_TOL
    assert p.sparse_score(*p.sparse_bow(-np.ones(4, np.int64)), *s2) == 0.0


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_round_trips_across_packages(trained_pair, tmp_path, fmt):
    j, p = trained_pair
    mine, theirs = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    (p.save_npz if fmt == "npz" else p.save_text)(str(mine))
    (j.save_npz if fmt == "npz" else j.save_text)(str(theirs))
    back = voc_mod.load_vocabulary(str(mine))
    if fmt == "npz":
        _assert_same_tables(back, p)
    else:
        # The text rows carry no internal-node order beyond the parent
        # links and weights to float precision: the tree and the words
        # come back, and so do the descents.
        for f in ("children", "node_desc", "node_level", "word_id"):
            np.testing.assert_array_equal(getattr(back, f), getattr(p, f), err_msg=f)
        np.testing.assert_allclose(back.word_weight, p.word_weight, rtol=1e-6)
    assert mine.read_bytes() == theirs.read_bytes() or fmt == "npz"
    _assert_same_tables(voc_mod.load_vocabulary(str(theirs)), jvoc.load_vocabulary(str(theirs)))
