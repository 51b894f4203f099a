"""The port's keyframe database (models/kf_database.py) on the CPU against
the JAX package's: tests/test_loop_closing.py's drifted loop map (built
with the JAX package, carried across with interop.map_state_from_numpy)
and its trained vocabulary (trained by each package from the same
descriptors) go through the same add / erase / grow / clear sequence on
both sides. After each step every keyframe's loop candidates (at several
minimum scores) and every keyframe's relocalization candidates (from its
descriptors, with some features invalid) come out as the same lists in
the same order, and the sparse rows and scores agree within 1e-6.
Nothing launches a kernel here."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models.kf_database import KeyFrameDatabase as JDatabase
from orb_slam2_commit_tpu.models.vocabulary import BinaryVocabulary as JVocabulary
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase
from orb_slam2_commit_tpu_torch.models.vocabulary import BinaryVocabulary

sys.path.insert(0, str(Path(__file__).parent))
from test_loop_closing import K_KF, build_drifted_loop_map  # noqa: E402

torch.set_num_threads(1)

SCORE_TOL = 1e-6
MIN_SCORES = (0.0, 0.05, 0.2)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    _, jm, _, _, _ = build_drifted_loop_map(rng)
    train = rng.integers(0, 2 ** 32, size=(2000, 8), dtype=np.uint32)
    jv = JVocabulary.train(train, k=8, levels=3, seed=2)
    pv = BinaryVocabulary.train(train, k=8, levels=3, seed=2)
    pm = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
    return jm, pm, jv, pv


def _frames(m):
    """Relocalization queries: each keyframe's features, every fifth one
    invalid."""
    out = []
    for k in range(m.next_kf):
        valid = m.kf_feat_valid[k].copy()
        valid[::5] = False
        out.append(types.SimpleNamespace(desc=m.kf_desc[k].copy(), valid=valid))
    return out


def _check_same(jdb, pdb, jm, pm):
    np.testing.assert_array_equal(pdb.present, jdb.present)
    if jdb.word_ids is None:
        assert pdb.word_ids is None
        return 0
    np.testing.assert_array_equal(pdb.word_ids, jdb.word_ids)
    np.testing.assert_allclose(pdb.weights, jdb.weights, atol=SCORE_TOL, rtol=0)
    n_lists = 0
    for k in np.where(jdb.present)[0]:
        q = pdb.kf_bow(int(k))
        for a, b in zip(pdb._common_words_and_scores(*q),
                        jdb._common_words_and_scores(*jdb.kf_bow(int(k)))):
            np.testing.assert_allclose(a, b, atol=SCORE_TOL, rtol=0)
        for other in np.where(jdb.present)[0][:4]:
            assert abs(pdb.score_between(int(k), int(other))
                       - jdb.score_between(int(k), int(other))) < SCORE_TOL
        for s in MIN_SCORES:
            got = pdb.detect_loop_candidates(pm, int(k), s)
            assert got == jdb.detect_loop_candidates(jm, int(k), s), (k, s)
            n_lists += bool(got)
    for f in _frames(pm):
        got = pdb.detect_relocalization_candidates(f)
        assert got == jdb.detect_relocalization_candidates(f)
        n_lists += bool(got)
    return n_lists


def test_database_sequence(pair):
    jm, pm, jv, pv = pair
    jdb = JDatabase(jv, jm.cfg.max_keyframes)
    pdb = KeyFrameDatabase(pv, pm.cfg.max_keyframes, device="cpu")
    assert _check_same(jdb, pdb, jm, pm) == 0
    steps = [("add", k) for k in range(K_KF)] + [
        ("erase", 3), ("erase", 17), ("grow", 96), ("add", 3), ("erase", 0)]
    for i, (op, arg) in enumerate(steps):
        for db, m in ((jdb, jm), (pdb, pm)):
            if op == "add":
                db.add(arg, m.kf_desc[arg], m.kf_feat_valid[arg])
            elif op == "erase":
                db.erase(arg)
            else:
                db.grow("keyframes", arg)
                db.grow("points", 4 * arg)       # another capacity: no change
        if op != "add" or arg in (5, 12, K_KF - 1):
            n_lists = _check_same(jdb, pdb, jm, pm)
    assert pdb.present.shape == (96,) and n_lists > 10
    jdb.clear()
    pdb.clear()
    assert _check_same(jdb, pdb, jm, pm) == 0
    assert pdb.detect_relocalization_candidates(_frames(pm)[0]) == []


def test_database_carried_across(pair):
    """A JAX database's rows carried into the port answer as the JAX one."""
    jm, pm, jv, pv = pair
    jdb = JDatabase(jv, jm.cfg.max_keyframes)
    for k in range(0, K_KF, 2):
        jdb.add(k, jm.kf_desc[k], jm.kf_feat_valid[k])
    pdb = interop.database_from_numpy(interop.database_to_numpy(jdb), pv, device="cpu")
    assert _check_same(jdb, pdb, jm, pm) > 0
