"""The port's loop closer (slam/loop_closing.py) on the CPU against the JAX
package's, on carried state.

tests/test_loop_closing.py's drifted loop map (24 keyframes on a circle,
drift injected, the last ones revisiting the start) is built with the JAX
package and carried into the port (interop.map_state_from_numpy); both
sides get the same trained vocabulary (each package trains it from the
same descriptors with the same seed), and the port's RANSAC sampler
replays the JAX closer's key chain (jax.random.key(7), split once per
candidate that reaches the RANSAC, then one jax.random.choice a round), so
both see the same sample sets. The JAX side runs in 32-bit mode (the
port's precision). process_keyframe over all 24 keyframes:
- the same keyframe closes the loop, against the same loop keyframe, with
  the same loop count and loop edges, the same database rows and the same
  consistent groups after every keyframe;
- the same observation table, and keyframe poses within 0.1 deg and 0.01
  and points within 0.03 of JAX's after the closure (~0.4 of correction,
  points up to 14 from the origin). The essential graph leaves the poses
  as they were in both packages (on this map 40 of its 49 edges have a
  residual rotation that is the identity to rounding, where so3_log's
  arccos has an infinite derivative: their Jacobians are NaN and every LM
  step is rejected); the global BA that follows is monocular with one
  keyframe fixed, so its scale is free and float32 rounding walks along
  it: the
  port ends 0.033 deg / 0.003 / 0.0097 from JAX's 32-bit run, while JAX's
  own 32-bit and 64-bit runs end 0.13 deg / 0.014 / 0.036 apart. JAX
  solves global BA on one device here (ORB_DISTRIBUTED_GBA=0; the suite's
  8 virtual devices would shard it);
- the JAX test's own gates on the port: scale-aligned ATE after < 0.75 x
  before, rotation error < 2 deg.
The closing keyframe alone, on the JAX closer's state carried across just
before it (interop's map, database and loop-closer converters), closes
the same loop; so does the card's route there, its Sim3 pairs padded to a
power of two (LoopCloser.pad_pairs), held to the JAX closure up to its
global BA. Then tests/test_loop_closing.py's SearchBySim3
augmentation cases on both packages (the loop accepted only with the
augmentation, the same pairs recovered, each the true landmark's), and
one relocalization through the database branch (`Tracker._relocalize`
with the keyframe database) on the closed map, against the JAX tracker's
with its EPnP sample sets.
Nothing launches a kernel here."""

import contextlib
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models.kf_database import KeyFrameDatabase as JDatabase
from orb_slam2_commit_tpu.models.vocabulary import BinaryVocabulary as JVocabulary
from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.slam import loop_closing as jloop
from orb_slam2_commit_tpu.slam import tracking as jtracking
from orb_slam2_commit_tpu.utils.trajectory import ate_rmse
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase
from orb_slam2_commit_tpu_torch.models.vocabulary import BinaryVocabulary
from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.slam.frame import Frame
from orb_slam2_commit_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

sys.path.insert(0, str(Path(__file__).parent))
from test_loop_closing import (  # noqa: E402
    K_KF, TestSearchBySim3Augmentation, build_drifted_loop_map)
from test_torch_sim3 import OPT_TOL  # noqa: E402
from test_torch_system_mono import JaxSampler  # noqa: E402

torch.set_num_threads(1)

ROT_DEG_TOL, T_TOL, PT_TOL = 0.1, 0.01, 0.03


def rot_angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


class Sim3Sampler(JaxSampler):
    """The JAX LoopCloser's draws: split its key once per candidate, then
    sim3_ransac's one key a round and jax.random.choice of 3."""

    def sim3(self, valid, n_iters=128, size=3):
        with jax.enable_x64(False):
            self.key, sub = jax.random.split(self.key)
            n = valid.shape[0]
            p = jnp.asarray(valid, jnp.float32)
            p = p / jnp.maximum(jnp.sum(p), 1.0)
            return np.asarray(jax.vmap(lambda k: jax.random.choice(
                k, n, shape=(size,), replace=False, p=p))(jax.random.split(sub, n_iters)))


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


def _port_config(jcfg):
    cfg = synthetic_config(width=jcfg.camera.width, height=jcfg.camera.height,
                           n_features=jcfg.orb.n_features)
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, fx=jcfg.camera.fx, fy=jcfg.camera.fy))


def _centres(R, t):
    return -np.einsum("kba,kb->ka", R, t)


@contextlib.contextmanager
def _closure_recorded(cls, rec):
    """On a closer class's first closure inside the block: rec["sim3"] =
    correct_loop's (s, R, t, matches) and rec["pre_gba"] the map as
    run_global_ba gets it (after the Sim3 correction and the essential
    graph)."""
    correct, gba = cls.correct_loop, cls.run_global_ba

    def correct_spy(self, kf, loop_kf, s_cw, R_cw, t_cw, matches):
        rec.setdefault("sim3", (float(s_cw), np.array(R_cw), np.array(t_cw), dict(matches)))
        return correct(self, kf, loop_kf, s_cw, R_cw, t_cw, matches)

    def gba_spy(self, *args, **kwargs):
        rec.setdefault("pre_gba", interop.map_state_to_numpy(self.map))
        return gba(self, *args, **kwargs)

    cls.correct_loop, cls.run_global_ba = correct_spy, gba_spy
    try:
        yield rec
    finally:
        cls.correct_loop, cls.run_global_ba = correct, gba


@pytest.fixture(scope="module")
def loop_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_DISTRIBUTED_GBA", "0")
        return _loop_runs()


def _loop_runs():
    rng = np.random.default_rng(0)
    jcfg, jm, R_true, t_true, _ = build_drifted_loop_map(rng)
    train = rng.integers(0, 2 ** 32, size=(2000, 8), dtype=np.uint32)
    pm = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
    pre = (jm.kf_pose_R.copy(), jm.kf_pose_t.copy())

    jcloser = jloop.LoopCloser(jcfg, jm, JDatabase(JVocabulary.train(train, k=8, levels=3,
                                                                     seed=2),
                                                   jm.cfg.max_keyframes),
                               essential_min_weight=30)
    pcloser = LoopCloser(_port_config(jcfg), pm,
                         KeyFrameDatabase(BinaryVocabulary.train(train, k=8, levels=3, seed=2),
                                          pm.cfg.max_keyframes, device="cpu"),
                         essential_min_weight=30, device="cpu")
    pcloser.sampler = Sim3Sampler(jax.random.key(7))
    steps, carried, j_first = [], None, {}
    for k in range(K_KF):
        if carried is None:
            before = dict(map=interop.map_state_to_numpy(jm), key=jcloser._rng_key,
                          db=interop.database_to_numpy(jcloser.db),
                          closer=interop.loop_closer_state_to_numpy(jcloser))
        with jax.enable_x64(False), _closure_recorded(jloop.LoopCloser, j_first):
            j_closed = jcloser.process_keyframe(k)
        if j_closed and carried is None:
            carried = dict(before, kf=k, after=interop.map_state_to_numpy(jm), jax=j_first)
        p_closed = pcloser.process_keyframe(k)
        steps.append((k, j_closed, p_closed,
                      interop.loop_closer_state_to_numpy(jcloser),
                      interop.loop_closer_state_to_numpy(pcloser),
                      interop.database_to_numpy(jcloser.db),
                      interop.database_to_numpy(pcloser.db)))
    return dict(jm=jm, pm=pm, jcloser=jcloser, pcloser=pcloser, steps=steps, pre=pre,
                R_true=R_true, t_true=t_true, jcfg=jcfg, carried=carried)


def test_same_loop_closed(loop_runs):
    for k, j_closed, p_closed, js, ps, jdb, pdb in loop_runs["steps"]:
        assert p_closed == j_closed, k
        assert ps == js, k
        np.testing.assert_array_equal(pdb["present"], jdb["present"])
        np.testing.assert_array_equal(pdb["word_ids"], jdb["word_ids"])
        np.testing.assert_allclose(pdb["weights"], jdb["weights"], atol=1e-6, rtol=0)
    closed = [k for k, j_closed, *_ in loop_runs["steps"] if j_closed]
    assert closed and closed[0] >= 13
    jm, pm = loop_runs["jm"], loop_runs["pm"]
    assert pm.loop_edges == jm.loop_edges and pm.loop_edges
    assert pm.big_change_idx == jm.big_change_idx >= 1
    assert loop_runs["pcloser"].n_loops_closed == loop_runs["jcloser"].n_loops_closed
    assert [s["loop_kf"] for s in loop_runs["pcloser"].correction_stats] == \
        [s["loop_kf"] for s in loop_runs["jcloser"].correction_stats]


def test_poses_and_points_match_jax(loop_runs):
    jm, pm = loop_runs["jm"], loop_runs["pm"]
    worst = max(rot_angle(pm.kf_pose_R[k], jm.kf_pose_R[k]) for k in range(K_KF))
    dt = np.abs(pm.kf_pose_t[:K_KF] - jm.kf_pose_t[:K_KF]).max()
    assert worst < ROT_DEG_TOL and dt < T_TOL, (worst, dt)
    np.testing.assert_array_equal(pm.kf_point_idx, jm.kf_point_idx)
    np.testing.assert_array_equal(pm.pt_valid, jm.pt_valid)
    pts = np.where(jm.pt_valid)[0]
    assert np.abs(pm.pt_pos[pts] - jm.pt_pos[pts]).max() < PT_TOL


def test_closing_keyframe_on_carried_state(loop_runs):
    """The JAX closer's state just before its closing keyframe (map,
    database rows, consistent groups, key chain) carried into a fresh
    port closer (interop's converters): one process_keyframe closes the
    same loop, with the same observation table and the poses within the
    bounds above."""
    c, pcloser = loop_runs["carried"], loop_runs["pcloser"]
    pm = interop.map_state_from_numpy(c["map"])
    closer = LoopCloser(pcloser.config, pm,
                        interop.database_from_numpy(c["db"], pcloser.db.voc, device="cpu"),
                        device="cpu")
    interop.loop_closer_state_into(closer, c["closer"])
    closer.sampler = Sim3Sampler(c["key"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_DISTRIBUTED_GBA", "0")
        assert closer.process_keyframe(c["kf"])
    want = c["after"]
    got = interop.map_state_to_numpy(pm)
    assert got["loop_edges"] == want["loop_edges"] and closer.n_loops_closed == 1
    np.testing.assert_array_equal(got["kf_point_idx"], want["kf_point_idx"])
    worst = max(rot_angle(got["kf_pose_R"][k], want["kf_pose_R"][k]) for k in range(c["kf"] + 1))
    assert worst < ROT_DEG_TOL
    assert np.abs(got["kf_pose_t"] - want["kf_pose_t"]).max() < T_TOL


def test_closing_keyframe_padded_pairs_on_carried_state(loop_runs):
    """The card's route of the closing keyframe on the JAX closer's
    carried state: the Sim3 pairs padded to a power of two
    (LoopCloser.pad_pairs, the card's default; `valid` False on the
    padding). It closes the same loop with the same observation table and
    point validity; the Sim3 it hands correct_loop, with the same matches,
    within tests/test_torch_sim3.py's OPT_TOL of JAX's, and the map that
    global BA gets (the Sim3 propagated, the essential graph) within 1e-3
    deg and OPT_TOL of JAX's (measured: 3e-6 in s and 7e-6 in t; 2e-5 deg,
    9e-6 in t, 2e-5 in the points). After the global BA, which is
    monocular with its scale free, the drift gates of
    test_drift_removed_gates over the keyframes so far, not the bounds
    above: the padding moves the Sim3 LM's sums by a few ulps (their
    reduction trees follow the length), and that global BA carries such a
    move to 0.037 deg, 0.058 in t and 0.26 in the points from JAX's (the
    unpadded route: 0.014 deg, 0.0027, 0.0097; JAX's own float32 and
    float64 runs of this closure: 0.029 deg, 0.014, 0.036)."""
    c, pcloser = loop_runs["carried"], loop_runs["pcloser"]
    pm = interop.map_state_from_numpy(c["map"])
    closer = LoopCloser(pcloser.config, pm,
                        interop.database_from_numpy(c["db"], pcloser.db.voc, device="cpu"),
                        device="cpu")
    interop.loop_closer_state_into(closer, c["closer"])
    closer.sampler = Sim3Sampler(c["key"])
    closer.pad_pairs = True
    with pytest.MonkeyPatch.context() as mp, _closure_recorded(LoopCloser, {}) as rec:
        mp.setenv("ORB_DISTRIBUTED_GBA", "0")
        assert closer.process_keyframe(c["kf"])
    want, got = c["after"], interop.map_state_to_numpy(pm)
    assert got["loop_edges"] == want["loop_edges"] and closer.n_loops_closed == 1
    np.testing.assert_array_equal(got["kf_point_idx"], want["kf_point_idx"])
    np.testing.assert_array_equal(got["pt_valid"], want["pt_valid"])

    (s, R, t, matches), (js, jR, jt, jmatches) = rec["sim3"], c["jax"]["sim3"]
    assert matches == jmatches
    assert abs(s - js) < OPT_TOL
    assert np.abs(R - jR).max() < OPT_TOL and np.abs(t - jt).max() < OPT_TOL
    pre, jpre = rec["pre_gba"], c["jax"]["pre_gba"]
    n = c["kf"] + 1
    assert max(rot_angle(pre["kf_pose_R"][k], jpre["kf_pose_R"][k]) for k in range(n)) < 1e-3
    assert np.abs(pre["kf_pose_t"][:n] - jpre["kf_pose_t"][:n]).max() < OPT_TOL
    pts = np.where(jpre["pt_valid"])[0]
    assert np.abs(pre["pt_pos"][pts] - jpre["pt_pos"][pts]).max() < OPT_TOL

    c_true = _centres(loop_runs["R_true"][:n], loop_runs["t_true"][:n])
    before, after = c["map"], got
    ate_pre = ate_rmse(_centres(before["kf_pose_R"][:n], before["kf_pose_t"][:n]), c_true,
                       align_scale=True)
    ate_post = ate_rmse(_centres(after["kf_pose_R"][:n], after["kf_pose_t"][:n]), c_true,
                        align_scale=True)
    assert ate_post < 0.75 * ate_pre, (ate_pre, ate_post)
    assert max(rot_angle(loop_runs["R_true"][k], after["kf_pose_R"][k]) for k in range(n)) < 2.0


def test_drift_removed_gates(loop_runs):
    """tests/test_loop_closing.py::test_drift_removed's gates, on the port."""
    pm, (pre_R, pre_t) = loop_runs["pm"], loop_runs["pre"]
    R_true, t_true = loop_runs["R_true"], loop_runs["t_true"]
    c_true = _centres(R_true, t_true)
    ate_pre = ate_rmse(_centres(pre_R[:K_KF], pre_t[:K_KF]), c_true, align_scale=True)
    ate_post = ate_rmse(_centres(pm.kf_pose_R[:K_KF], pm.kf_pose_t[:K_KF]), c_true,
                        align_scale=True)
    assert ate_post < 0.75 * ate_pre, (ate_pre, ate_post)
    max_rot = max(rot_angle(R_true[k], pm.kf_pose_R[k]) for k in range(K_KF))
    assert max_rot < 2.0, max_rot
    assert pm.has_loop_edge(pm.loop_edges[0][0]) and pm.has_loop_edge(pm.loop_edges[0][1])


# ---------------------------------------------------------------------------
# SearchBySim3 augmentation (tests/test_loop_closing.py:194-300)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def augmentation_pair():
    case = TestSearchBySim3Augmentation()
    jcfg, jm, kf_a, kf_b = case._build_two_kf_map()
    train = np.random.default_rng(5).integers(0, 2 ** 32, size=(500, 8), dtype=np.uint32)
    jcloser = jloop.LoopCloser(jcfg, jm, JDatabase(JVocabulary.train(train, k=4, levels=2,
                                                                     seed=2),
                                                   jm.cfg.max_keyframes))
    pm = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
    cfg = synthetic_config(width=640, height=480, n_features=case.N)
    pcloser = LoopCloser(cfg, pm, KeyFrameDatabase(BinaryVocabulary.train(
        train, k=4, levels=2, seed=2), pm.cfg.max_keyframes, device="cpu"), device="cpu")
    pcloser.sampler = Sim3Sampler(jax.random.key(7))
    return case, jcloser, pcloser, kf_a, kf_b


@pytest.mark.parametrize("augmented", [False, True])
def test_search_by_sim3_augmentation(augmentation_pair, augmented):
    case, jcloser, pcloser, kf_a, kf_b = augmentation_pair
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    outs = []
    for closer, x64 in ((jcloser, False), (pcloser, None)):
        orig = closer._search_by_sim3
        if not augmented:
            closer._search_by_sim3 = lambda *a, **k: empty
        try:
            if x64 is None:
                outs.append(closer.compute_sim3(kf_a, [kf_b]))
            else:
                with jax.enable_x64(x64):
                    outs.append(closer.compute_sim3(kf_a, [kf_b]))
        finally:
            closer._search_by_sim3 = orig
    (j_ok, j_kf, *_, j_matches), (p_ok, p_kf, s_cw, R_cw, t_cw, p_matches) = outs
    assert p_ok == j_ok == augmented
    if augmented:
        assert p_kf == j_kf == kf_b
        assert p_matches == j_matches and len(p_matches) >= 40
        noisy = set(range(case.N_CLEAN, case.N_CLEAN + case.N_NOISY))
        assert len(noisy & set(p_matches)) >= 20


def test_search_by_sim3_mutual_pairs(augmentation_pair):
    """The true relative pose recovers >= 40 mutual pairs, each binding a
    feature to the one observing the same landmark, as JAX's do."""
    _, jcloser, pcloser, kf_a, kf_b = augmentation_pair
    m = pcloser.map
    R_ab = m.kf_pose_R[kf_a] @ m.kf_pose_R[kf_b].T
    t_ab = m.kf_pose_t[kf_a] - R_ab @ m.kf_pose_t[kf_b]
    seed1 = np.arange(5)
    got = pcloser._search_by_sim3(kf_a, kf_b, 1.0, R_ab, t_ab, seed1, seed1)
    with jax.enable_x64(False):
        want = jcloser._search_by_sim3(kf_a, kf_b, 1.0, R_ab, t_ab, seed1, seed1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].size >= 40
    np.testing.assert_array_equal(got[0], got[1])


def _match_pair(seed):
    """(ab idx, ab dist, ba idx, ba dist): a small hand-made pair (seed
    None), or a seeded random one over 200 rows and 150 columns with a
    third of each side's rows invalid and half of the valid a -> b matches
    pointed back to."""
    big = matching.BIG_DIST
    if seed is None:
        return [2, 0, -1, 1], [5, 6, big, 7], [1, 2, 0], [6, 9, 5]
    rng = np.random.default_rng(seed)
    n_a, n_b = 200, 150
    ab = rng.integers(0, n_b, n_a)
    ba = rng.integers(0, n_a, n_b)
    back = np.where(rng.uniform(size=n_a) < 0.5)[0]
    ba[ab[back]] = back
    ab[rng.uniform(size=n_a) < 1 / 3] = -1
    ba[rng.uniform(size=n_b) < 1 / 3] = -1
    return (ab, np.where(ab >= 0, rng.integers(0, 100, n_a), big),
            ba, np.where(ba >= 0, rng.integers(0, 100, n_b), big))


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_mutual_consistency(seed):
    """ops/matching.mutual_consistency (SearchBySim3's cross-check, run by
    LoopCloser._search_by_sim3) against the JAX package's on the same
    pair: idx and dist exactly equal."""
    ab_i, ab_d, ba_i, ba_d = (np.asarray(a, np.int32) for a in _match_pair(seed))
    got = matching.mutual_consistency(
        matching.MatchResult(idx=torch.from_numpy(ab_i), dist=torch.from_numpy(ab_d)),
        matching.MatchResult(idx=torch.from_numpy(ba_i), dist=torch.from_numpy(ba_d)))
    want = jmatching.mutual_consistency(
        jmatching.MatchResult(idx=jnp.asarray(ab_i), dist=jnp.asarray(ab_d)),
        jmatching.MatchResult(idx=jnp.asarray(ba_i), dist=jnp.asarray(ba_d)))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    kept = got.idx.numpy() >= 0
    assert kept.any() and (~kept & (ab_i >= 0)).any()


# ---------------------------------------------------------------------------
# Relocalization through the keyframe database
# ---------------------------------------------------------------------------

def test_relocalize_with_database(loop_runs):
    """One `_relocalize` with the database branch on the JAX run's closed
    map and database, carried across (interop.map_state_from_numpy,
    database_from_numpy): a frame seen from keyframe 6's pose (its
    features, a third of them dropped), its candidates from
    detect_relocalization_candidates. Against the JAX tracker with its
    EPnP sample sets: the same candidates, ok, reference keyframe and
    bindings, and the pose within 1e-4 deg / 1e-5."""
    jm, jcloser, pcloser = loop_runs["jm"], loop_runs["jcloser"], loop_runs["pcloser"]
    pm = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
    pdb = interop.database_from_numpy(interop.database_to_numpy(jcloser.db), pcloser.db.voc,
                                      device="cpu")
    k = 6
    valid = jm.kf_feat_valid[k].copy()
    valid[::3] = False
    n = valid.size
    feats = dict(xy=jm.kf_xy[k].astype(np.float32), xy_raw=jm.kf_xy[k].astype(np.float32),
                 octave=jm.kf_octave[k].copy(), angle=jm.kf_angle[k].copy(),
                 response=np.ones(n, np.float32), desc=jm.kf_desc[k].copy(), valid=valid,
                 depth=np.full(n, -1.0, np.float32), ur=np.full(n, -1.0, np.float32))
    jframe = jtracking.Frame(frame_id=100, timestamp=100.0,
                             **{a: b.copy() for a, b in feats.items()})
    pframe = Frame(frame_id=100, timestamp=100.0, **{a: b.copy() for a, b in feats.items()})

    key = jax.random.key(11)
    with jax.enable_x64(False):
        jt = jtracking.Tracker(loop_runs["jcfg"], jm)
        jt.kf_database = jcloser.db
        jt._rng_key = key
        j_ok = jt._relocalize(jframe)
    pt = Tracker(pcloser.config, pm, device="cpu")
    pt.kf_database = pdb
    pt.sampler = JaxSampler(key)
    p_ok = pt._relocalize(pframe)
    assert p_ok == j_ok is True
    assert pt.ref_kf == jt.ref_kf
    np.testing.assert_array_equal(pframe.point_ids, jframe.point_ids)
    assert rot_angle(pframe.R, jframe.R) < 1e-4
    assert np.abs(pframe.t - jframe.t).max() < 1e-5
    cands = pdb.detect_relocalization_candidates(pframe)
    assert cands == jcloser.db.detect_relocalization_candidates(jframe) and cands
