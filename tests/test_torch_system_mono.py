"""The port's monocular System on the CPU against the JAX package's System.

The monocular sweep of tests/test_pipeline.py::TestMonocularPipeline and
tests/test_robustness.py::TestKidnapRecovery (400x300, 1000 features and
2000 for initialization, 500 landmarks, seed 3, step 0.025, the lateral
sweep over depths 1.5-4 m), cut to the kidnap test's 40 frames to keep
this file near two minutes, runs through the JAX System and through the
port's, both synchronous and without a vocabulary, the JAX side in 32-bit
mode (the port's precision), the port's on the fused route the card takes
(ORB_TPU_FUSED_TRACK=1). Their RANSAC draws differ (the port draws on the
host, geometry/ransac.py), so the two runs are held by outcome: both pass
the 0.02 x span scale-aligned ATE gate of tests/test_pipeline.py, with its
floors (3 keyframes, 150 points) and its tracked share (45 of 60 frames,
here 30 of 40).

Then, on the JAX run's own inputs:
- one monocular initialization (`_try_initialize_mono`) on the JAX run's
  carried reference and current frames (interop's frame_from_numpy), the
  port's sampler replaced by JAX's draws for the same key and mask: equal
  keyframe and point tables; before the global BA, keyframe 1's pose
  within 5e-4 deg / 1e-5 (in median-depth units: the float32 SVDs of the
  two-view decomposition give ~1e-4 deg apart, as in
  tests/test_torch_twoview.py) and the triangulated points within 1e-3
  of the largest coordinate (float32 DLT eigensolves); after the 20
  iterations of BA, tests/test_torch_ba.py's bounds: 1e-3 deg / 1e-4 and
  the points within 1e-3 of the largest coordinate (float32 LM steps
  summed in different orders);
- one relocalization (`_relocalize`) on the JAX run's map and frame from
  mid-sequence, with JAX's EPnP sample sets: the same ok, reference
  keyframe and bindings, the pose within 1e-4 deg / 1e-5 m (the pose LM
  converges from the two RANSAC poses, float32 apart, to the same pose).

The sweep renderer is held bit-equal to the JAX renderer, and the
monocular auto-reset of tests/test_reset.py runs through the port.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.geometry import twoview as jtwoview
from orb_slam2_commit_tpu.slam import system as jsystem
from orb_slam2_commit_tpu.slam import tracking as jtracking
from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models.map_state import MapState
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker, TrackingState
from orb_slam2_commit_tpu_torch.utils import synthetic, trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT, N_FRAMES = 400, 300, 1000, 40
SEQ = dict(n_frames=N_FRAMES, n_points=500, seed=3, step=0.025, motion="sweep",
           depth_range=(1.5, 4.0), spread=2.0)
ATE_SPAN = 0.02
TRACKED_SHARE = 0.75                 # 45 of 60 frames in tests/test_pipeline.py
MIN_KFS, MIN_POINTS = 3, 150
STEP_ROT_DEG_TOL, STEP_T_TOL = 1e-4, 1e-5     # relocalization's pose
INIT_ROT_DEG_TOL, INIT_T_TOL = 5e-4, 1e-5     # the two-view pose
BA_ROT_DEG_TOL, BA_T_TOL = 1e-3, 1e-4         # after the global BA
PTS_RTOL = 1e-3
RELOC_FRAME = 30
RELOC_KEY = 17


def rot_angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


class JaxSampler:
    """The JAX Tracker's RANSAC draws from its key chain: split the key,
    then `twoview._ransac_samples`, or one key per candidate and per round
    the `jax.random.choice` of `pnp.epnp_ransac`."""

    def __init__(self, key):
        self.key = key

    def twoview(self, valid, n_iters=200, size=8):
        with jax.enable_x64(False):
            self.key, sub = jax.random.split(self.key)
            return np.asarray(jtwoview._ransac_samples(sub, jnp.asarray(valid), n_iters))

    def pnp(self, valid, n_iters=128, size=4):
        with jax.enable_x64(False):
            self.key, sub = jax.random.split(self.key)
            keys = jax.random.split(sub, valid.shape[0])
            n = valid.shape[1]
            out = []
            for c in range(valid.shape[0]):
                p = jnp.asarray(valid[c], jnp.float32)
                p = p / jnp.maximum(jnp.sum(p), 1.0)
                out.append(np.asarray(jax.vmap(
                    lambda k: jax.random.choice(k, n, shape=(size,), replace=False, p=p))(
                    jax.random.split(keys[c], n_iters))))
            return np.stack(out)


def _ate(sys_, poses_gt):
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    ok = ~lost
    rmse = traj.ate_rmse(est[ok], gt[len(gt) - len(est):][ok], align_scale=True)
    return rmse, np.linalg.norm(gt[-1] - gt[0])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX System over the sweep, with its initialization (before and
    after the global BA) and a relocalization on its mid-sequence state
    recorded."""
    cfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT)
    images, poses_gt, _ = jsynthetic.render_sequence(cfg.camera, **SEQ)
    rec = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.delenv("ORB_TPU_FUSED_TRACK", raising=False)
        sys_ = jsystem.System(cfg, vocabulary=None, async_mapping=False)
        tracker = sys_.tracker
        track, global_ba = tracker.track, tracker._initial_global_ba

        def track_spy(frame, motion_ok=None):
            if frame.frame_id == RELOC_FRAME:
                rec["reloc_in"] = dict(map=copy.deepcopy(sys_.map), frame=copy.deepcopy(frame))
            if tracker.state not in (jtracking.TrackingState.NO_IMAGES_YET,
                                     jtracking.TrackingState.NOT_INITIALIZED):
                return track(frame, motion_ok)
            ref = tracker.init_ref_frame
            before = dict(ref=None if ref is None else interop.frame_to_numpy(ref),
                          frame=interop.frame_to_numpy(frame), key=tracker._rng_key)
            pose = track(frame, motion_ok)
            if tracker.state == jtracking.TrackingState.OK:
                rec["init_in"] = before
                rec["init_out"] = interop.map_state_to_numpy(sys_.map)
            return pose

        def global_ba_spy(kf0, kf1, n_iters=20):
            rec["init_pre_ba"] = interop.map_state_to_numpy(sys_.map)
            global_ba(kf0, kf1, n_iters)

        mp.setattr(tracker, "track", track_spy)
        mp.setattr(tracker, "_initial_global_ba", global_ba_spy)
        poses = [sys_.track_monocular(images[i], i / 30.0) for i in range(N_FRAMES)]
        assert sys_.tracker is tracker, "the JAX System reset"

        # JAX's relocalization of the frame at RELOC_FRAME against the map
        # just before it, on a tracker of its own.
        jt = jtracking.Tracker(cfg, copy.deepcopy(rec["reloc_in"]["map"]))
        jt._rng_key = jax.random.key(RELOC_KEY)
        frame = copy.deepcopy(rec["reloc_in"]["frame"])
        ok = jt._relocalize(frame)
        rec["reloc_out"] = dict(ok=ok, ref_kf=jt.ref_kf, point_ids=frame.point_ids.copy(),
                                R=frame.R, t=frame.t, n_inliers=jt.n_inliers)
    assert {"init_in", "init_pre_ba", "init_out", "reloc_in"} <= set(rec)
    return sys_, poses, rec, poses_gt


@pytest.fixture(scope="module")
def port_run():
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT)
    images, poses_gt, _ = synthetic.render_sequence(cfg.camera, **SEQ)
    before = dict(_build.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_TPU_FUSED_TRACK", "1")
        sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
        poses = [sys_.track_monocular(images[i], i / 30.0) for i in range(N_FRAMES)]
    assert _build.launches == before, "a kernel launched on the CPU"
    return sys_, poses, poses_gt


def test_sweep_renderer_equals_jax():
    """render_sequence's sweep, depth range, spread and planar fraction:
    bit-equal images, poses and scene."""
    cfg = synthetic_config(width=160, height=120, n_features=200)
    kw = dict(n_frames=5, n_points=80, seed=4, step=0.03, motion="sweep",
              depth_range=(1.5, 4.0), spread=2.0, planar_frac=0.3)
    images, poses, scene = synthetic.render_sequence(cfg.camera, **kw)
    jimages, jposes, jscene = jsynthetic.render_sequence(
        j_synthetic_config(width=160, height=120, n_features=200).camera, **kw)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(scene.points, jscene.points)
    np.testing.assert_array_equal(scene.patches, jscene.patches)
    for (R, t), (jR, jt) in zip(poses, jposes):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("run", ["jax_run", "port_run"])
def test_monocular_gates(run, request):
    out = request.getfixturevalue(run)
    sys_, poses, poses_gt = out[0], out[1], out[-1]
    assert sys_.tracking_state().name == "OK"
    assert sum(p is not None for p in poses) >= TRACKED_SHARE * N_FRAMES
    assert sys_.map.n_keyframes() >= MIN_KFS
    assert sys_.map.n_points() >= MIN_POINTS
    rmse, span = _ate(sys_, poses_gt)
    assert rmse < ATE_SPAN * span, (rmse, span)


def _assert_tables_equal(got, want):
    for k, w in want.items():
        g = got[k]
        if k in ("cfg", "loop_edges") or not isinstance(w, np.ndarray):
            assert g == w, k
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_geometry_close(got, want, rot_tol, t_tol):
    valid = want["pt_valid"]
    w = want["pt_pos"][valid]
    np.testing.assert_allclose(got["pt_pos"][valid], w, rtol=PTS_RTOL,
                               atol=PTS_RTOL * np.abs(w).max())
    for k in range(want["next_kf"]):
        assert rot_angle(got["kf_pose_R"][k], want["kf_pose_R"][k]) < rot_tol, k
        np.testing.assert_allclose(got["kf_pose_t"][k], want["kf_pose_t"][k], atol=t_tol)


def test_initialization_on_carried_frames_matches_jax(jax_run):
    _, _, rec, _ = jax_run
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT)
    i = rec["init_in"]
    ms = MapState.create(cfg.map, 2 * N_FEAT)
    tracker = Tracker(cfg, ms, device="cpu")
    tracker.sampler = JaxSampler(i["key"])
    tracker.state = TrackingState.NOT_INITIALIZED
    tracker.init_ref_frame = interop.frame_from_numpy(i["ref"], device="cpu")
    pre_ba = {}
    global_ba = tracker._initial_global_ba

    def global_ba_spy(kf0, kf1, n_iters=20):
        pre_ba.update(interop.map_state_to_numpy(ms))
        global_ba(kf0, kf1, n_iters)

    tracker._initial_global_ba = global_ba_spy
    before = dict(_build.launches)
    assert tracker._try_initialize_mono(interop.frame_from_numpy(i["frame"], device="cpu"))
    assert _build.launches == before
    assert tracker.state == TrackingState.OK and tracker.ref_kf == 1
    _assert_tables_equal(pre_ba, rec["init_pre_ba"])
    _assert_geometry_close(pre_ba, rec["init_pre_ba"], INIT_ROT_DEG_TOL, INIT_T_TOL)
    got = interop.map_state_to_numpy(ms)
    _assert_tables_equal(got, rec["init_out"])
    _assert_geometry_close(got, rec["init_out"], BA_ROT_DEG_TOL, BA_T_TOL)


def test_relocalization_on_carried_state_matches_jax(jax_run):
    _, _, rec, _ = jax_run
    out = rec["reloc_out"]
    assert out["ok"], "the JAX tracker relocalizes the mid-sequence frame"
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT)
    ms = interop.map_state_from_numpy(interop.map_state_to_numpy(rec["reloc_in"]["map"]))
    tracker = Tracker(cfg, ms, device="cpu")
    tracker.sampler = JaxSampler(jax.random.key(RELOC_KEY))
    frame = interop.frame_from_numpy(interop.frame_to_numpy(rec["reloc_in"]["frame"]),
                                     device="cpu")
    before = dict(_build.launches)
    ok = tracker._relocalize(frame)
    assert _build.launches == before
    assert ok == out["ok"]
    assert tracker.ref_kf == out["ref_kf"]
    assert tracker.last_reloc_frame_id == RELOC_FRAME
    np.testing.assert_array_equal(frame.point_ids, out["point_ids"])
    assert rot_angle(frame.R, out["R"]) < STEP_ROT_DEG_TOL
    np.testing.assert_allclose(frame.t, out["t"], atol=STEP_T_TOL)


def test_lost_after_init_triggers_auto_reset_and_recovers():
    """tests/test_reset.py's monocular auto-reset through the port: lost
    with a map of at most 5 keyframes -> a full reset, every stage rewired
    to the fresh map, and a second initialization from scratch."""
    cfg = synthetic_config(width=320, height=240, n_features=600)
    images, _, _ = synthetic.render_sequence(cfg.camera, n_frames=6, n_points=300, seed=5,
                                             step=0.05)
    sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
    for i in range(images.shape[0]):
        sys_.track_monocular(images[i], i / 30.0)
    assert sys_.tracking_state() == TrackingState.OK
    assert sys_.map.n_keyframes() <= 5
    garbage = np.random.default_rng(0).integers(0, 255, size=images[0].shape)
    assert sys_.track_monocular(garbage.astype(images.dtype), 1.0) is None
    assert sys_.tracking_state() in (TrackingState.NO_IMAGES_YET,
                                     TrackingState.NOT_INITIALIZED)
    assert sys_.map.n_keyframes() == 0
    assert sys_.tracker.map is sys_.map and sys_.mapper.map is sys_.map
    assert not sys_.tracker.request_reset
    for i in range(images.shape[0]):
        sys_.track_monocular(images[i], 2.0 + i / 30.0)
    assert sys_.tracking_state() == TrackingState.OK
    assert sys_.map.n_keyframes() >= 2
