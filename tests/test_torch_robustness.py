"""tests/test_robustness.py against the port, on the CPU.

TestLocalWindowSpanningTree: UpdateLocalKeyFrames adds the spanning-tree
children and parent of the covisibility window (reference
src/Tracking.cc:1573-1621), the escape hatch when covisibility alone
starves. The same hand-made map (a keyframe whose only link to the
frame's points is below the covisibility threshold, one that shares
nothing) goes through the port's Tracker and the JAX package's, and both
give the same local window, holding the child and the parent.

TestRotationDominant and TestKidnapRecovery run the port's System alone
(synchronous, one thread), at the JAX tests' sizes and gates: the JAX
package's own tests run its System on them.
- The 60-frame arc (render_loop_sequence(frac=0.6, seed=4), 400x300 / 500
  features, min_matches_init=60): tracked >= 40, tracking OK at the end,
  more than 300 points, ATE under 3% of the span; at frame 13 the tracker
  tracks against the reference keyframe of the map made at frame 12, as
  the JAX System does.
- The initial map's BA on that arc, on the port's own state just before
  it (two keyframes, 112 points, 224 observations) and in the JAX
  package's BA on the same problem (32-bit and 64-bit mode): the same
  inlier flags, every point in front of both cameras, the cost within
  tests/test_torch_ba.py's 1% (+1e-4). Its 20 LM iterations halve the
  damping under float32's epsilon, where a float32 step loses it and a
  monocular map's free scale leaves the Schur system singular up to
  rounding; the port takes the float64 step there (optim/ba.py
  _solve_step). With the float32 step at every iteration instead, the
  same BA steps along the scale at its 17th iteration and puts every
  point behind the cameras (cost 0, no inlier), which unbound the map and
  reset the System at frame 13.
- The kidnap: the 40-frame sweep with frames 22-26 blank, the bundled
  vocabulary (data/default_voc.npz): LOST during the blank frames,
  relocalized through the keyframe database (last_reloc_frame_id >= 27),
  OK at the end, and the poses after recovery within 5% of the span of
  the ground truth in the frame fixed by the poses before it.
"""

import dataclasses
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models.map_state import MapState as JMapState
from orb_slam2_commit_tpu.optim import ba as jba
from orb_slam2_commit_tpu.optim.residuals import BAObservations as JObs
from orb_slam2_commit_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_commit_tpu.utils.config import MapConfig as JMapConfig
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models.map_state import INVALID, MapState
from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.slam import tracking
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker, TrackingState, build_ba_problem
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils import trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import MapConfig, synthetic_config

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_ba import COST_RTOL  # noqa: E402

torch.set_num_threads(1)

N = 32


def _map(map_cls, map_cfg):
    m = map_cls.create(map_cfg(max_keyframes=8, max_points=256), N)

    def add_kf(bound_pids):
        fvalid = np.zeros(N, bool)
        binding = np.full(N, INVALID, np.int32)
        fvalid[:len(bound_pids)] = True
        binding[:len(bound_pids)] = bound_pids
        return m.add_keyframe(
            np.eye(3), np.zeros(3), np.zeros((N, 2)), np.zeros(N, np.int32),
            np.zeros(N, np.float32), np.zeros((N, 8), np.uint32), fvalid, binding,
            frame_id=m.next_kf, timestamp=float(m.next_kf))

    # KF0 observes points 0-19; KF1 shares only 5 with KF0 (below the
    # covisibility threshold 15) but is KF0's spanning-tree child; KF2 is
    # KF0's parent, sharing nothing.
    pids = m.add_points(np.random.default_rng(0).uniform(-1, 1, (40, 3)) + [0, 0, 5],
                        first_kf=0)
    kf0 = add_kf(pids[:20])
    kf1 = add_kf(pids[15:20].tolist() + pids[20:35].tolist())
    kf2 = add_kf(pids[35:40])
    m.kf_parent[kf1] = kf0
    m.kf_parent[kf0] = kf2
    return m, pids, (kf0, kf1, kf2)


@pytest.mark.parametrize("sensor", ["monocular", "rgbd"])
def test_tree_links_expand_starved_window(sensor):
    m, pids, (kf0, kf1, kf2) = _map(MapState, MapConfig)
    jm, _, _ = _map(JMapState, JMapConfig)
    frame = types.SimpleNamespace(point_ids=np.asarray(pids[:15], np.int32))
    cfg = synthetic_config(width=320, height=240, n_features=N, sensor=sensor)
    jcfg = j_synthetic_config(width=320, height=240, n_features=N, sensor=sensor)
    local = Tracker(cfg, m, device="cpu")._local_keyframes(frame)
    want = JTracker(jcfg, jm)._local_keyframes(frame)
    np.testing.assert_array_equal(local, np.asarray(want))
    assert {kf0, kf1, kf2} <= set(local.tolist())


def _arc_config():
    cfg = synthetic_config(width=400, height=300, n_features=500)
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, min_matches_init=60))


@pytest.fixture(scope="module")
def arc_run():
    """The port's System over the arc, with the map just before its
    initial BA and each reference-keyframe tracking's outcome recorded."""
    cfg = _arc_config()
    images, poses_gt, _ = synthetic.render_loop_sequence(cfg.camera, n_frames=60, frac=0.6,
                                                         seed=4)
    rec = {"ref_kf": []}
    initial_ba, track_ref = Tracker._initial_global_ba, Tracker._track_reference_keyframe

    def initial_ba_spy(self, kf0, kf1, n_iters=20):
        rec.setdefault("pre_ba", (interop.map_state_to_numpy(self.map), kf0, kf1))
        return initial_ba(self, kf0, kf1, n_iters)

    def track_ref_spy(self, frame):
        ok = track_ref(self, frame)
        rec["ref_kf"].append((frame.frame_id, ok))
        return ok

    before = dict(_build.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Tracker, "_initial_global_ba", initial_ba_spy)
        mp.setattr(Tracker, "_track_reference_keyframe", track_ref_spy)
        sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
        poses = [sys_.track_monocular(images[i], i / 30.0) for i in range(60)]
    assert _build.launches == before, "a kernel launched on the CPU"
    return sys_, poses, poses_gt, rec


def test_tracks_rotation_dominant_arc(arc_run):
    sys_, poses, poses_gt, rec = arc_run
    tracked = sum(p is not None for p in poses)
    assert sys_.tracking_state() == TrackingState.OK
    assert tracked >= 40, tracked
    assert sys_.map.n_points() > 300, sys_.map.n_points()
    # Initialized at frame 12; frame 13 fails the motion model and tracks
    # against the reference keyframe, as in the JAX System.
    assert rec["pre_ba"][0]["kf_frame_id"][rec["pre_ba"][2]] == 12
    assert (13, True) in rec["ref_kf"], rec["ref_kf"][:3]
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    rmse = traj.ate_rmse(est[~lost], gt[len(gt) - len(est):][~lost], align_scale=True)
    span = np.abs(gt).max() * 2
    assert rmse < 0.03 * span, (rmse, span)


def _initial_ba(problem, cam, wide=True):
    """The initial BA's solve (Tracker._initial_global_ba's arguments);
    wide=False takes the float32 step at every iteration."""
    config = ba._solve_config

    def narrow(*args, **kwargs):
        return config(*args, **kwargs)._replace(wide=False)

    with pytest.MonkeyPatch.context() as mp:
        if not wide:
            mp.setattr(ba, "_solve_config", narrow)
        return ba.bundle_adjust_jit(problem, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                    n_iters=20, point_chunk=512)


def test_initial_ba_on_carried_state_matches_jax(arc_run):
    cfg = _arc_config()
    cam = cfg.camera
    pre, kf0, kf1 = arc_run[3]["pre_ba"]
    m = interop.map_state_from_numpy(pre)
    asm = build_ba_problem(m, np.array([kf1]), np.array([kf0]), np.where(m.pt_valid)[0],
                           cfg.orb, device="cpu")
    problem = asm.problem
    n_obs, n_pts = asm.obs_kf.size, asm.point_ids.size
    assert (n_obs, n_pts) == (224, 112)

    def in_front(R, t, points):
        pts = np.asarray(points, np.float64)[:n_pts]
        return min(float((pts @ np.asarray(R[k], np.float64).T + np.asarray(t[k]))[:, 2].min())
                   for k in range(2))

    out, res = _initial_ba(problem, cam)
    inlier = res.inlier.numpy()[:n_obs]
    assert in_front(out.R.numpy(), out.t.numpy(), out.points.numpy()) > 0
    for x64, dtype in ((False, np.float32), (True, np.float64)):
        with jax.enable_x64(x64):
            def leaf(t):
                a = t.numpy()
                return jnp.asarray(a.astype(dtype) if a.dtype == np.float32 else a)

            jp = jba.BAProblem(R=leaf(problem.R), t=leaf(problem.t), fixed=leaf(problem.fixed),
                               points=leaf(problem.points),
                               point_valid=leaf(problem.point_valid),
                               obs=JObs(*(leaf(getattr(problem.obs, f)) for f in JObs._fields)))
            jout, jres = jba.bundle_adjust_jit(jp, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                               n_iters=20, point_chunk=512)
            np.testing.assert_array_equal(inlier, np.asarray(jres.inlier)[:n_obs])
            assert in_front(np.asarray(jout.R), np.asarray(jout.t), np.asarray(jout.points)) > 0
            want = float(jres.cost)
            assert abs(float(res.cost) - want) <= COST_RTOL * want + 1e-4, (float(res.cost), want)
    assert inlier.all()

    # The fault: the float32 step at every iteration.
    out, res = _initial_ba(problem, cam, wide=False)
    assert in_front(out.R.numpy(), out.t.numpy(), out.points.numpy()) < 0
    assert not res.inlier.numpy()[:n_obs].any() and float(res.cost) == 0.0


def test_kidnap_recovery_with_vocabulary():
    cfg = synthetic_config(width=400, height=300, n_features=1000)
    images, poses_gt, _ = synthetic.render_sequence(
        cfg.camera, n_frames=40, n_points=500, seed=3, step=0.025, motion="sweep",
        depth_range=(1.5, 4.0), spread=2.0)
    sys_ = System(cfg, async_mapping=False, device="cpu")   # bundled vocabulary
    assert sys_.vocabulary is not None
    blank = np.full_like(images[0], 96.0)
    poses, states = [], []
    for i in range(40):
        poses.append(sys_.track_monocular(blank if 22 <= i < 27 else images[i], i / 30.0))
        states.append(sys_.tracker.state)
    assert TrackingState.LOST in states[22:27]
    assert states[-1] == TrackingState.OK
    assert sys_.tracker.last_reloc_frame_id >= 27

    gt = np.asarray([-R.T @ t for R, t in poses_gt])

    def centres(frames):
        kept = [i for i in frames if poses[i] is not None]
        return (np.asarray([-R.T @ t for R, t in (poses[i] for i in kept)]), gt[kept])

    est, want = centres(range(28, 40))
    assert len(est) >= 8, "too few tracked frames after recovery"
    s, R_al, t_al = traj.umeyama_alignment(*centres(range(22)), True)
    err = np.linalg.norm(s * est @ R_al.T + t_al - want, axis=1)
    span = np.linalg.norm(gt[-1] - gt[0])
    assert np.median(err) < 0.05 * span, (np.median(err), span)
