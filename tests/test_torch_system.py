"""The port's System on the CPU against the JAX package's System.

The RGB-D sequence of tests/test_pipeline.py::TestRGBDPipeline (400x300,
1000 features, 20 frames, 400 landmarks, seed 5, step 0.05) runs through
the JAX System and through the port's, both synchronous and without a
vocabulary, both on the fused route (ORB_TPU_FUSED_TRACK=1; the JAX side
also on its packed extraction route, ORB_TPU_FORCE_PACKED=1, set before
it traces, and in 32-bit mode, the port's precision).

Held equal frame by frame: tracking states and keyframe ids (next_kf).
Poses within 0.05 deg / 1e-3 m of the JAX System's, points created within
2% of its count: the JAX packed route's interpreter blur flips a few
descriptor bits (at most 1% of descriptors, tests/test_torch_fused.py),
so a few matches and points differ. Both pass the 0.015 x span ATE gate
with no scale alignment.

Then one Tracker.track (on the fused route, and on the staged route the
CPU takes by default) and one LocalMapper.process_keyframe on state
carried across from the JAX run mid-sequence (interop's state
converters), on the same inputs: integer tables equal, poses within
1e-4 deg / 1e-5 m, positions within 1e-4 m (float32 in both, summed in
different orders); with the mapper's abort flag set, both skip local BA
and the new points, raw DLT triangulations, agree to 5e-4 relative. The
trajectory exports hold the trajectory's positions. A short stereo run
of the port is held by outcome, and the two switches once refused run:
the staged mapper route (ORB_TPU_STAGED_MAPPER=1) maps a keyframe of the
carried state, and global BA sharded over the process group
(ORB_DISTRIBUTED_GBA=1) builds.
"""

import jax
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam import system as jsystem
from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam import loop_closing
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker, TrackingState
from orb_slam2_commit_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam2_commit_tpu_torch.utils import synthetic, trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT, N_FRAMES = 400, 300, 1000, 20
SEQ = dict(n_frames=N_FRAMES, n_points=400, seed=5, step=0.05, with_depth=True)
ROT_DEG_TOL, T_TOL = 0.05, 1e-3          # port System vs JAX System
POINTS_RTOL = 0.02
STEP_ROT_DEG_TOL, STEP_T_TOL = 1e-4, 1e-5  # one step on carried state
POS_TOL = 1e-4
RAW_TRI_RTOL = 5e-4
TRACK_FRAME = 12          # a plain fused frame, mid-sequence
MAPPED_KF = 3             # a keyframe whose mapping runs local BA


def rot_angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


def _ate(sys_, poses_gt):
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    ok = ~lost
    rmse = traj.ate_rmse(est[ok], gt[len(gt) - len(est):][ok], align_scale=False)
    return rmse, np.linalg.norm(gt[-1] - gt[0])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX System over the sequence, with the state around one
    tracker step (TRACK_FRAME) and one mapper call (MAPPED_KF) recorded."""
    cfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    images, poses_gt, _, depths = jsynthetic.render_sequence(cfg.camera, **SEQ)
    rec = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setenv("ORB_TPU_FORCE_PACKED", "1")
        mp.setenv("ORB_TPU_FUSED_TRACK", "1")
        sys_ = jsystem.System(cfg, vocabulary=None, async_mapping=False)
        track, process = sys_.tracker.track, sys_.mapper.process_keyframe

        def track_spy(frame, motion_ok=None):
            if frame.frame_id != TRACK_FRAME:
                return track(frame, motion_ok)
            rec["track_in"] = dict(
                map=interop.map_state_to_numpy(sys_.map), frame=interop.frame_to_numpy(frame),
                tracker=interop.tracker_state_to_numpy(sys_.tracker), motion_ok=motion_ok)
            pose = track(frame, motion_ok)
            rec["track_out"] = dict(
                map=interop.map_state_to_numpy(sys_.map), frame=interop.frame_to_numpy(frame),
                tracker=interop.tracker_state_to_numpy(sys_.tracker), pose=pose)
            return pose

        def process_spy(kf):
            if kf != MAPPED_KF:
                return process(kf)
            rec["map_in"] = dict(map=interop.map_state_to_numpy(sys_.map),
                                 recent=interop.recent_points_to_numpy(sys_.mapper))
            process(kf)
            rec["map_out"] = dict(map=interop.map_state_to_numpy(sys_.map),
                                  recent=interop.recent_points_to_numpy(sys_.mapper))

        mp.setattr(sys_.tracker, "track", track_spy)
        mp.setattr(sys_.mapper, "process_keyframe", process_spy)
        frames = []
        for i in range(N_FRAMES):
            pose = sys_.track_rgbd(images[i], depths[i], i / 30.0)
            frames.append((sys_.tracking_state().name, sys_.map.next_kf, pose))
    assert {"track_in", "track_out", "map_in", "map_out"} <= set(rec)
    return sys_, frames, rec, poses_gt


@pytest.fixture(scope="module")
def port_run(jax_run):
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    images, poses_gt, _, depths = synthetic.render_sequence(cfg.camera, **SEQ)
    before = dict(_build.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_TPU_FUSED_TRACK", "1")
        sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
        frames = []
        for i in range(N_FRAMES):
            pose = sys_.track_rgbd(images[i], depths[i], i / 30.0)
            frames.append((sys_.tracking_state().name, sys_.map.next_kf, pose))
    assert _build.launches == before, "a kernel launched on the CPU"
    return sys_, frames, poses_gt


def test_states_and_keyframes_match_jax(jax_run, port_run):
    _, j_frames, _, _ = jax_run
    _, p_frames, _ = port_run
    assert [f[:2] for f in p_frames] == [f[:2] for f in j_frames]
    assert all(f[0] == "OK" for f in p_frames)
    assert p_frames[-1][1] >= 4


def test_poses_and_points_match_jax(jax_run, port_run):
    j_sys, j_frames, _, _ = jax_run
    p_sys, p_frames, _ = port_run
    for i, (jf, pf) in enumerate(zip(j_frames, p_frames)):
        (Rj, tj), (Rp, tp) = jf[2], pf[2]
        assert rot_angle(Rj, Rp) < ROT_DEG_TOL, i
        assert np.linalg.norm(np.asarray(tj) - tp) < T_TOL, i
    assert abs(p_sys.map.next_pt - j_sys.map.next_pt) <= POINTS_RTOL * j_sys.map.next_pt
    np.testing.assert_allclose(p_sys.trajectory_positions(), j_sys.trajectory_positions(),
                               atol=T_TOL)


def test_both_pass_the_ate_gate(jax_run, port_run):
    j_sys, _, _, poses_gt = jax_run
    p_sys, _, _ = port_run
    for sys_ in (j_sys, p_sys):
        rmse, span = _ate(sys_, poses_gt)
        assert rmse < 0.015 * span, (rmse, span)


def _assert_map_equal(got, want, pos_tol=POS_TOL, pos_rtol=0.0):
    """Integer and boolean tables equal; poses and positions within the
    step tolerances."""
    for k, w in want.items():
        g = got[k]
        if k in ("cfg", "loop_edges") or not isinstance(w, np.ndarray):
            assert g == w, k
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
    valid = want["pt_valid"]
    np.testing.assert_allclose(got["pt_pos"][valid], want["pt_pos"][valid], atol=pos_tol,
                               rtol=pos_rtol)
    for k in range(want["next_kf"]):
        if want["kf_valid"][k]:
            assert rot_angle(got["kf_pose_R"][k], want["kf_pose_R"][k]) < STEP_ROT_DEG_TOL, k
            np.testing.assert_allclose(got["kf_pose_t"][k], want["kf_pose_t"][k],
                                       atol=STEP_T_TOL)


def test_one_tracker_step_on_carried_state(jax_run):
    _, _, rec, _ = jax_run
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    i, o = rec["track_in"], rec["track_out"]
    assert i["frame"]["dev_feat"] is not None      # the fused route's frame
    ms = interop.map_state_from_numpy(i["map"])
    tracker = Tracker(cfg, ms, device="cpu")
    interop.tracker_state_into(tracker, i["tracker"])
    frame = interop.frame_from_numpy(i["frame"], device="cpu")
    R, t = tracker.track(frame, motion_ok=i["motion_ok"])
    got = interop.frame_to_numpy(frame)
    np.testing.assert_array_equal(got["point_ids"], o["frame"]["point_ids"])
    assert rot_angle(R, o["pose"][0]) < STEP_ROT_DEG_TOL
    np.testing.assert_allclose(t, o["pose"][1], atol=STEP_T_TOL)
    state = interop.tracker_state_to_numpy(tracker)
    for k in ("state", "ref_kf", "last_kf_frame_id", "last_reloc_frame_id", "n_inliers"):
        assert state[k] == o["tracker"][k], k
    _assert_map_equal(interop.map_state_to_numpy(ms), o["map"])


def _jax_map(d):
    """map_state_to_numpy's dict -> a JAX package MapState (a test-side
    carrier: the port's interop builds only the port's objects)."""
    from orb_slam2_commit_tpu.models.map_state import MapState as JMapState
    from orb_slam2_commit_tpu.utils.config import MapConfig as JMapConfig

    arrays = {k: np.array(v, copy=True) for k, v in d.items()
              if k not in interop.MAP_SCALARS and k not in ("cfg", "loop_edges")}
    return JMapState(cfg=JMapConfig(**d["cfg"]), loop_edges=list(d["loop_edges"]),
                     **{k: d[k] for k in interop.MAP_SCALARS}, **arrays)


def _jax_frame(d):
    from orb_slam2_commit_tpu.slam.frame import Frame as JFrame
    from orb_slam2_commit_tpu.slam.tracking import TrajectoryEntry as JEntry

    host = {k: (None if d[k] is None else np.array(d[k], copy=True))
            for k in interop.FRAME_ARRAYS if k not in ("dev_feat", "dev_desc")}
    frame = JFrame(frame_id=d["frame_id"], timestamp=d["timestamp"], **host)
    frame.anchor = None if d["anchor"] is None else JEntry(**d["anchor"])
    return frame


def test_one_staged_tracker_step_on_carried_state(jax_run):
    """The staged route (motion model through K6, pose LM, local map by
    frustum check, K6 and the LM; what the CPU takes without
    ORB_TPU_FUSED_TRACK=1) for one frame on carried state, in both
    packages: the same frame as extracted, without its fused results."""
    from orb_slam2_commit_tpu.slam.tracking import Tracker as JTracker
    from orb_slam2_commit_tpu.slam.tracking import TrackingState as JState

    _, _, rec, _ = jax_run
    i = rec["track_in"]
    fresh = dict(i["frame"], dev_feat=None, dev_desc=None, R=None, t=None,
                 point_ids=np.full_like(i["frame"]["point_ids"], -1), anchor=None)
    jcfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    jms = _jax_map(i["map"])
    jtracker = JTracker(jcfg, jms)
    for k in interop.TRACKER_SCALARS:
        setattr(jtracker, k, i["tracker"][k])
    jtracker.state = JState[i["tracker"]["state"]]
    jtracker.velocity = tuple(np.array(v) for v in i["tracker"]["velocity"])
    jtracker.last_frame = _jax_frame(i["tracker"]["last_frame"])
    jframe = _jax_frame(fresh)
    with jax.enable_x64(False):
        want = jtracker.track(jframe)

    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    ms = interop.map_state_from_numpy(i["map"])
    tracker = Tracker(cfg, ms, device="cpu")
    interop.tracker_state_into(tracker, i["tracker"])
    frame = interop.frame_from_numpy(fresh, device="cpu")
    got = tracker.track(frame)
    assert got is not None and want is not None
    np.testing.assert_array_equal(frame.point_ids, jframe.point_ids)
    assert rot_angle(got[0], want[0]) < STEP_ROT_DEG_TOL
    np.testing.assert_allclose(got[1], want[1], atol=STEP_T_TOL)
    assert (tracker.state.name, tracker.ref_kf, tracker.n_inliers) == \
        (jtracker.state.name, jtracker.ref_kf, jtracker.n_inliers)
    _assert_map_equal(interop.map_state_to_numpy(ms), interop.map_state_to_numpy(jms))


def test_one_mapper_call_on_carried_state(jax_run):
    _, _, rec, _ = jax_run
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    i, o = rec["map_in"], rec["map_out"]
    ms = interop.map_state_from_numpy(i["map"])
    mapper = LocalMapper(cfg, ms, device="cpu")
    mapper.recent_points = interop.recent_points_from_numpy(i["recent"])
    mapper.process_keyframe(MAPPED_KF)
    assert ms.n_keyframes() > 2                     # local BA ran
    assert ms.next_pt > i["map"]["next_pt"]         # triangulation made points
    np.testing.assert_array_equal(interop.recent_points_to_numpy(mapper), o["recent"])
    _assert_map_equal(interop.map_state_to_numpy(ms), o["map"])


def test_map_state_round_trip(jax_run):
    _, _, rec, _ = jax_run
    d = rec["map_out"]["map"]
    back = interop.map_state_to_numpy(interop.map_state_from_numpy(d))
    assert back.keys() == d.keys()
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
            assert back[k].dtype == v.dtype, k
        else:
            assert back[k] == v, k


def test_short_stereo_run():
    """A stereo System of the port on the CPU (400x300, 1000 features, 12
    frames, staged route), held by outcome: every frame OK, at least 3
    keyframes, points triangulated by the mapper beyond those the
    keyframes' depths created, ATE under 0.015 x span."""
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="stereo")
    lefts, rights, poses_gt, _ = synthetic.render_stereo_sequence(
        cfg.camera, n_frames=12, n_points=400, seed=5, step=0.05)
    sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
    created = []
    tri = sys_.mapper._create_new_points_batched

    def counting(kf):
        before = sys_.map.next_pt
        tri(kf)
        created.append(sys_.map.next_pt - before)

    sys_.mapper._create_new_points_batched = counting
    for i in range(lefts.shape[0]):
        sys_.track_stereo(lefts[i], rights[i], i / 30.0)
        assert sys_.tracking_state() == TrackingState.OK, i
    assert sys_.map.n_keyframes() >= 3 and sum(created) > 0, created
    rmse, span = _ate(sys_, poses_gt)
    assert rmse < 0.015 * span, (rmse, span)


def test_mapper_abort_skips_local_ba_as_jax(jax_run):
    """A set abort flag (mbAbortBA) skips local BA in both packages: the
    same mapper call on carried state, without BA, gives equal tables and
    bit-identical poses and positions."""
    from orb_slam2_commit_tpu.slam.local_mapping import LocalMapper as JLocalMapper
    from orb_slam2_commit_tpu.slam.local_mapping import RecentPoint as JRecentPoint

    _, _, rec, _ = jax_run
    d = rec["map_in"]["map"]
    jms = _jax_map(d)
    jcfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    jmapper = JLocalMapper(jcfg, jms)
    jmapper.recent_points = [JRecentPoint(int(p), int(k)) for p, k in rec["map_in"]["recent"]]
    jmapper.abort_ba = True
    with jax.enable_x64(False):
        jmapper.process_keyframe(MAPPED_KF)
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    ms = interop.map_state_from_numpy(d)
    mapper = LocalMapper(cfg, ms, device="cpu")
    mapper.recent_points = interop.recent_points_from_numpy(rec["map_in"]["recent"])
    mapper.abort_ba = True
    mapper.process_keyframe(MAPPED_KF)
    got, want = interop.map_state_to_numpy(ms), interop.map_state_to_numpy(jms)
    # Without BA the new points are raw DLT triangulations: float32
    # eigensolves of A^T A agree to RAW_TRI_RTOL.
    _assert_map_equal(got, want, pos_rtol=RAW_TRI_RTOL)
    np.testing.assert_array_equal(got["kf_pose_R"], d["kf_pose_R"])   # no BA moved them


@pytest.mark.parametrize("switch", ["ORB_DISTRIBUTED_GBA", "ORB_TPU_STAGED_MAPPER"])
def test_features_still_to_come_raise(switch, monkeypatch, jax_run):
    """Neither switch raises any more. Global BA sharded over the process
    group (ORB_DISTRIBUTED_GBA=1, with a vocabulary's loop closer): the
    System builds and its closer takes the sharded route
    (tests/test_torch_multihost.py runs it). The staged mapper route
    (ORB_TPU_STAGED_MAPPER=1): one process_keyframe on the state carried
    across from the JAX run at MAPPED_KF triangulates through
    _create_new_points_staged, one triangulation match with no batch axis
    per neighbour pair, and fuses; it leaves as many keyframes as the JAX
    System's batched mapper and its point count within POINTS_RTOL
    (tests/test_torch_staged_mapper.py holds it to the JAX staged route)."""
    monkeypatch.setenv(switch, "1")
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    if switch == "ORB_DISTRIBUTED_GBA":
        sys_ = System(cfg, vocabulary="default", async_mapping=False, device="cpu")
        assert sys_.loop_closer is not None and loop_closing.use_distributed_gba()
        return
    from orb_slam2_commit_tpu_torch.slam import local_mapping

    _, _, rec, _ = jax_run
    ms = interop.map_state_from_numpy(rec["map_in"]["map"])
    mapper = LocalMapper(cfg, ms, device="cpu")
    mapper.recent_points = interop.recent_points_from_numpy(rec["map_in"]["recent"])
    calls = []
    match = local_mapping.matchers.match_for_triangulation

    def spy(*args, **kwargs):
        calls.append(args[4].dim())       # the neighbour's xy: [N, 2] with no batch axis
        return match(*args, **kwargs)

    monkeypatch.setattr(local_mapping.matchers, "match_for_triangulation", spy)
    n_pairs = len(mapper._neighbor_pairs(MAPPED_KF)[1])
    before = ms.next_pt
    mapper.process_keyframe(MAPPED_KF)
    want = rec["map_out"]["map"]
    assert n_pairs >= 1 and calls == [2] * n_pairs
    assert ms.next_pt > before and ms.next_kf == want["next_kf"]
    assert abs(ms.n_points() - int(want["pt_valid"].sum())) <= POINTS_RTOL * want["pt_valid"].sum()


def test_trajectory_exports(port_run, tmp_path):
    """The TUM and KITTI files hold one row per frame, whose positions are
    trajectory_positions() (TUM's to the 7 decimals it writes), and the
    keyframe file one row per kept keyframe."""
    sys_, _, _ = port_run
    want = sys_.trajectory_positions()
    sys_.save_trajectory_tum(str(tmp_path / "f.txt"))
    sys_.save_trajectory_kitti(str(tmp_path / "k.txt"))
    sys_.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    tum = np.loadtxt(tmp_path / "f.txt")
    kitti = np.loadtxt(tmp_path / "k.txt").reshape(-1, 3, 4)
    assert tum.shape == (N_FRAMES, 8) and kitti.shape[0] == N_FRAMES
    np.testing.assert_allclose(tum[:, 1:4], want, atol=1e-6)
    np.testing.assert_allclose(kitti[:, :, 3], want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:8], axis=1), 1.0, atol=1e-6)
    assert np.loadtxt(tmp_path / "kf.txt").shape == (sys_.map.n_keyframes(), 8)
