"""The port's localization-only mode (Tracker.localization_only, the VO
ladder, temporal points) on the CPU against the JAX package's.

tests/test_localization_vo.py's session: the JAX System with the bundled
vocabulary maps frames 0-8 of the RGB-D sequence (400x300, 1000
features, 400 landmarks, seed 5, 0.05 a frame) and saves the map; the JAX
System and the port's each load that file, switch to the localization-only
mode and track frames 4-17 (past frame 8 the camera leaves the map, so
temporal VO points carry it). The JAX side runs in 32-bit mode on its
packed extraction route (ORB_TPU_FORCE_PACKED=1, the port's route); the
port's RANSAC sampler replays the JAX tracker's key chain (the same EPnP
sample sets in relocalization). Per frame:
- tracked on both or on neither, poses within the System tests' 0.05 deg
  / 1e-3 m, `vo_only` equal, and the temporal points spawned equal in
  number to JAX's where the last frame's bindings equal JAX's. The spawn
  takes the last frame's unbound features, so a feature bound on one side
  only moves the count by at most one: where the bindings differ, the
  counts may differ by at most the number of such features. The bindings
  differ before frames 5, 7 and 9-17, in 1 to 3 of 1000 features (the
  JAX packed route's interpreter blur flips a few descriptor bits, and the
  matches follow); the counts there by 0 to 2. The spawn itself is held
  bit for bit below;
- the map untouched on both: keyframes, points and the allocation cursor
  as loaded, no temporal point left after `track`.
The JAX test's gates on the port: >= 8 frames tracked, temporal points
spawned.
Then `_spawn_temporal_vo_points` and `_clear_temporal_vo_points` on the
JAX session's state after frames 6-7 carried into a port tracker: the same
points, bindings and map, bit for bit. tests/test_reset.py's localization
case on the port (a garbage frame loses tracking, no reset fires), and
`System.reset()` keeps the localization flag (synchronous and
asynchronous). Nothing launches a kernel here.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam import system as jsystem
from orb_slam2_commit_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_commit_tpu.slam.tracking import TrackingState as JState
from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker, TrackingState
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_system import (  # noqa: E402
    ROT_DEG_TOL, T_TOL, _jax_frame, _jax_map, rot_angle)
from test_torch_system_mono import JaxSampler  # noqa: E402

torch.set_num_threads(1)

W, H, N_FEAT = 400, 300, 1000
SEQ = dict(n_frames=18, n_points=400, seed=5, step=0.05, with_depth=True)
MAPPED = 9                       # frames 0-8 make the map
LOCALIZED = range(4, 18)
CARRY = (6, 7)                   # the frames before the spawn / clear case


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


def _spawn_counter(tracker, counts):
    """counts.append((len(tracker._temporal_points), the last frame's
    bindings before the spawn)) at each spawn."""
    fn = tracker._spawn_temporal_vo_points

    def spy():
        last = tracker.last_frame
        binding = None if last is None else np.array(last.point_ids, copy=True)
        fn()
        counts.append((int(tracker._temporal_points.size), binding))

    tracker._spawn_temporal_vo_points = spy


def _localize(sys_, images, depths, spawned):
    """Track the localized frames -> per frame (pose, vo_only, spawns,
    (n_keyframes, n_points, next_pt), temporal points left)."""
    out = []
    for i in LOCALIZED:
        n = len(spawned)
        pose = sys_.track_rgbd(images[i], depths[i], i / 30.0)
        m = sys_.map
        out.append((pose, sys_.tracker.vo_only, spawned[n:],
                    (m.n_keyframes(), m.n_points(), m.next_pt),
                    int(sys_.tracker._temporal_points.size)))
    return out


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    cfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    images, _, _, depths = jsynthetic.render_sequence(cfg.camera, **SEQ)
    path = str(tmp_path_factory.mktemp("maps") / "rgbd_map.npz")
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setenv("ORB_TPU_FORCE_PACKED", "1")
        sys_ = jsystem.System(cfg)
        for i in range(MAPPED):
            sys_.track_rgbd(images[i], depths[i], i / 30.0)
        assert sys_.tracking_state() == JState.OK
        sys_.save_map(path)

        jloc = jsystem.System(cfg)
        jloc.load_map(path)
        jloc.activate_localization_mode()
        spawned = []
        _spawn_counter(jloc.tracker, spawned)
        loaded = (jloc.map.n_keyframes(), jloc.map.n_points(), jloc.map.next_pt)
        jax_frames = _localize(jloc, images, depths, spawned)

        jcarry = jsystem.System(cfg)
        jcarry.load_map(path)
        jcarry.activate_localization_mode()
        for i in CARRY:
            jcarry.track_rgbd(images[i], depths[i], i / 30.0)
    carried = dict(map=interop.map_state_to_numpy(jcarry.map),
                   tracker=interop.tracker_state_to_numpy(jcarry.tracker))
    return dict(cfg=cfg, images=images, depths=depths, path=path, loaded=loaded,
                jax_frames=jax_frames, carried=carried)


@pytest.fixture(scope="module")
def port_frames(session):
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    sys_ = System(cfg, async_mapping=False, device="cpu")
    sys_.load_map(session["path"])
    sys_.activate_localization_mode()
    sys_.tracker.sampler = JaxSampler(jax.random.key(0))
    spawned = []
    _spawn_counter(sys_.tracker, spawned)
    assert (sys_.map.n_keyframes(), sys_.map.n_points(), sys_.map.next_pt) == session["loaded"]
    return _localize(sys_, session["images"], session["depths"], spawned)


def test_frames_match_jax(session, port_frames):
    for i, (p, j) in zip(LOCALIZED, zip(port_frames, session["jax_frames"])):
        assert (p[0] is None) == (j[0] is None), i
        if p[0] is not None:
            assert rot_angle(p[0][0], j[0][0]) < ROT_DEG_TOL, i
            np.testing.assert_allclose(p[0][1], j[0][1], atol=T_TOL, err_msg=str(i))
        assert p[1] == j[1], (i, "vo_only")
        assert len(p[2]) == len(j[2]), (i, "spawns")
        for (a, bind_a), (b, bind_b) in zip(p[2], j[2]):
            # A feature bound on one side only moves the spawn count by at
            # most one; equal bindings give equal counts.
            flips = int(((bind_a >= 0) != (bind_b >= 0)).sum())
            assert abs(a - b) <= flips, (i, "spawned", a, b, flips)


def test_map_untouched(session, port_frames):
    for frames in (port_frames, session["jax_frames"]):
        for _, _, _, sizes, left in frames:
            assert sizes == session["loaded"] and left == 0


def test_jax_gates_on_the_port(port_frames):
    """tests/test_localization_vo.py's gates: >= 8 frames tracked, and
    temporal points spawned."""
    assert sum(f[0] is not None for f in port_frames) >= 8
    assert any(n > 0 for f in port_frames for n, _ in f[2])


def test_spawn_and_clear_on_carried_state(session):
    """The JAX session's state after frames 6-7 in both trackers: the
    temporal points spawned from the last frame's depth, the last frame's
    bindings and the map, bit for bit; then the teardown."""
    c = session["carried"]
    jcfg = session["cfg"]
    jt = JTracker(jcfg, _jax_map(c["map"]))
    for k in interop.TRACKER_SCALARS:
        setattr(jt, k, c["tracker"][k])
    jt.state = JState[c["tracker"]["state"]]
    jt.last_frame = _jax_frame(c["tracker"]["last_frame"])
    jt.localization_only = True
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    pt = Tracker(cfg, interop.map_state_from_numpy(c["map"]), device="cpu")
    interop.tracker_state_into(pt, c["tracker"])
    pt.localization_only = True
    assert pt.last_frame is not None and pt.last_frame.R is not None
    next_pt = pt.map.next_pt

    jt._spawn_temporal_vo_points()
    pt._spawn_temporal_vo_points()
    assert pt._temporal_points.size > 0
    np.testing.assert_array_equal(pt._temporal_points, jt._temporal_points)
    np.testing.assert_array_equal(pt.last_frame.point_ids, jt.last_frame.point_ids)
    assert np.isin(pt.last_frame.point_ids, pt._temporal_points).sum() == \
        pt._temporal_points.size
    got, want = interop.map_state_to_numpy(pt.map), interop.map_state_to_numpy(jt.map)
    for k in ("pt_pos", "pt_valid", "pt_first_kf", "next_pt"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jt._clear_temporal_vo_points(jt.last_frame)
    pt._clear_temporal_vo_points(pt.last_frame)
    assert pt._temporal_points.size == 0 and pt.map.next_pt == next_pt
    np.testing.assert_array_equal(pt.last_frame.point_ids, jt.last_frame.point_ids)
    got, want = interop.map_state_to_numpy(pt.map), interop.map_state_to_numpy(jt.map)
    for k in ("pt_valid", "next_pt"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reset_does_not_fire_in_localization_mode():
    """tests/test_reset.py's case: a garbage frame in localization mode
    loses tracking, and the map survives (no reset)."""
    cfg = synthetic_config(width=320, height=240, n_features=600)
    images, _, _ = synthetic.render_sequence(cfg.camera, n_frames=6, n_points=300, seed=5,
                                             step=0.05)
    sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
    for i in range(images.shape[0]):
        sys_.track_monocular(images[i], i / 30.0)
    assert sys_.tracking_state() == TrackingState.OK
    sys_.activate_localization_mode()
    n_kf = sys_.map.n_keyframes()
    garbage = np.random.default_rng(1).integers(0, 255, size=images[0].shape).astype(
        images.dtype)
    sys_.track_monocular(garbage, 1.0)
    assert sys_.tracking_state() == TrackingState.LOST
    assert not sys_.tracker.request_reset
    assert sys_.map.n_keyframes() == n_kf >= 2


@pytest.mark.parametrize("async_mapping", [False, True])
def test_reset_keeps_localization_flag(async_mapping):
    cfg = synthetic_config(width=320, height=240, n_features=300, sensor="rgbd")
    sys_ = System(cfg, vocabulary=None, async_mapping=async_mapping, device="cpu")
    sys_.activate_localization_mode()
    tracker = sys_.tracker
    sys_.reset()
    assert sys_.tracker is not tracker and sys_.tracker.localization_only
    assert sys_.tracker.mapping_worker is sys_.mapping_worker
    sys_.deactivate_localization_mode()
    sys_.reset()
    assert not sys_.tracker.localization_only
    sys_.shutdown()
