"""The port's headless viewer (slam/viewer.py) against the JAX package's.

draw_frame, draw_map_topdown (points, keyframes, the covisibility graph,
the spanning tree, loop edges, the current camera, follow mode) and
collect_metrics give the same bytes and values as JAX's on the same frame,
map and tracker state, carried across with interop's converters. The
render loop (ViewerLoop) paces at its fps, routes its menu to the System,
pauses on the stop handshake, runs a queued reset on its thread, streams
PNGs that read back as the rendered frame, counts a render that raises
and carries on, and does no torch work at all. A reset requested from
another thread while a frame is being tracked waits for that frame.
"""

import threading
import time

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models.map_state import MapState as JaxMapState
from orb_slam2_commit_tpu.slam import viewer as jviewer
from orb_slam2_commit_tpu.slam.frame import Frame as JaxFrame
from orb_slam2_commit_tpu.slam.tracking import Tracker as JaxTracker
from orb_slam2_commit_tpu.slam.tracking import TrajectoryEntry as JaxEntry
from orb_slam2_commit_tpu.utils.config import MapConfig as JaxMapConfig
from orb_slam2_commit_tpu.utils.config import synthetic_config as jax_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.slam import viewer
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker, TrackingState, TrajectoryEntry
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)


def _jax_frame(n=60, h=120, w=160, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0, 0], [w - 1, h - 1], (n, 2))
    xy[:4] = [[0, 0], [w - 1, h - 1], [0.4, h - 1.4], [w - 1.4, 2]]    # at the borders
    f = JaxFrame(
        frame_id=0, timestamp=0.0, xy=xy, xy_raw=xy.copy(),
        octave=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
        response=np.ones(n, np.float32), desc=np.zeros((n, 8), np.uint32),
        valid=rng.random(n) < 0.8, depth=np.full(n, -1.0, np.float32),
        ur=np.full(n, -1.0, np.float32))
    f.point_ids[: n // 2] = np.arange(n // 2)
    return f


def _jax_map(n_kf=3, seed=2, loop=True):
    m = JaxMapState.create(JaxMapConfig(max_keyframes=8, max_points=256), 20)
    ids = m.add_points(np.random.default_rng(seed).uniform(-3, 3, (40, 3)), first_kf=0)
    pi = np.full(20, -1, np.int32)
    pi[:20] = ids[:20]
    for k, c in enumerate([(0.0, 0.0), (2.0, 0.0), (1.0, 2.0), (-1.0, 1.5)][:n_kf]):
        m.add_keyframe(np.eye(3), -np.array([c[0], 0.0, c[1]]), np.zeros((20, 2)),
                       np.zeros(20, np.int32), np.zeros(20, np.float32),
                       np.zeros((20, 8), np.uint32), np.ones(20, bool), pi, k, float(k))
    for k in range(1, n_kf):
        m.kf_parent[k] = k - 1
    if loop and n_kf >= 3:
        m.add_loop_edge(0, n_kf - 1)
    return m


def _port_map(jm):
    return interop.map_state_from_numpy(interop.map_state_to_numpy(jm))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("seed", [0, 1])
def test_draw_frame_equals_jax(dtype, seed):
    jf = _jax_frame(seed=seed)
    f = interop.frame_from_numpy(interop.frame_to_numpy(jf), device="cpu")
    img = np.random.default_rng(seed).uniform(0, 255, (120, 160)).astype(dtype)
    m = _port_map(_jax_map())
    got = viewer.draw_frame(f, img, "OK", m)
    want = jviewer.draw_frame(jf, img, "OK", _jax_map())
    assert got.dtype == np.uint8 and got.shape == (120, 160, 3)
    assert got.tobytes() == want.tobytes()


CASES = {   # name -> (keyframes, current pose, kwargs)
    "graph and loop edge": (3, (np.eye(3), np.zeros(3)), {}),
    "follow": (3, (np.eye(3), np.asarray([-2.0, 0.0, 0.0])), {"follow": True}),
    "no current pose": (4, None, {}),
    "explicit loop edges": (4, (np.eye(3), np.ones(3)), {"loop_edges": [(1, 3), (0, 9)]}),
    "one keyframe": (1, (np.eye(3), np.zeros(3)), {"size": 200}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_draw_map_topdown_equals_jax(name):
    n_kf, pose, kw = CASES[name]
    jm = _jax_map(n_kf)
    jm.cov_weight[0, 1] = jm.cov_weight[1, 0] = 20
    if n_kf > 2:
        jm.cov_weight[1, 2] = jm.cov_weight[2, 1] = 30
    got = viewer.draw_map_topdown(_port_map(jm), pose, **kw)
    want = jviewer.draw_map_topdown(jm, pose, **kw)
    assert got.tobytes() == want.tobytes()
    assert got.sum() > 0


def test_empty_map_draws_black():
    m = _port_map(JaxMapState.create(JaxMapConfig(max_keyframes=8, max_points=64), 20))
    assert not viewer.draw_map_topdown(m, (np.eye(3), np.zeros(3))).any()


def test_collect_metrics_equals_jax():
    jm = _jax_map()
    m = _port_map(jm)
    jt = JaxTracker(jax_synthetic_config(width=160, height=120, n_features=20), jm)
    t = Tracker(synthetic_config(width=160, height=120, n_features=20), m, device="cpu")
    assert viewer.collect_metrics(t, m) == jviewer.collect_metrics(jt, jm)
    for tr, entry in ((jt, JaxEntry), (t, TrajectoryEntry)):
        tr.n_inliers, tr.ref_kf = 123, 2
        tr.trajectory.extend(entry(1, np.eye(3), np.zeros(3), 0.1 * i, False) for i in range(4))
    jt.state = type(jt.state)["OK"]
    t.state = TrackingState.OK
    jm.big_change_idx = m.big_change_idx = 3
    got = viewer.collect_metrics(t, m)
    assert got == jviewer.collect_metrics(jt, jm)
    assert got["state"] == "OK" and got["n_keyframes"] == 3 and got["n_trajectory_entries"] == 4


def _rgbd_system(n_frames=6, async_mapping=False):
    from orb_slam2_commit_tpu_torch.slam.system import System
    from orb_slam2_commit_tpu_torch.utils import synthetic

    cfg = synthetic_config(320, 240, 600, sensor="rgbd")
    images, _, _, depths = synthetic.render_sequence(
        cfg.camera, n_frames=n_frames, n_points=500, seed=5, step=0.05, with_depth=True)
    return System(cfg, vocabulary=None, async_mapping=async_mapping, device="cpu"), images, depths


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


def test_viewer_loop_pacing_menus_pause_reset(tmp_path):
    """tests/test_viewer.py's TestViewerLoop on the port's System."""
    sys_, images, depths = _rgbd_system()
    vl = viewer.ViewerLoop(sys_, fps=60.0, stream_dir=str(tmp_path)).start()
    try:
        for i, im in enumerate(images):
            sys_.track_rgbd(im, depths[i], i / 30.0)
            vl.update(sys_.tracker.last_frame, im)
        assert sys_.map.n_keyframes() >= 2
        time.sleep(0.2)
        assert vl.n_rendered >= 5 and vl.n_errors == 0
        assert vl.frame_view is not None and vl.frame_view.shape == (240, 320, 3)
        assert vl.map_view is not None and vl.map_view.shape == (512, 512, 3)
        assert vl.metrics["n_keyframes"] == sys_.map.n_keyframes()

        vl.set_localization_mode(True)
        assert sys_.tracker.localization_only
        vl.set_localization_mode(False)
        assert not sys_.tracker.localization_only
        vl.follow_camera = False

        vl.request_stop()
        assert _wait(vl.is_stopped)
        n = vl.n_rendered
        time.sleep(0.1)
        assert vl.n_rendered == n
        t = vl.timings.summary()
        assert t["lock_wait"]["count"] == t["draw"]["count"] == n
        assert t["png"]["count"] == len(list(tmp_path.iterdir())) >= 1
        # The streamed PNGs read back as the frames rendered.
        from orb_slam2_commit_tpu_torch.utils.png import read_png

        last = read_png(str(tmp_path / f"frame_{n:05d}.png"))
        assert last.dtype == np.uint8 and last.tobytes() == vl.frame_view.tobytes()
        vl.release()
        assert _wait(lambda: vl.n_rendered > n)

        vl.request_reset()
        assert _wait(lambda: sys_.map.n_keyframes() == 0)
        assert sys_.tracking_state() == TrackingState.NO_IMAGES_YET
    finally:
        vl.join(timeout=2.0)
    assert vl.is_finished() and not vl._thread.is_alive()
    assert vl.n_errors == 0


def test_render_error_is_counted_and_the_loop_lives(monkeypatch):
    sys_, images, depths = _rgbd_system(2)
    sys_.track_rgbd(images[0], depths[0], 0.0)
    calls = []
    draw = viewer.draw_map_topdown

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) <= 3:
            raise IndexError("a draw race")
        return draw(*a, **k)

    monkeypatch.setattr(viewer, "draw_map_topdown", flaky)
    vl = viewer.ViewerLoop(sys_, fps=200.0).start()
    try:
        assert _wait(lambda: vl.n_rendered >= 3)
    finally:
        vl.join(timeout=2.0)
    assert vl.n_errors == 3 and isinstance(vl.last_error, IndexError)
    assert vl.is_finished() and vl.map_view is not None


def test_render_does_no_torch_work():
    """The viewer reads numpy fields only: no torch function runs in a
    render (on the card it would queue work behind the tracker's)."""
    from torch.overrides import TorchFunctionMode

    sys_, images, depths = _rgbd_system(3)
    for i in range(3):
        sys_.track_rgbd(images[i], depths[i], i / 30.0)
    vl = viewer.ViewerLoop(sys_)
    vl.update(sys_.tracker.last_frame, images[2])
    seen = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    with Spy():
        vl._render_once()
    assert vl.frame_view is not None and vl.map_view.any()
    assert seen == []


def _hold_a_frame(monkeypatch, sys_, image, depth):
    """A thread tracking one frame, held inside the tracker until the
    returned event is set -> (the thread, the event)."""
    inside, go = threading.Event(), threading.Event()
    track = type(sys_.tracker).track

    def slow_track(self, frame, **kw):
        inside.set()
        assert go.wait(10.0)
        return track(self, frame, **kw)

    monkeypatch.setattr(type(sys_.tracker), "track", slow_track)
    tracking = threading.Thread(target=sys_.track_rgbd, args=(image, depth, 0.1))
    tracking.start()
    assert inside.wait(10.0)
    return tracking, go


@pytest.mark.parametrize("async_mapping", [False, True])
def test_render_waits_for_the_frame_in_flight(monkeypatch, async_mapping):
    """A render reads under the System's reader lock: while a frame is
    inside the tracker it waits, then draws the tracked frame's map."""
    sys_, images, depths = _rgbd_system(4, async_mapping)
    for i in range(3):
        sys_.track_rgbd(images[i], depths[i], i / 30.0)
    vl = viewer.ViewerLoop(sys_)
    tracking, go = _hold_a_frame(monkeypatch, sys_, images[3], depths[3])
    rendering = threading.Thread(target=vl._render_once)
    rendering.start()
    time.sleep(0.2)
    assert rendering.is_alive() and vl.n_rendered == 0
    go.set()
    tracking.join(10.0)
    rendering.join(10.0)
    assert not tracking.is_alive() and not rendering.is_alive()
    assert vl.n_rendered == 1 and vl.metrics["n_trajectory_entries"] == 4
    sys_.shutdown()


@pytest.mark.parametrize("async_mapping", [False, True])
def test_reset_waits_for_the_frame_in_flight(monkeypatch, async_mapping):
    """System.reset from another thread while track_rgbd is inside the
    tracker: it returns only after that frame, and leaves a fresh map that
    the next frames initialize and track."""
    sys_, images, depths = _rgbd_system(6, async_mapping)
    for i in range(3):
        sys_.track_rgbd(images[i], depths[i], i / 30.0)
    track = type(sys_.tracker).track
    tracking, go = _hold_a_frame(monkeypatch, sys_, images[3], depths[3])
    resetting = threading.Thread(target=sys_.reset)
    resetting.start()
    time.sleep(0.2)
    assert resetting.is_alive()               # waits for the frame in flight
    go.set()
    tracking.join(10.0)
    resetting.join(10.0)
    assert not tracking.is_alive() and not resetting.is_alive()
    assert sys_.map.n_keyframes() == 0 and sys_.map.next_pt == 0
    assert sys_.tracking_state() == TrackingState.NO_IMAGES_YET
    monkeypatch.setattr(type(sys_.tracker), "track", track)
    for i in (4, 5):
        assert sys_.track_rgbd(images[i], depths[i], i / 30.0 + 1.0) is not None
    sys_.shutdown()
    assert sys_.map.n_keyframes() >= 1 and sys_.tracking_state() == TrackingState.OK
