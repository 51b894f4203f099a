"""The port's asynchronous System (slam/async_pipeline.py, slam/global_ba.py)
on the CPU: tests/test_async_pipeline.py's cases.

Threads do not interleave the same way twice, so the runs are held to the
JAX test's gates, not to JAX's bits:
- the monocular sequence (400x300, 1000 features, 30 frames, 400
  landmarks, seed 3, 0.05 a frame) through an asynchronous System with the
  bundled vocabulary: OK at the end, >= 3 keyframes, the worker processed
  keyframes and has ended after shutdown, scale-aligned ATE < 0.10 x span;
- the worker's stop and release;
- the keyframe insertion protocol with a scripted worker: a busy mapper
  with a deep queue refuses monocular keyframes and interrupts its BA,
  insertion resumes when it is idle, and a stereo System inserts while
  fewer than 3 keyframes wait; every need_new_keyframe decision (and every
  interrupt) held to the JAX package's Tracker on the same map, frame and
  tracker state with the same scripted worker;
- insert_keyframe never blocks, and counts what it drops;
- tracking through global BAs held in flight and aborted by relaunches:
  every launch merged or aborted, none running at the end, OK, ATE;
- an exception on the worker thread is raised again by shutdown;
- a global BA launched while the worker's local BA solves merges only
  after that BA's write-back, so the merged poses and points stand.
"""

import functools
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.slam.async_pipeline import MappingWorker
from orb_slam2_commit_tpu_torch.slam.global_ba import GlobalBARunner
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils import trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_system import _jax_frame, _jax_map  # noqa: E402

torch.set_num_threads(1)

W, H, N_FEAT = 400, 300, 1000
MONO = dict(n_frames=30, n_points=400, seed=3, step=0.05)
ATE_GATE = 0.10


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


@functools.lru_cache(maxsize=None)
def _mono():
    """The monocular sequence, rendered once for the module's three runs
    (which do not write to it)."""
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT)
    images, poses_gt, _ = synthetic.render_sequence(cfg.camera, **MONO)
    return cfg, images, poses_gt


def _ate_gate(sys_, poses_gt):
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    ok = ~lost
    rmse = traj.ate_rmse(est[ok], gt[len(gt) - len(est):][ok], align_scale=True)
    span = np.linalg.norm(gt[-1] - gt[0])
    assert rmse < ATE_GATE * span, (rmse, span)


def test_mono_sequence_async():
    cfg, images, poses_gt = _mono()
    sys_ = System(cfg, async_mapping=True, device="cpu")
    assert sys_.mapping_worker is not None and sys_.loop_closer.gba_runner is not None
    for i in range(images.shape[0]):
        sys_.track_monocular(images[i], i / 30.0)
    sys_.shutdown()
    assert sys_.tracking_state() == TrackingState.OK
    assert sys_.map.n_keyframes() >= 3
    assert sys_.mapping_worker.processed >= 1
    assert not sys_.mapping_worker.thread.is_alive()
    _ate_gate(sys_, poses_gt)


def test_worker_stop_release():
    cfg = synthetic_config(width=320, height=240, n_features=300)
    sys_ = System(cfg, vocabulary=None, async_mapping=True, device="cpu")
    w = sys_.mapping_worker
    w.request_stop()
    time.sleep(0.05)
    assert w.is_stopped()
    w.release()
    assert not w.is_stopped()
    sys_.shutdown()
    assert not w.thread.is_alive()


class FakeWorker:
    """A mapping worker with a scripted idle and queue state."""

    def __init__(self):
        self.busy = False
        self.q = 0
        self.interrupts = 0

    def accept_keyframes(self):
        return not self.busy

    def interrupt_ba(self):
        self.interrupts += 1

    def queued(self):
        return self.q


def _held_to_jax(sys_, jcfg, fake, decisions):
    """Spy on the System's need_new_keyframe: each decision is also taken
    by a JAX Tracker on the same map, frame and tracker state, with a
    scripted worker in the same state; decisions gets (port, JAX)
    decisions and interrupts."""
    tracker = sys_.tracker
    fn = tracker.need_new_keyframe

    def spy(frame):
        jm = _jax_map(interop.map_state_to_numpy(sys_.map))
        jframe = _jax_frame(interop.frame_to_numpy(frame))
        jt = JTracker(jcfg, jm)
        for k in interop.TRACKER_SCALARS:
            setattr(jt, k, getattr(tracker, k))
        jfake = FakeWorker()
        jfake.busy, jfake.q = fake.busy, fake.q
        jt.mapping_worker = jfake
        before = fake.interrupts
        got = fn(frame)
        want = jt.need_new_keyframe(jframe)
        decisions.append(((got, fake.interrupts - before), (want, jfake.interrupts)))
        return got

    tracker.need_new_keyframe = spy


def test_busy_mapper_gates_mono_insertion():
    cfg, images, _ = _mono()
    jcfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT)
    sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
    fake, decisions = FakeWorker(), []
    i = 0
    while i < images.shape[0] and sys_.map.n_keyframes() < 3:
        sys_.track_monocular(images[i], i / 30.0)
        i += 1
    assert sys_.tracking_state() == TrackingState.OK
    sys_.tracker.mapping_worker = fake
    _held_to_jax(sys_, jcfg, fake, decisions)
    fake.busy, fake.q = True, 5
    kfs_at_block = sys_.map.n_keyframes()
    for j in range(i, min(i + 8, images.shape[0])):
        sys_.track_monocular(images[j], j / 30.0)
    i = min(i + 8, images.shape[0])
    assert sys_.map.n_keyframes() == kfs_at_block
    assert fake.interrupts >= 1
    fake.busy, fake.q = False, 0
    for j in range(i, images.shape[0]):
        sys_.track_monocular(images[j], j / 30.0)
    assert sys_.map.n_keyframes() > kfs_at_block
    assert sys_.tracking_state() == TrackingState.OK
    assert decisions and all(got == want for got, want in decisions), decisions
    sys_.shutdown()


def test_busy_mapper_stereo_shallow_queue_inserts():
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="stereo")
    jcfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="stereo")
    lefts, rights, _, _ = synthetic.render_stereo_sequence(
        cfg.camera, n_frames=20, n_points=400, seed=3, step=0.05)
    sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
    fake, decisions = FakeWorker(), []
    sys_.track_stereo(lefts[0], rights[0], 0.0)
    assert sys_.tracking_state() == TrackingState.OK
    sys_.tracker.mapping_worker = fake
    _held_to_jax(sys_, jcfg, fake, decisions)
    fake.busy, fake.q = True, 2
    k0 = sys_.map.n_keyframes()
    for i in range(1, 10):
        sys_.track_stereo(lefts[i], rights[i], i / 30.0)
    assert sys_.map.n_keyframes() > k0
    assert fake.interrupts >= 1
    fake.q = 5
    k1 = sys_.map.n_keyframes()
    for i in range(10, 20):
        sys_.track_stereo(lefts[i], rights[i], i / 30.0)
    assert sys_.map.n_keyframes() == k1
    assert decisions and all(got == want for got, want in decisions), decisions
    sys_.shutdown()


def test_insert_keyframe_never_blocks():
    release = threading.Event()

    class StuckMapper:
        abort_ba = False

        def process_keyframe(self, kf):
            release.wait(timeout=30.0)

    w = MappingWorker(StuckMapper(), None, threading.RLock(), max_queue=3)
    try:
        t0 = time.monotonic()
        for k in range(6):      # 1 in flight, 3 queued, 2 over
            w.insert_keyframe(k)
        assert time.monotonic() - t0 < 1.0
        assert w.dropped >= 1
        assert w.queued() <= 3
    finally:
        release.set()
        w.join()
    assert not w.thread.is_alive() and w.processed >= 1


def test_tracking_through_gba_abort_relaunch():
    """Tracking goes on while local BA runs on the worker and global BAs,
    each held until released, are aborted by relaunches
    (src/LoopClosing.cc:556-572, :801)."""
    cfg, images, poses_gt = _mono()
    sys_ = System(cfg, async_mapping=True, device="cpu")
    gba = sys_.loop_closer.gba_runner
    gate = threading.Event()
    run = gba._run

    def gated_run(m, anchor_kf, n_iters, gen):
        gate.wait(timeout=60.0)
        return run(m, anchor_kf, n_iters, gen)

    gba._run = gated_run
    launched = aborted_relaunch = 0
    for i in range(images.shape[0]):
        sys_.track_monocular(images[i], i / 30.0)
        if sys_.map.n_keyframes() >= 4 and i % 5 == 0:
            if gba.running:
                aborted_relaunch += 1
            gba.launch(sys_.map, anchor_kf=0)
            launched += 1
    gate.set()
    sys_.shutdown()
    assert launched >= 2 and aborted_relaunch >= 1
    assert gba.n_merged + gba.n_aborted == launched
    assert not gba.running
    assert sys_.tracking_state() == TrackingState.OK
    _ate_gate(sys_, poses_gt)


def test_worker_error_raised_at_shutdown(monkeypatch):
    cfg = synthetic_config(width=320, height=240, n_features=500, sensor="rgbd")
    images, _, _, depths = synthetic.render_sequence(
        cfg.camera, n_frames=10, n_points=300, seed=5, step=0.05, with_depth=True)
    sys_ = System(cfg, vocabulary=None, async_mapping=True, device="cpu")

    def failing(kf):
        raise ValueError("mapping failed")

    monkeypatch.setattr(sys_.mapper, "process_keyframe", failing)
    for i in range(images.shape[0]):
        sys_.track_rgbd(images[i], depths[i], i / 30.0)
    assert sys_.map.next_kf >= 2
    with pytest.raises(RuntimeError, match="mapping worker") as info:
        sys_.shutdown()
    assert isinstance(info.value.__cause__, ValueError)
    assert not sys_.mapping_worker.thread.is_alive()


def test_gba_merge_survives_local_ba(monkeypatch):
    """A global BA launched while the worker's local BA solves merges after
    that BA has written its window back, so nothing overwrites the merge
    (the reference's global BA stops local mapping before it merges)."""
    cfg = synthetic_config(width=320, height=240, n_features=500, sensor="rgbd")
    images, _, _, depths = synthetic.render_sequence(
        cfg.camera, n_frames=12, n_points=300, seed=5, step=0.05, with_depth=True)
    sys_ = System(cfg, vocabulary=None, async_mapping=True, device="cpu")
    runner = GlobalBARunner(cfg, sys_.map_lock, device="cpu")
    merged, after_merge = threading.Event(), {}
    merge = runner._merge

    def recording_merge(m, *args):
        merge(m, *args)
        after_merge.update(R=m.kf_pose_R.copy(), t=m.kf_pose_t.copy(), pts=m.pt_pos.copy())
        merged.set()

    runner._merge = recording_merge
    solve, hooked = ba.local_bundle_adjust, []

    def solve_during_gba(*args, **kw):
        if not hooked:
            hooked.append(True)
            runner.launch(sys_.map, anchor_kf=0, n_iters=2)
            # Time for the runner to pack, solve and merge, were the map
            # lock free during this solve.
            merged.wait(timeout=3.0)
        return solve(*args, **kw)

    monkeypatch.setattr(ba, "local_bundle_adjust", solve_during_gba)
    for i in range(images.shape[0]):
        sys_.track_rgbd(images[i], depths[i], i / 30.0)
        sys_.mapping_worker.wait_idle()
        if hooked:
            break
    runner.join()
    sys_.shutdown()
    assert hooked and runner.n_merged == 1
    np.testing.assert_array_equal(sys_.map.kf_pose_R, after_merge["R"])
    np.testing.assert_array_equal(sys_.map.kf_pose_t, after_merge["t"])
    np.testing.assert_array_equal(sys_.map.pt_pos, after_merge["pts"])
