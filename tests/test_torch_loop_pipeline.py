"""Loop closure from rendered images through the port's System on the CPU:
tests/test_loop_pipeline.py's ring survey (400x300, 500 features, 132
frames, 1.35 turns, seed 4) through System(cfg, device="cpu") with the
bundled vocabulary and synchronous mapping, on the route the card takes
(ORB_TPU_FUSED_TRACK=1), held to that test's four gates: a loop closed
and the state OK; a loop edge and a map change (the essential graph ran);
the corrected prefix's scale-aligned ATE below the drifted one; the final
scale-aligned ATE under 0.015 x span. About 180 s alone on one thread.
Nothing launches a kernel here."""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState
from orb_slam2_commit_tpu_torch.utils import synthetic, trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)


def _ate(sys_, gt, sel=slice(None)):
    est = sys_.trajectory_positions()[sel]
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)[sel]
    offset = len(gt) - len(sys_.trajectory_positions())
    return traj.ate_rmse(est[~lost], gt[offset:offset + len(est)][~lost], align_scale=True)


@pytest.fixture(scope="module")
def loop_run():
    cfg = synthetic_config(width=400, height=300, n_features=500)
    images, poses_gt, _ = synthetic.render_loop_sequence(cfg.camera, n_frames=132, frac=1.35,
                                                         seed=4)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    before = dict(_build.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_TPU_FUSED_TRACK", "1")
        sys_ = System(cfg, async_mapping=False, device="cpu")
        assert sys_.loop_closer is not None
        pre_loop = {}
        correct = sys_.loop_closer.correct_loop

        def correct_spy(*a, **k):
            if "ate" not in pre_loop:
                pre_loop.update(ate=_ate(sys_, gt), n=len(sys_.tracker.trajectory))
            return correct(*a, **k)

        sys_.loop_closer.correct_loop = correct_spy
        for i in range(images.shape[0]):
            sys_.track_monocular(images[i], i / cfg.camera.fps)
    assert _build.launches == before, "a kernel launched on the CPU"
    return sys_, gt, pre_loop


def test_loop_was_closed(loop_run):
    sys_, _, _ = loop_run
    assert sys_.tracking_state() == TrackingState.OK
    assert sys_.loop_closer.n_loops_closed >= 1


def test_essential_graph_fired(loop_run):
    sys_, _, _ = loop_run
    assert len(sys_.map.loop_edges) >= 1
    assert sys_.map.big_change_idx >= 1
    assert sys_.timings()["loop_essential_graph"]["count"] >= 1


def test_correction_improves_accuracy(loop_run):
    sys_, gt, pre_loop = loop_run
    assert "ate" in pre_loop, "correct_loop never ran"
    assert _ate(sys_, gt, slice(0, pre_loop["n"])) < pre_loop["ate"]


def test_final_ate_bound(loop_run):
    sys_, gt, _ = loop_run
    span = np.abs(gt).max() * 2
    assert _ate(sys_, gt) < 0.015 * span
