"""End-to-end runs of the port's System on the CPU, at the gates of JAX
tests/test_pipeline.py: TestMonocularForward (a 40-frame forward march,
400x300, 1000 features, seed 3, the bundled vocabulary: tracking OK at
the end and the scale-aligned ATE of the tracked frames under 0.03 x
span) and TestTruncatedLocalBA (the 30-frame lateral sweep with the local
BA window capped far below the map's covisibility: 3 free and 2 fixed
keyframes, 512 points; the truncation logged, tracking OK at the end and
the scale-aligned ATE under 0.05 x span). Nothing launches a kernel.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils import trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


def _scale_aligned_ate(sys_, poses_gt):
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    offset = len(poses_gt) - len(est)
    rmse = traj.ate_rmse(est[~lost], gt[offset:][~lost], align_scale=True)
    return rmse, np.linalg.norm(gt[-1] - gt[0])


class TestMonocularForward:
    """Forward-march stress geometry: parallax vanishes toward the epipole
    and the field of view never rotates off the initial cone."""

    def test_forward_ate(self):
        cfg = synthetic_config(width=400, height=300, n_features=1000)
        images, poses_gt, _ = synthetic.render_sequence(
            cfg.camera, n_frames=40, n_points=500, seed=3, step=0.05)
        sys_ = System(cfg, device="cpu")
        for i in range(images.shape[0]):
            sys_.track_monocular(images[i], i / 30.0)
        assert sys_.tracking_state() == TrackingState.OK
        rmse, span = _scale_aligned_ate(sys_, poses_gt)
        assert rmse < 0.03 * span, (rmse, span)


class TestTruncatedLocalBA:
    def test_window_caps_respected_and_stable(self):
        """Local BA in the truncated regime: with window caps far below
        the map's covisibility (TrackerConfig.lba_max_*), the solve runs on
        the capped subset, logs the truncation, and leaves the trajectory
        intact."""
        cfg = synthetic_config(width=400, height=300, n_features=1000)
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
            cfg.tracker, lba_max_free_kfs=3, lba_max_fixed_kfs=2, lba_max_points=512))
        images, poses_gt, _ = synthetic.render_sequence(
            cfg.camera, n_frames=30, n_points=500, seed=3, step=0.025,
            motion="sweep", depth_range=(1.5, 4.0), spread=2.0)
        sys_ = System(cfg, vocabulary=None, device="cpu")
        records = []
        handler = logging.Handler()
        handler.emit = lambda rec: records.append(rec.getMessage())
        log = logging.getLogger("orb_slam2_commit_tpu_torch.slam.local_mapping")
        log.addHandler(handler)
        try:
            for i in range(images.shape[0]):
                sys_.track_monocular(images[i], i / cfg.camera.fps)
        finally:
            log.removeHandler(handler)
        assert sys_.tracking_state() == TrackingState.OK
        assert any("truncating" in m for m in records), records[:3]
        rmse, span = _scale_aligned_ate(sys_, poses_gt)
        assert rmse < 0.05 * span, (rmse, span)
