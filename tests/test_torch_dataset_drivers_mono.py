"""The port's dataset driver end to end from disk, on the CPU: the
monocular modes.

tests/test_dataset_drivers.py's TUM monocular case (the bundled
vocabulary on, the driver's default) and EuRoC monocular case (no
vocabulary), at that file's sizes and gates, through
`orb_slam2_commit_tpu_torch.examples.run_dataset` with --device=cpu: the
port's writers lay out the lateral sweep as 8-bit PNGs with the dataset's
index file and a settings YAML, the driver runs on it, and the exported
trajectory's scale-aligned ATE against the renderer's ground truth stays
under the gate. The keyframe trajectory and the KITTI-format export are
written too. Nothing launches a kernel on the CPU.
"""

import os

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.examples import run_dataset
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.utils import mini_dataset, synthetic
from orb_slam2_commit_tpu_torch.utils import trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

SWEEP = dict(n_points=500, seed=3, step=0.025, motion="sweep", depth_range=(1.5, 4.0),
             spread=2.0)


def _port_main(argv):
    before = dict(_build.launches)
    rc = run_dataset.main(argv + ["--device=cpu"])
    assert _build.launches == before, "a kernel launched on the CPU"
    return rc


def _ate_vs_gt(tum_path, poses_gt, fps):
    ts, est = mini_dataset.load_tum_trajectory(tum_path)
    assert est.shape[0] >= 10, est.shape
    idx = np.round(np.asarray(ts) * fps).astype(int)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])[idx]
    return traj.ate_rmse(est, gt, align_scale=True), np.linalg.norm(gt[-1] - gt[0])


def test_tum_mono_end_to_end_from_disk(tmp_path):
    cfg = synthetic_config(width=400, height=300, n_features=1000)
    images, poses_gt, _ = synthetic.render_sequence(cfg.camera, n_frames=45, **SWEEP)
    root = str(tmp_path / "tum_seq")
    stamps = [i / cfg.camera.fps for i in range(len(images))]
    mini_dataset.write_tum_mono(root, images, stamps)
    yaml = mini_dataset.write_settings_yaml(str(tmp_path / "TUM_mini.yaml"), cfg)
    out = str(tmp_path / "traj")
    # The default: the bundled vocabulary on; --sync for a deterministic gate.
    assert _port_main(["tum-mono", root, yaml, out, "--sync"]) == 0
    rmse, span = _ate_vs_gt(out + "_tum.txt", poses_gt, cfg.camera.fps)
    assert rmse < 0.03 * span, (rmse, span)
    assert os.path.getsize(out + "_kf_tum.txt") > 0
    assert len(open(out + "_kitti.txt").readline().split()) == 12


def test_euroc_mono_end_to_end_from_disk(tmp_path):
    cfg = synthetic_config(width=400, height=300, n_features=1000)
    images, poses_gt, _ = synthetic.render_sequence(cfg.camera, n_frames=30, **SWEEP)
    root = str(tmp_path / "euroc_seq")
    stamps = [i / cfg.camera.fps for i in range(len(images))]
    mini_dataset.write_euroc(root, images, stamps)
    yaml = mini_dataset.write_settings_yaml(str(tmp_path / "EuRoC_mini.yaml"), cfg)
    out = str(tmp_path / "traj")
    assert _port_main(["euroc-mono", root, yaml, out, "--sync", "--no-vocab"]) == 0
    rmse, span = _ate_vs_gt(out + "_tum.txt", poses_gt, cfg.camera.fps)
    assert rmse < 0.04 * span, (rmse, span)
