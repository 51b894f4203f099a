"""The port's dataset driver end to end from disk, on the CPU: the stereo
and RGB-D modes.

tests/test_dataset_drivers.py's KITTI stereo, TUM RGB-D and EuRoC stereo
cases, at that file's sizes and gates, through
`orb_slam2_commit_tpu_torch.examples.run_dataset` with --device=cpu: the
port's writers lay out a rendered sequence in the dataset's layout (8-bit
PNGs, 16-bit TUM depth at DepthMapFactor 5000, the index files, the
settings YAML; EuRoC's raw pairs through a distorted lens and mounting
rotations, rectified by the driver from the LEFT.* / RIGHT.* blocks), the
driver runs on it, and the exported trajectory's ATE against the
renderer's ground truth stays under the gate (no scale alignment).

On the TUM RGB-D case the JAX package's driver (examples/run_dataset.py)
runs on the same files, both Systems on the fused route, the card's
(ORB_TPU_FUSED_TRACK=1), the JAX side in 32-bit mode, the port's
precision, and on the extraction route it takes on the CPU, as its own
driver test runs it (the per-level XLA route, whose blur is the plain
reference of the Pallas level kernel). Every frame's pose in the port's
trajectory file lies within 0.05 deg / 1e-3 m of the JAX driver's, the
System tests' tolerance (5.2e-4 m at most on this sequence). With the JAX
side forced onto its packed route (ORB_TPU_FORCE_PACKED=1, Pallas
interpreted) one frame lies 1.29e-3 m away, both trajectories within
0.006 m of the ground truth: 1-4% of the frames' descriptors differ
between the two packages on either route, and on the packed route the gap
opens at the second keyframe's local mapping. Nothing launches a kernel
on the CPU.
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import torch

from orb_slam2_commit_tpu_torch.examples import run_dataset
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.utils import mini_dataset, synthetic
from orb_slam2_commit_tpu_torch.utils import trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROT_DEG_TOL, T_TOL = 0.05, 1e-3     # port driver vs JAX driver, every frame


def _port_main(argv):
    before = dict(_build.launches)
    rc = run_dataset.main(argv + ["--device=cpu"])
    assert _build.launches == before, "a kernel launched on the CPU"
    return rc


def _jax_main(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_run_dataset", os.path.join(REPO, "examples", "run_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def _ate_vs_gt(tum_path, poses_gt, fps, align_scale):
    ts, est = mini_dataset.load_tum_trajectory(tum_path)
    assert est.shape[0] >= 10, est.shape
    idx = np.round(np.asarray(ts) * fps).astype(int)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])[idx]
    return traj.ate_rmse(est, gt, align_scale=align_scale), np.linalg.norm(gt[-1] - gt[0])


def _tum_poses(path):
    """{timestamp: (R_wc, t_wc)} of a TUM trajectory file."""
    out = {}
    for line in open(path):
        v = [float(x) for x in line.split()]
        q = torch.tensor(v[4:8], dtype=torch.float64)
        out[round(v[0], 6)] = (lie.quaternion_to_rotation(q).numpy(), np.array(v[1:4]))
    return out


def _rot_deg(Ra, Rb):
    d = np.linalg.norm(Ra - Rb)
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


def test_kitti_stereo_end_to_end_from_disk(tmp_path):
    cfg = synthetic_config(width=400, height=300, n_features=1000, sensor="stereo")
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, fps=10.0))
    lefts, rights, poses_gt, _ = synthetic.render_stereo_sequence(
        cfg.camera, n_frames=22, n_points=500, seed=7, step=0.06)
    root = str(tmp_path / "kitti_00")
    stamps = [i / cfg.camera.fps for i in range(len(lefts))]
    mini_dataset.write_kitti(root, lefts, stamps, rights=rights)
    yaml = mini_dataset.write_settings_yaml(str(tmp_path / "KITTI_mini.yaml"), cfg)
    out = str(tmp_path / "traj")
    assert _port_main(["kitti-stereo", root, yaml, out, "--sync", "--no-vocab"]) == 0
    rmse, span = _ate_vs_gt(out + "_tum.txt", poses_gt, cfg.camera.fps, align_scale=False)
    assert rmse < 0.02 * span, (rmse, span)
    assert len(open(out + "_kitti.txt").readline().split()) == 12


def test_tum_rgbd_end_to_end_from_disk_and_against_jax(tmp_path, monkeypatch):
    cfg = synthetic_config(width=400, height=300, n_features=1000, sensor="rgbd")
    images, poses_gt, _, depths = synthetic.render_sequence(
        cfg.camera, n_frames=18, n_points=400, seed=5, step=0.05, with_depth=True)
    root = str(tmp_path / "rgbd_seq")
    stamps = [i / cfg.camera.fps for i in range(len(images))]
    assoc = mini_dataset.write_tum_rgbd(root, images, depths, stamps)
    yaml = mini_dataset.write_settings_yaml(
        str(tmp_path / "RGBD_mini.yaml"), cfg, depth_map_factor=5000.0)
    args = ["tum-rgbd", root, assoc, yaml]
    monkeypatch.setenv("ORB_TPU_FUSED_TRACK", "1")
    monkeypatch.delenv("ORB_TPU_FORCE_PACKED", raising=False)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _port_main(args + [port_out, "--sync", "--no-vocab"]) == 0
    rmse, span = _ate_vs_gt(port_out + "_tum.txt", poses_gt, cfg.camera.fps,
                            align_scale=False)
    assert rmse < 0.02 * span, (rmse, span)

    with jax.enable_x64(False):
        assert _jax_main(args + [jax_out, "--sync", "--no-vocab"]) == 0
    ours, theirs = _tum_poses(port_out + "_tum.txt"), _tum_poses(jax_out + "_tum.txt")
    assert ours.keys() == theirs.keys() and len(ours) == len(images)
    for ts in ours:
        (Ra, ta), (Rb, tb) = ours[ts], theirs[ts]
        assert _rot_deg(Ra, Rb) < ROT_DEG_TOL, ts
        assert np.abs(ta - tb).max() < T_TOL, ts


def test_euroc_stereo_end_to_end_from_disk(tmp_path):
    cfg = synthetic_config(width=400, height=300, n_features=1000, sensor="stereo")
    cam = cfg.camera
    raw_cam = dataclasses.replace(cam, k1=-0.06, k2=0.01)
    f, cx, cy, b = cam.fx, cam.cx, cam.cy, cam.baseline
    scene = synthetic.make_scene(np.random.default_rng(9), n_points=500)
    poses = synthetic.look_ahead_trajectory(22, step=0.06)
    d2r = np.pi / 180.0
    Rp_l = synthetic.mount_rotation(yaw=1.2 * d2r, pitch=0.5 * d2r)
    Rp_r = synthetic.mount_rotation(yaw=-0.8 * d2r, pitch=0.7 * d2r, roll=0.4 * d2r)
    lefts, rights = [], []
    for R, t in poses:
        C_l = -R.T @ t
        C_r = -R.T @ (t - np.array([b, 0.0, 0.0]))
        R_l, R_r = Rp_l @ R, Rp_r @ R
        lefts.append(synthetic.render(scene, R_l, -R_l @ C_l, raw_cam))
        rights.append(synthetic.render(scene, R_r, -R_r @ C_r, raw_cam))
    root = str(tmp_path / "euroc_stereo")
    stamps = [i / cam.fps for i in range(len(poses))]
    mini_dataset.write_euroc(root, np.stack(lefts), stamps, rights=np.stack(rights))
    yaml = mini_dataset.write_settings_yaml(str(tmp_path / "EuRoC_stereo_mini.yaml"), cfg)
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    D = np.array([-0.06, 0.01, 0.0, 0.0, 0.0])
    P = np.hstack([K, np.zeros((3, 1))])
    # The raw cameras were rendered with x_cam = Rp @ x_rect, so R = Rp^T.
    mini_dataset.append_euroc_stereo_blocks(yaml, K, D, Rp_l.T, P, K, D, Rp_r.T, P)
    out = str(tmp_path / "traj")
    assert _port_main(["euroc-stereo", root, yaml, out, "--sync", "--no-vocab"]) == 0
    rmse, span = _ate_vs_gt(out + "_tum.txt", poses, cam.fps, align_scale=False)
    assert rmse < 0.025 * span, (rmse, span)


def test_usage_without_a_mode(capsys):
    assert run_dataset.main([]) == 1
    assert run_dataset.main(["no-such-mode", "x", "y"]) == 1
    assert "tum-rgbd" in capsys.readouterr().out
