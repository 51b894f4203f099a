"""The port on real-camera input, on the CPU: lens distortion and KITTI's
canvas.

- tests/test_distortion.py's System case through the port: the monocular
  System on 30 frames rendered through TUM1's lens (640x480, 1000
  features), its gates (OK at the end, >= 3 keyframes, scale-aligned ATE
  under 0.10 x span); and TUM1's undistortion round trip under 0.01 px.
- One stereo pair of the KITTI 00-02 cell (1241x376, 2000 features, the
  drive's frame 0 under CAMERA_PHOTO, as 8-bit images) through the JAX
  package's make_stereo_frame (slam/frame.py:127, on its packed
  extraction route in 32-bit mode) and the port's: valid flags and
  octaves equal, keypoints within 1e-4 px, at most 1% of descriptors
  differing, held as tests/test_torch_stereo.py holds them (the JAX
  packed route's interpreted Pallas blur rounds a few values otherwise),
  and u_right within tests/test_torch_stereo.py's 1e-3 px (7.6e-6 px
  measured there) wherever both are valid.

The dataset input paths (8-bit images, raw 16-bit depth) are held in
tests/test_torch_image_input.py.

Nothing launches a kernel on the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam import frame as jframe
from orb_slam2_commit_tpu.utils import config as jconfig
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import camera as cam_ops
from orb_slam2_commit_tpu_torch.slam import frame
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState
from orb_slam2_commit_tpu_torch.utils import config, synthetic
from orb_slam2_commit_tpu_torch.utils import trajectory as traj

torch.set_num_threads(1)

XY_TOL, DESC_FLIP, U_RIGHT_TOL = 1e-4, 0.01, 1e-3


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def test_undistort_roundtrip_tum1():
    cam = config.tum_fr1_config().camera
    uu, vv = np.meshgrid(np.linspace(0.0, cam.width - 1, 33),
                         np.linspace(0.0, cam.height - 1, 25))
    x = torch.tensor(np.stack([((uu - cam.cx) / cam.fx).ravel(),
                               ((vv - cam.cy) / cam.fy).ravel()], -1))
    xu = cam_ops.undistort_normalized(cam_ops.distort_normalized(x, cam), cam)
    err_px = np.abs((xu - x).numpy()) * np.array([cam.fx, cam.fy])
    assert err_px.max() < 0.01, err_px.max()


def test_mono_system_on_distorted_images():
    cfg = config.synthetic_config(width=640, height=480, n_features=1000)
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314))
    assert cfg.camera.has_distortion
    images, poses_gt, _ = synthetic.render_sequence(
        cfg.camera, n_frames=30, n_points=400, seed=3, step=0.05)
    sys_ = System(cfg, device="cpu")
    for i in range(images.shape[0]):
        sys_.track_monocular(images[i], i / 30.0)
    sys_.shutdown()
    assert sys_.tracking_state() == TrackingState.OK
    assert sys_.map.n_keyframes() >= 3
    est = sys_.trajectory_positions()
    ok = ~np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    rmse = traj.ate_rmse(est[ok], gt[len(poses_gt) - len(est):][ok], align_scale=True)
    span = np.linalg.norm(gt[-1] - gt[0])
    assert rmse < 0.10 * span, (rmse, span)


def _kitti_configs():
    ours = config.kitti_00_02_config()
    theirs = jconfig.SLAMConfig(camera=jconfig.CameraConfig(**dataclasses.asdict(ours.camera)),
                                orb=jconfig.ORBConfig(**dataclasses.asdict(ours.orb)),
                                sensor="stereo")
    return ours, theirs


def test_kitti_stereo_pair_matches_jax(monkeypatch):
    cfg, jcfg = _kitti_configs()
    frames, _, _ = synthetic.drive_frames(cfg.camera, n_frames=1600, stereo=True, seed=7,
                                          photo=synthetic.CAMERA_PHOTO)
    _, left, right = next(frames())
    left, right = (np.clip(np.round(x), 0, 255).astype(np.uint8) for x in (left, right))
    got = frame.make_stereo_frame(left, right, 0, 0.0, cfg, device="cpu")
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    with jax.enable_x64(False):
        want = jframe.make_stereo_frame(left, right, 0, 0.0, jcfg)
    valid = np.asarray(want.valid)
    assert valid.sum() > 0.8 * cfg.orb.n_features
    np.testing.assert_array_equal(got.valid, valid)
    np.testing.assert_array_equal(got.octave, np.asarray(want.octave))
    np.testing.assert_allclose(got.xy_raw, np.asarray(want.xy_raw), atol=XY_TOL, rtol=0)
    np.testing.assert_allclose(got.xy, np.asarray(want.xy), atol=XY_TOL, rtol=0)
    assert np.any(got.desc != np.asarray(want.desc), axis=1).mean() <= DESC_FLIP
    ur, jur = got.ur, np.asarray(want.ur)
    both = (ur >= 0) & (jur >= 0)
    assert both.sum() > 0.3 * cfg.orb.n_features
    assert ((ur >= 0) != (jur >= 0)).mean() <= DESC_FLIP
    assert np.abs(ur - jur)[both].max() <= U_RIGHT_TOL
