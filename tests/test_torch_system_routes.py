"""The port's System through its normal entry points on the per-level
extraction route (ORB_TPU_FORCE_PACKED=0, the gather form and the patch
form) against the same System on the packed route, on the CPU: a stereo
and an RGB-D run of 6 frames at 320x240 / 500 features (seed 5) track
every frame, insert the same keyframes and points, and land within
T_TOL m (the routes give the same features but for the subpixel
offsets' summation order, 4e-4 px at most in level-0 pixels,
tests/test_torch_extractor_levels.py). Nothing launches a kernel."""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT, N_FRAMES = 320, 240, 500, 6
SCENE = dict(n_frames=N_FRAMES, n_points=400, seed=5, step=0.05)
T_TOL = 1e-4


def _run(sensor, packed, patches, mp):
    mp.setenv("ORB_TPU_FORCE_PACKED", packed)
    mp.setenv("ORB_TPU_FORCE_PATCHES", patches)
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor=sensor)
    if sensor == "rgbd":
        first, _, _, second = synthetic.render_sequence(cfg.camera, with_depth=True, **SCENE)
    else:
        first, second, _, _ = synthetic.render_stereo_sequence(cfg.camera, **SCENE)
    sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
    track = sys_.track_rgbd if sensor == "rgbd" else sys_.track_stereo
    states = []
    for i in range(N_FRAMES):
        track(first[i], second[i], i / 30.0)
        states.append(sys_.tracking_state().name)
    return sys_, states


@pytest.fixture(scope="module")
def packed_runs():
    with pytest.MonkeyPatch.context() as mp:
        return {sensor: _run(sensor, "1", "0", mp) for sensor in ("stereo", "rgbd")}


@pytest.mark.parametrize("sensor,patches", [("stereo", "0"), ("stereo", "1"), ("rgbd", "1")])
def test_system_on_per_level_route(packed_runs, monkeypatch, sensor, patches):
    before = dict(_build.launches)
    sys_, states = _run(sensor, "0", patches, monkeypatch)
    assert _build.launches == before
    ref, ref_states = packed_runs[sensor]
    assert states == ref_states == ["OK"] * N_FRAMES
    assert (sys_.map.next_kf, sys_.map.next_pt) == (ref.map.next_kf, ref.map.next_pt)
    np.testing.assert_array_equal(sys_.map.kf_point_idx[:sys_.map.next_kf],
                                  ref.map.kf_point_idx[:ref.map.next_kf])
    np.testing.assert_allclose(sys_.trajectory_positions(), ref.trajectory_positions(),
                               atol=T_TOL)
