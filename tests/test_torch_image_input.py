"""The dataset input paths on the CPU: 8-bit images and raw 16-bit depth.

- The fused RGB-D stage on raw 16-bit depth (DepthMapFactor 5000) against
  the JAX package's jitted twin: depth bit for bit (the JAX stage's
  d / factor compiles to a product with the float32 reciprocal, which the
  port's stage computes too), ur within 1e-4 px.
- 8-bit input through every route: uint8 images and float32 copies of
  them (and 16-bit depth as uint16 and as float32 raw units,
  DepthMapFactor 5000) give identical frames, bit for bit, on the staged
  extraction, the stereo pair, the RGB-D pair and the fused motion stage
  of each sensor.

Nothing launches a kernel on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam import jit_frontend as jjf
from orb_slam2_commit_tpu.utils import config as jconfig
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam import frame, jit_frontend
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.utils import config, synthetic

torch.set_num_threads(1)

# The identity runs' frames: the fused motion stage takes frames 2-5 of
# the stereo and RGB-D runs and 4-5 of the monocular sweep (initialized at
# frame 3).
N_FRAMES = 6


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def test_fused_rgbd_raw_depth_matches_jax(monkeypatch):
    config, a = interop.fused_example_arrays(320, 240, 400, 256, 512, device="cpu",
                                             sensor="rgbd")
    config = dataclasses.replace(config, camera=dataclasses.replace(
        config.camera, depth_map_factor=5000.0))
    jcfg = jconfig.synthetic_config(320, 240, 400, sensor="rgbd")
    jcfg = dataclasses.replace(jcfg, camera=dataclasses.replace(jcfg.camera,
                                                                depth_map_factor=5000.0))
    raw = np.clip(np.round(a["depth"] * 5000.0), 0, 65535).astype(np.float32)
    args = (a["image"], raw, a["pt_f32"], a["pt_desc"], a["meta_f32"])
    _, gf, _ = interop.packed_to_numpy(*jit_frontend.fused_rgbd_motion_track_packed(
        *interop.packed_from_numpy(*args, device="cpu"), config))
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    with jax.enable_x64(False):
        rf = np.asarray(jjf.fused_rgbd_motion_track_packed_jit(
            *(jnp.asarray(x) for x in args), jcfg)[1])
    assert (rf[:, 8] > 0).sum() > 0.5 * 400
    np.testing.assert_array_equal(gf[:, 8], rf[:, 8])
    np.testing.assert_allclose(gf[:, 9], rf[:, 9], atol=1e-4, rtol=0)


def _same_frame(a, b):
    for key in ("xy", "xy_raw", "octave", "angle", "response", "desc", "valid", "depth", "ur",
                "point_ids"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    for key in ("R", "t"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)


def _as_u8(x):
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sensor", ["monocular", "stereo", "rgbd"])
def test_uint8_frames_equal_float32(sensor, monkeypatch):
    cfg = config.synthetic_config(width=400, height=300, n_features=1000, sensor=sensor)
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera,
                                                              depth_map_factor=5000.0))
    if sensor == "stereo":
        lefts, rights, _, _ = synthetic.render_stereo_sequence(
            cfg.camera, n_frames=N_FRAMES, n_points=400, seed=5, step=0.05)
        u8 = [(_as_u8(a), _as_u8(b)) for a, b in zip(lefts, rights)]
        f32 = [(a.astype(np.float32), b.astype(np.float32)) for a, b in u8]
    else:
        # The monocular tests' 40-frame sweep (its amplitude follows its
        # length), of which the first N_FRAMES run.
        scene = (dict(n_frames=40, n_points=500, seed=3, step=0.025, motion="sweep",
                      depth_range=(1.5, 4.0), spread=2.0) if sensor == "monocular"
                 else dict(n_frames=N_FRAMES, n_points=400, seed=5, step=0.05))
        images, _, _, depths = synthetic.render_sequence(cfg.camera, with_depth=True, **scene)
        images, depths = images[:N_FRAMES], depths[:N_FRAMES]
        raw = np.clip(np.round(depths * 5000.0), 0, 65535).astype(np.uint16)
        u8 = [(_as_u8(a), d) for a, d in zip(images, raw)]
        f32 = [(a.astype(np.float32), d.astype(np.float32)) for a, d in u8]

    # The staged extraction and the stereo and RGB-D frames.
    for (a, b), (fa, fb) in zip(u8[:2], f32[:2]):
        if sensor == "stereo":
            x = frame.make_stereo_frame(a, b, 0, 0.0, cfg, device="cpu")
            y = frame.make_stereo_frame(fa, fb, 0, 0.0, cfg, device="cpu")
        else:
            depth = (b, fb) if sensor == "rgbd" else (None, None)
            x = frame.make_frame(a, 0, 0.0, cfg, depth[0], device="cpu")
            y = frame.make_frame(fa, 0, 0.0, cfg, depth[1], device="cpu")
        x.set_pose(np.eye(3), np.zeros(3))
        y.set_pose(np.eye(3), np.zeros(3))
        _same_frame(x, y)
        assert sensor != "rgbd" or (x.depth > 0).any()

    # The fused motion stage, on both Systems from the frame after tracking
    # has a velocity.
    monkeypatch.setenv("ORB_TPU_FUSED_TRACK", "1")
    runs = []
    for seq in (u8, f32):
        sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
        fused = []
        for i, (a, b) in enumerate(seq):
            fused.append(sys_.tracker.can_fuse_motion())
            if sensor == "stereo":
                sys_.track_stereo(a, b, i / 30.0)
            elif sensor == "rgbd":
                sys_.track_rgbd(a, b, i / 30.0)
            else:
                sys_.track_monocular(a, i / 30.0)
        runs.append((sys_, fused))
    (x, fused_x), (y, fused_y) = runs
    assert fused_x == fused_y and any(fused_x)
    _same_frame(x.tracker.last_frame, y.tracker.last_frame)
    assert x.tracking_state() == y.tracking_state()
    for (ta, Ra, tta), (tb, Rb, ttb) in zip(x._resolve_trajectory(), y._resolve_trajectory()):
        assert ta == tb
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(tta, ttb)
