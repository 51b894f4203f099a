"""The port's stereo and RGB-D motion stages on the CPU against the JAX
package's jitted twins, on the same numpy inputs
(interop.fused_example_arrays at 320x240 / 400 features / 256 last-frame
points / 512 candidates): the port's fused_stereo_motion_track_packed_jit
against its JAX namesake (the example's tz_rel, and one beyond
+-baseline each way, which switches the stereo octave rule), and
fused_rgbd_motion_track_packed_jit against its JAX namesake; then
fused_local_map_track_jit on each stage's result against its JAX
namesake, with the stereo rows in its pose BA. On the CPU each of the
port's single-dispatch forms is its eager function.

Held equal: octaves, valid flags, bindings and match counts; keypoints
within 1e-4 px; poses within 0.05 deg / 2e-3; inlier counts within 1%;
RGB-D depth bit for bit and ur within 1e-4 px (ur = x - bf / depth moves
with the refined keypoint); stereo ur within 1e-3 px and depth =
bf / (x - ur) to 1e-5 relative on each side (tests/test_torch_stereo.py
says why). The JAX twins run on their packed extraction route in 32-bit
mode, whose Pallas interpreter blur flips a few descriptor bits (at most
1% of descriptors, as in tests/test_torch_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam import jit_frontend as jjf
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam import jit_frontend

torch.set_num_threads(1)

W, H, N_FEAT, N_PTS, N_CAND = 320, 240, 400, 256, 512
LM_TH = 3.0          # config.tracker.search_radius_local_map

# (sensor, tz_rel override or None for the example's own).
CASES = {
    "stereo": ("stereo", None),
    "stereo_forward": ("stereo", 0.5),
    "stereo_backward": ("stereo", -0.5),
    "rgbd": ("rgbd", None),
}
PORT = {"stereo": jit_frontend.fused_stereo_motion_track_packed_jit,
        "rgbd": jit_frontend.fused_rgbd_motion_track_packed_jit}
JAX = {"stereo": jjf.fused_stereo_motion_track_packed_jit,
       "rgbd": jjf.fused_rgbd_motion_track_packed_jit}
SECOND = {"stereo": "image_r", "rgbd": "depth"}


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def _motion_inputs(a, sensor, tz_rel):
    meta = a["meta_f32"].copy()
    if tz_rel is not None:
        meta[12] = tz_rel
    return a["image"], a[SECOND[sensor]], a["pt_f32"], a["pt_desc"], meta


def _local_map_inputs(motion, pt_f32):
    """The local-map stage's numpy inputs from a motion-stage result, built
    by interop.local_map_args as the tracker builds them."""
    feat_state, lm_meta = interop.local_map_args(
        tuple(torch.from_numpy(np.array(x)) for x in motion[:2]) + (None,),
        torch.from_numpy(pt_f32), LM_TH)
    return motion[1], motion[2], feat_state.numpy(), lm_meta.numpy()


@pytest.fixture(scope="module")
def reference():
    """Per sensor the example arrays and configs; per case the JAX motion
    stage's output; per sensor the JAX local-map stage on the output of
    its first case."""
    examples, motion, local = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setenv("ORB_TPU_FORCE_PACKED", "1")
        for sensor in ("stereo", "rgbd"):
            config, a = interop.fused_example_arrays(
                W, H, N_FEAT, N_PTS, N_CAND, device="cpu", sensor=sensor)
            examples[sensor] = (config, a, j_synthetic_config(W, H, N_FEAT, sensor=sensor))
        for case, (sensor, tz_rel) in CASES.items():
            _, a, jconfig = examples[sensor]
            args = _motion_inputs(a, sensor, tz_rel)
            motion[case] = [np.asarray(x) for x in JAX[sensor](
                *(jnp.asarray(x) for x in args), jconfig)]
        for sensor in ("stereo", "rgbd"):
            _, a, jconfig = examples[sensor]
            feat, desc, feat_state, lm_meta = _local_map_inputs(motion[sensor], a["pt_f32"])
            inputs = (feat, desc, feat_state, a["cand_f32"], a["cand_desc"], lm_meta)
            local[sensor] = (inputs, [np.asarray(x) for x in jjf.fused_local_map_track_jit(
                *(jnp.asarray(x) for x in inputs), jconfig)])
    return examples, motion, local


def _check_stereo_columns(gf, rf, bf):
    ur_ok = rf[:, 9] >= 0
    np.testing.assert_array_equal(gf[:, 9] >= 0, ur_ok)
    assert ur_ok.sum() > 0.3 * N_FEAT
    assert np.abs(gf[:, 9] - rf[:, 9])[ur_ok].max() <= 1e-3
    for f in (gf, rf):
        assert (f[~ur_ok, 8:10] == -1).all()
        np.testing.assert_allclose(f[ur_ok, 8], bf / (f[ur_ok, 2] - f[ur_ok, 9]),
                                   rtol=1e-5, atol=0)


def _check_rgbd_columns(gf, rf):
    np.testing.assert_array_equal(gf[:, 8], rf[:, 8])
    np.testing.assert_allclose(gf[:, 9], rf[:, 9], atol=1e-4, rtol=0)
    assert (rf[:, 8] > 0).sum() > 0.5 * N_FEAT


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_sensor_motion_track_matches_jax(reference, case):
    examples, motion, _ = reference
    sensor, tz_rel = CASES[case]
    config, a, _ = examples[sensor]
    args = interop.packed_from_numpy(*_motion_inputs(a, sensor, tz_rel), device="cpu")
    got = interop.packed_to_numpy(*PORT[sensor](*args, config))
    (gm, gf, gd), (rm, rf, rd) = got, motion[case]
    assert gf.shape == (N_FEAT, jit_frontend.OUT_FEAT_COLS) and gd.dtype == np.uint32

    assert gm[12] == rm[12] > 100                                 # n_matches
    assert abs(gm[13] - rm[13]) <= 0.01 * rm[13]                  # n_inliers
    assert rot_angle(gm[0:9].reshape(3, 3), rm[0:9].reshape(3, 3)) < 0.05
    assert np.linalg.norm(gm[9:12] - rm[9:12]) < 2e-3
    np.testing.assert_allclose(gf[:, 0:4], rf[:, 0:4], atol=1e-4, rtol=0)   # xy
    np.testing.assert_array_equal(gf[:, 4], rf[:, 4])             # response
    np.testing.assert_array_equal(gf[:, 6:8], rf[:, 6:8])         # octave, valid
    np.testing.assert_array_equal(gf[:, 10], rf[:, 10])           # binding
    assert (gf[:, 11] != rf[:, 11]).mean() <= 0.01                # inlier flags
    assert np.any(gd != rd, axis=1).mean() <= 0.01
    if sensor == "stereo":
        _check_stereo_columns(gf, rf, config.camera.bf)
    else:
        _check_rgbd_columns(gf, rf)
    # Stereo observations reach the pose BA: bound features with ur.
    assert ((gf[:, 9] >= 0) & (gf[:, 10] >= 0)).sum() > 50


def test_octave_rule_cases_differ(reference):
    """tz_rel beyond +-baseline changes the octaves searched, so the three
    stereo cases do not all bind the same features."""
    _, motion, _ = reference
    bindings = [motion[c][1][:, 10] for c in ("stereo", "stereo_forward", "stereo_backward")]
    assert not (np.array_equal(bindings[0], bindings[1])
                and np.array_equal(bindings[0], bindings[2]))


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_fused_local_map_track_after_sensor_matches_jax(reference, sensor):
    examples, motion, local = reference
    config = examples[sensor][0]
    inputs, ref = local[sensor]
    got = interop.packed_to_numpy(*jit_frontend.fused_local_map_track_jit(
        *interop.packed_from_numpy(*inputs, device="cpu"), config))
    (gm, gp, gv), (rm, rp, rv) = got, ref
    np.testing.assert_array_equal(gv, rv)                        # visible
    np.testing.assert_array_equal(gp, rp)                        # binding, inlier
    assert gm[12] == rm[12] >= motion[sensor][0][13]             # n_inliers
    assert rot_angle(gm[0:9].reshape(3, 3), rm[0:9].reshape(3, 3)) < 0.05
    assert np.linalg.norm(gm[9:12] - rm[9:12]) < 2e-3
    assert (gp[:, 0] >= 0).sum() > 10 and gv.sum() > 50


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_sensor_pair_through_the_entry_points(sensor):
    """make_fused_example(sensor=...) gives the motion stage's packed
    arguments; the pair runs on them through the entry points."""
    config, motion_args, cands = interop.make_fused_example(
        W, H, N_FEAT, N_PTS, N_CAND, device="cpu", sensor=sensor)
    assert config.sensor == sensor and len(motion_args) == 5
    out = PORT[sensor](*motion_args, config)
    feat_state, lm_meta = interop.local_map_args(out, motion_args[2], LM_TH)
    meta, perfeat, visible = jit_frontend.fused_local_map_track(
        out[1], out[2], feat_state, *cands, lm_meta, config)
    assert torch.isfinite(meta).all() and perfeat.shape == (N_FEAT, 2)
    assert visible.shape == (N_CAND,) and float(meta[12]) >= float(out[0][13]) > 100
