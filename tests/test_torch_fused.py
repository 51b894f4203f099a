"""The port's fused tracker pair on the CPU against the JAX package's
jitted twins, on the same numpy inputs (interop.fused_example_arrays at
320x240 / 400 features / 256 last-frame points / 512 candidates):
fused_motion_track_packed_jit against its JAX namesake, with the
prediction at frame 1's ground truth and with one that forces the
widen-on-failure retry (both searches from one K6 call with two
windows), and fused_local_map_track_jit against its JAX namesake (on
the CPU each single-dispatch form is its eager function). Each JAX
motion result is computed once for the module. Bindings, inlier flags and counts equal;
keypoints within 1e-4 px; pose within 0.05 deg / 2e-3.

The JAX twins run on their packed extraction route (the port's route) in
32-bit mode. That route blurs with the Pallas level kernel, whose
interpreter rounds a few blurred values differently from plain float32
(ROADMAP.md section 3), so a few descriptors differ: at most 1% of them.
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
from orb_slam2_commit_tpu_torch.kernels import matching as kmatching
from orb_slam2_commit_tpu_torch.ops import extractor
from orb_slam2_commit_tpu_torch.slam import jit_frontend, matchers

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


W, H, N_FEAT, N_PTS, N_CAND = 320, 240, 400, 256, 512
LM_TH = 3.0          # config.tracker.search_radius_local_map


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


@pytest.fixture(scope="module")
def example():
    config, a = interop.fused_example_arrays(W, H, N_FEAT, N_PTS, N_CAND, device="cpu")
    return config, a, j_synthetic_config(width=W, height=H, n_features=N_FEAT)


def _motion_inputs(a, case):
    """(image, pt_f32, pt_desc, meta_f32). "widen_retry": a prediction
    rotated 0.07 rad about y and every sixth point kept, so the search at
    th finds fewer than 20 matches and the one at 2 th more."""
    pt_f32, meta = a["pt_f32"].copy(), a["meta_f32"].copy()
    if case == "widen_retry":
        c, s = np.cos(0.07), np.sin(0.07)
        Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        meta[0:9] = (Ry @ meta[0:9].reshape(3, 3)).reshape(-1)
        meta[9:12] = Ry @ meta[9:12]
        pt_f32[np.arange(pt_f32.shape[0]) % 6 != 0, 5] = 0.0
    return a["image"], pt_f32, a["pt_desc"], meta


@pytest.fixture(scope="module")
def jax_motion(example):
    """case -> the JAX motion stage's output on its inputs, each run once
    (the local-map test reuses the "predicted" case's)."""
    cache = {}

    def run(case):
        if case not in cache:
            _, a, jconfig = example
            with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
                mp.setenv("ORB_TPU_FORCE_PACKED", "1")
                out = jjf.fused_motion_track_packed_jit(
                    *(jnp.asarray(x) for x in _motion_inputs(a, case)), jconfig)
                cache[case] = [np.asarray(x) for x in out]
        return cache[case]

    return run


def _check_motion(got, ref):
    (gm, gf, gd), (rm, rf, rd) = got, ref
    np.testing.assert_array_equal(gm[12:], rm[12:])             # matches, inliers
    assert rot_angle(gm[0:9].reshape(3, 3), rm[0:9].reshape(3, 3)) < 0.05
    assert np.linalg.norm(gm[9:12] - rm[9:12]) < 2e-3
    np.testing.assert_allclose(gf[:, 0:4], rf[:, 0:4], atol=1e-4, rtol=0)   # xy
    np.testing.assert_array_equal(gf[:, 4], rf[:, 4])            # response
    assert np.abs(np.angle(np.exp(1j * (gf[:, 5] - rf[:, 5].astype(np.float64))))).max() < 2e-4
    np.testing.assert_array_equal(gf[:, 6:12], rf[:, 6:12])      # octave .. inlier
    assert np.any(gd != rd, axis=1).mean() <= 0.01


@pytest.mark.parametrize("case", ["predicted", "widen_retry"])
def test_fused_motion_track_matches_jax(monkeypatch, example, jax_motion, case):
    config, a, jconfig = example
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    args = _motion_inputs(a, case)
    ref = jax_motion(case)
    targs = interop.packed_from_numpy(*args, device="cpu")
    # Both searches (th and 2 th) come from one K6 call with two windows.
    calls = []
    top2 = kmatching.projection_hamming_top2
    monkeypatch.setattr(kmatching, "projection_hamming_top2",
                        lambda *a, **k: calls.append(a) or top2(*a, **k))
    got = interop.packed_to_numpy(*jit_frontend.fused_motion_track_packed_jit(*targs, config))
    assert len(calls) == 1 and len(calls[0][2]) == 2
    assert got[2].dtype == np.uint32 and got[1].shape == (N_FEAT, jit_frontend.OUT_FEAT_COLS)
    _check_motion(got, ref)

    # Which search the result comes from.
    image, pt_f32, pt_desc, meta = targs
    cam = config.camera
    feats = extractor.extract_features(image, config.orb, cam.height, cam.width)
    first = matchers.match_projection_last_frame(
        pt_f32[:, 0:3], pt_desc, pt_f32[:, 3].to(torch.int32), pt_f32[:, 4],
        pt_f32[:, 5] > 0.5, meta[0:9].reshape(3, 3), meta[9:12],
        feats.xy, feats.desc, feats.angle, feats.octave, feats.valid,
        cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width), float(cam.height),
        th=config.tracker.search_radius_motion)
    n1 = int(first.count())
    if case == "widen_retry":
        assert n1 < 20 <= int(got[0][12])
    else:
        assert n1 == int(got[0][12]) > 100
        assert int(got[0][13]) > 0.8 * n1


def _local_map_inputs(motion, a, th):
    """The local-map stage's inputs from a motion-stage result, built in
    numpy as the tracker's host code builds them."""
    meta, feat, desc = motion
    binding = feat[:, 10].astype(np.int64)
    bound = (binding >= 0) & (feat[:, 11] > 0.5)
    feat_state = np.zeros((feat.shape[0], jit_frontend.LM_FEAT_COLS), np.float32)
    feat_state[:, 0:3] = a["pt_f32"][np.maximum(binding, 0), 0:3]
    feat_state[:, 3] = bound
    lm_meta = np.concatenate([meta[0:12], [th]]).astype(np.float32)
    return feat, desc, feat_state, a["cand_f32"], a["cand_desc"], lm_meta


def test_fused_local_map_track_matches_jax(monkeypatch, example, jax_motion):
    config, a, jconfig = example
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    motion = jax_motion("predicted")
    inputs = _local_map_inputs(motion, a, LM_TH)
    with jax.enable_x64(False):
        ref = [np.asarray(x) for x in jjf.fused_local_map_track_jit(
            *(jnp.asarray(x) for x in inputs), jconfig)]
    got = interop.packed_to_numpy(*jit_frontend.fused_local_map_track_jit(
        *interop.packed_from_numpy(*inputs, device="cpu"), config))

    (gm, gp, gv), (rm, rp, rv) = got, ref
    assert gm.shape == (jit_frontend.LM_META_LEN,)
    np.testing.assert_array_equal(gv, rv)                        # visible
    np.testing.assert_array_equal(gp, rp)                        # binding, inlier
    assert gm[12] == rm[12]                                      # n_inliers
    assert rot_angle(gm[0:9].reshape(3, 3), rm[0:9].reshape(3, 3)) < 0.05
    assert np.linalg.norm(gm[9:12] - rm[9:12]) < 2e-3
    assert (gp[:, 0] >= 0).sum() > 10 and gv.sum() > 50
    assert gm[12] >= motion[0][13]


def test_local_map_args_build_the_trackers_state(example):
    """interop.local_map_args builds the same state on the device as the
    tracker's host code, and the pair runs through the entry points."""
    config, motion_args, cands = interop.make_fused_example(
        W, H, N_FEAT, N_PTS, N_CAND, device="cpu")
    out = jit_frontend.fused_motion_track_packed(*motion_args, config)
    feat_state, lm_meta = interop.local_map_args(out, motion_args[1], LM_TH)
    motion = interop.packed_to_numpy(*out)
    want = _local_map_inputs(motion, example[1], LM_TH)
    np.testing.assert_array_equal(feat_state.numpy(), want[2])
    np.testing.assert_array_equal(lm_meta.numpy(), want[5])
    meta, perfeat, visible = jit_frontend.fused_local_map_track(
        out[1], out[2], feat_state, *cands, lm_meta, config)
    assert torch.isfinite(meta).all() and perfeat.shape == (N_FEAT, 2)
    assert visible.shape == (N_CAND,)
