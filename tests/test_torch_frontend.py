"""The port's tracking step (extraction, projection matching, pose-only
LM) on the CPU against the JAX package's step on the arrays of
__graft_entry__._make_example(), with subpixel refinement off and on (the
default): equal match and inlier counts, pose within
test_pallas_pose_opt.py's bounds, keypoints equal (refinement off) or
within 1e-4 px (on).

The JAX step runs with its packed extraction route forced on (the route
the port takes) and in 32-bit mode: under the suite's x64 mode its
float32 pose would be promoted to float64 by the float sigma table and
the carried LM state would change type.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from orb_slam2_commit_tpu.slam.jit_frontend import tracking_forward_step_jit as jax_step
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam.jit_frontend import tracking_forward_step
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)


def rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def _no_subpix(cfg):
    return dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, subpixel_refine=False))


@pytest.fixture(scope="module")
def example():
    config, args = graft._make_example()
    return config, [np.asarray(a) for a in args]


def _step_pair(monkeypatch, example, refine):
    config, np_args = example
    tconfig = synthetic_config(width=320, height=240, n_features=400)
    if not refine:
        config, tconfig = _no_subpix(config), _no_subpix(tconfig)
    assert config.orb.subpixel_refine == tconfig.orb.subpixel_refine == refine
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    with jax.enable_x64(False):
        ref = jax_step(*(jnp.asarray(a) for a in np_args), config)
        ref = {k: np.asarray(v) for k, v in ref._asdict().items()}

    before = dict(_build.launches)
    got = interop.step_to_numpy(tracking_forward_step(
        *interop.map_from_numpy(*np_args, device="cpu"), tconfig))
    assert _build.launches == before

    assert int(got["n_matches"]) == int(ref["n_matches"]) > 50
    assert int(got["n_inliers"]) == int(ref["n_inliers"])
    assert rot_angle(got["R"].astype(np.float64), ref["R"]) < 0.05
    assert np.linalg.norm(got["t"] - ref["t"]) < 2e-3
    return got, ref


def test_tracking_step_matches_jax(monkeypatch, example):
    got, ref = _step_pair(monkeypatch, example, refine=False)
    np.testing.assert_array_equal(got["feat_xy"], ref["feat_xy"])


def test_tracking_step_with_refinement_matches_jax(monkeypatch, example):
    got, ref = _step_pair(monkeypatch, example, refine=True)
    np.testing.assert_allclose(got["feat_xy"], ref["feat_xy"], atol=1e-4, rtol=0)


def test_make_example_and_step_on_cpu():
    config, args = interop.make_example(device="cpu")
    assert config.orb.subpixel_refine            # the default configuration
    assert all(a.device.type == "cpu" for a in args)
    assert int(args[5].sum()) > 50                    # bound map points
    res = tracking_forward_step(*args, config)
    assert res.R.shape == (3, 3) and res.t.shape == (3,)
    assert torch.isfinite(res.R).all() and torch.isfinite(res.t).all()
    # The prediction is frame 1's ground truth: the step stays near it.
    assert rot_angle(res.R.numpy().astype(np.float64),
                     args[6].numpy().astype(np.float64)) < 0.5
    assert int(res.n_inliers) > 0.8 * int(res.n_matches) > 40


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        interop.make_example()
