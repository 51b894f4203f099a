"""Port's camera model (ops/camera.py) on the CPU against the JAX package:
undistortion with TUM1-size coefficients within 1e-4 px, the rest of the
module to float32 rounding, and no-ops without distortion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import camera as jcamera
from orb_slam2_commit_tpu.utils.config import tum_fr1_config
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import camera
from orb_slam2_commit_tpu_torch.utils.config import CameraConfig, synthetic_config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before



def _cams():
    jcam = tum_fr1_config().camera
    fields = {f: getattr(jcam, f) for f in CameraConfig.__dataclass_fields__}
    return jcam, CameraConfig(**fields)


def _pixels(seed=0, n=500):
    rng = np.random.default_rng(seed)
    uv = rng.uniform([0, 0], [640, 480], (n, 2))
    uv[:4] = [[0, 0], [639, 0], [0, 479], [639, 479]]       # image corners
    return uv.astype(np.float32)


def test_undistort_pixels_matches_jax():
    jcam, cam = _cams()
    assert cam.has_distortion
    uv = _pixels()
    with jax.enable_x64(False):
        ref = np.asarray(jcamera.undistort_pixels(jnp.asarray(uv), jcam))
    got = camera.undistort_pixels(torch.from_numpy(uv), cam).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # Round trip through the distortion model.
    xn = (got - [cam.cx, cam.cy]) / [cam.fx, cam.fy]
    back = camera.distort_normalized(torch.from_numpy(xn), cam).numpy()
    np.testing.assert_allclose(back * [cam.fx, cam.fy] + [cam.cx, cam.cy], uv, atol=2e-3)


def test_projection_and_distortion_match_jax():
    jcam, cam = _cams()
    rng = np.random.default_rng(1)
    pc = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                   rng.uniform(0.5, 8, 200)], -1).astype(np.float32)
    xn = rng.uniform(-0.6, 0.6, (200, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 8, 200).astype(np.float32)
    uv = _pixels(2, 200)
    with jax.enable_x64(False):
        refs = [np.asarray(x) for x in (
            jcamera.project(jnp.asarray(pc), jcam),
            jcamera.project_stereo(jnp.asarray(pc), jcam),
            jcamera.distort_normalized(jnp.asarray(xn), jcam),
            jcamera.unproject(jnp.asarray(uv), jnp.asarray(depth), jcam))]
    gots = [x.numpy() for x in (
        camera.project(torch.from_numpy(pc), cam),
        camera.project_stereo(torch.from_numpy(pc), cam),
        camera.distort_normalized(torch.from_numpy(xn), cam),
        camera.unproject(torch.from_numpy(uv), torch.from_numpy(depth), cam))]
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("n", [4, 7])
def test_undistort_is_a_no_op_without_distortion(n):
    cam = synthetic_config(width=320, height=240).camera
    assert not cam.has_distortion
    uv = torch.from_numpy(_pixels(3, n))
    assert camera.undistort_pixels(uv, cam) is uv
