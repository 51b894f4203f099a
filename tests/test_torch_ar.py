"""The port's AR anchoring (slam/ar.py) against the JAX package's.

fit_plane_ransac runs on JAX's own sample index sets
(`jax.random.randint(key, (n_iters, 3), 0, n)`, slam/ar.py:63) on the same
float32 clouds: the refitted normal equal up to sign within 1e-5 (the
eigenvector's sign is arbitrary in both), the offset with the same sign
within 1e-5, the centroid within 1e-5, and n_inliers and every inlier flag
equal. The clouds cover an even and an odd count of points (the scene
scale is a median: an even count averages its two middle values), with
and without invalid points. plane_frame, cube_vertices and draw_cube are
byte-equal to JAX's; ARAnchor anchors on tests/test_ar.py's planar
synthetic cloud. Nothing launches a kernel on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam import ar as jar
from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam import ar
from orb_slam2_commit_tpu_torch.utils import synthetic

torch.set_num_threads(1)

TOL = 1e-5


def _plane_cloud(rng, n_plane=120, n_out=40, noise=0.01):
    """tests/test_ar.py's cloud: points near n.x - 2 = 0 and gross outliers."""
    nrm = np.array([0.2, 0.9, -0.3])
    nrm /= np.linalg.norm(nrm)
    basis = np.linalg.svd(nrm[None, :])[2][1:]
    uv = rng.uniform(-3, 3, (n_plane, 2))
    pts_plane = uv @ basis + 2.0 * nrm + noise * rng.normal(size=(n_plane, 3))
    pts_out = rng.uniform(-4, 4, (n_out, 3)) + np.array([0, 0, 8.0])
    return np.concatenate([pts_plane, pts_out]).astype(np.float32), nrm


CLOUDS = {   # name -> (seed, n_plane, n_out, every k-th point invalid or 0)
    "even, all valid": (0, 120, 40, 0),
    "odd, all valid": (1, 121, 40, 0),
    "even, some invalid": (2, 150, 50, 7),
    "odd, some invalid": (3, 99, 30, 5),
}


def _fits(pts, valid, seed, n_iters=128):
    key = jax.random.key(seed)
    want = jar.fit_plane_ransac(jnp.asarray(pts), jnp.asarray(valid), key, n_iters=n_iters)
    idx = np.array(jax.random.randint(key, (n_iters, 3), 0, len(pts)))
    before = dict(_build.launches)
    got = ar.fit_plane_ransac(torch.from_numpy(pts), torch.from_numpy(valid),
                              n_iters=n_iters, idx=torch.from_numpy(idx))
    assert _build.launches == before
    return got, want


@pytest.mark.parametrize("name", list(CLOUDS))
def test_fit_plane_ransac_equals_jax(name):
    seed, n_plane, n_out, k = CLOUDS[name]
    pts, nrm = _plane_cloud(np.random.default_rng(seed), n_plane, n_out)
    valid = np.ones(len(pts), bool)
    if k:
        valid[::k] = False
    got, want = _fits(pts, valid, seed)
    gn, wn = got.normal.numpy(), np.asarray(want.normal)
    sign = 1.0 if gn @ wn > 0 else -1.0
    np.testing.assert_allclose(sign * gn, wn, rtol=0, atol=TOL)
    np.testing.assert_allclose(sign * float(got.offset), float(want.offset), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.centroid.numpy(), np.asarray(want.centroid), rtol=0,
                               atol=TOL)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    # And the plane is the cloud's.
    assert abs(gn @ nrm) > 0.999
    assert int(got.n_inliers) >= 0.8 * valid[:n_plane].sum()


def test_fit_plane_ransac_on_the_synthetic_scene():
    """The planar scene run_ar tracks (60% of 400 landmarks on the ground
    plane of utils/synthetic.make_scene), every tenth point invalid."""
    scene = synthetic.make_scene(np.random.default_rng(3), n_points=400, planar_frac=0.6)
    pts = scene.points.astype(np.float32)
    valid = np.arange(len(pts)) % 10 != 0
    got, want = _fits(pts, valid, 5, n_iters=64)
    sign = 1.0 if got.normal.numpy() @ np.asarray(want.normal) > 0 else -1.0
    np.testing.assert_allclose(sign * got.normal.numpy(), np.asarray(want.normal), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    ground = np.array([0.1, 1.0, -0.15]) / np.linalg.norm([0.1, 1.0, -0.15])
    assert abs(got.normal.numpy() @ ground) > 0.9999


def test_generator_draws_repeat():
    pts, _ = _plane_cloud(np.random.default_rng(4))
    valid = torch.ones(len(pts), dtype=torch.bool)
    a = ar.fit_plane_ransac(torch.from_numpy(pts), valid, torch.Generator().manual_seed(9))
    b = ar.fit_plane_ransac(torch.from_numpy(pts), valid, torch.Generator().manual_seed(9))
    assert int(a.best) == int(b.best) and torch.equal(a.inliers, b.inliers)
    idx = ar.sample_indices(len(pts), 128, torch.Generator().manual_seed(9))
    assert idx.shape == (128, 3) and int(idx.min()) >= 0 and int(idx.max()) < len(pts)


@pytest.mark.parametrize("normal, centroid, cam", [
    ([0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, -5.0, 0.0]),
    ([0.95, 0.1, 0.3], [1.0, 2.0, 3.0], [0.0, 0.0, 0.0]),
    ([0.1, 1.0, -0.15], [0.0, 3.0, 8.0], [0.5, -1.0, 0.0]),
])
def test_plane_frame_equals_jax(normal, centroid, cam):
    got = ar.plane_frame(np.asarray(normal), np.asarray(centroid), np.asarray(cam))
    want = jar.plane_frame(np.asarray(normal), np.asarray(centroid), np.asarray(cam))
    assert got.tobytes() == want.tobytes()
    assert got[:3, 2] @ (np.asarray(cam) - np.asarray(centroid)) > 0


@pytest.mark.parametrize("size", [0.5, 1.0, 2.5])
def test_cube_equals_jax(size):
    assert ar.cube_vertices(size).tobytes() == jar.cube_vertices(size).tobytes()
    assert ar.CUBE_EDGES == jar.CUBE_EDGES
    h, w = 120, 160
    for center in ([0, 0, 5.0], [1.5, -0.5, 3.0], [0, 0, -5.0], [4.0, 0.0, 2.0]):
        Twp = ar.plane_frame(np.array([0, 0.3, 1.0]), np.array(center), np.zeros(3))
        got, want = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        a = ar.draw_cube(got, np.eye(3), np.zeros(3), 100.0, 100.0, w / 2, h / 2, Twp, size)
        b = jar.draw_cube(want, np.eye(3), np.zeros(3), 100.0, 100.0, w / 2, h / 2, Twp, size)
        assert a == b
        assert got.tobytes() == want.tobytes()


def test_anchor_on_synthetic_map_cloud():
    """tests/test_ar.py's end-to-end case: ARAnchor on the planar-fraction
    scene cloud, then the overlay; the same seed anchors the same frame,
    and the overlay equals JAX's draw_cube with the port's plane."""
    rng = np.random.default_rng(2)
    pts = synthetic.make_scene(rng, n_points=300, planar_frac=0.6).points
    assert np.array_equal(
        pts, jsynthetic.make_scene(np.random.default_rng(2), n_points=300, planar_frac=0.6).points)
    valid = np.ones(len(pts), bool)
    anchors = [ar.ARAnchor(min_points=40, seed=3, device="cpu") for _ in range(2)]
    assert all(a.update(pts, valid, cam_center=np.zeros(3)) for a in anchors)
    assert np.array_equal(anchors[0].Twp, anchors[1].Twp) and anchors[0].size > 0
    ground = np.array([0.1, 1.0, -0.15]) / np.linalg.norm([0.1, 1.0, -0.15])
    assert abs(anchors[0].Twp[:3, 2] @ ground) > 0.999
    canvas = np.zeros((300, 400, 3), np.uint8)
    assert anchors[0].overlay(canvas, np.eye(3), np.zeros(3), 350.0, 350.0, 200, 150)
    assert canvas.sum() > 0
    want = np.zeros_like(canvas)
    jar.draw_cube(want, np.eye(3), np.zeros(3), 350.0, 350.0, 200, 150, anchors[0].Twp,
                  anchors[0].size)
    assert canvas.tobytes() == want.tobytes()
    # Too few points: no anchor yet.
    late = ar.ARAnchor(min_points=400, device="cpu")
    assert not late.update(pts, valid, np.zeros(3))
    assert not late.overlay(canvas, np.eye(3), np.zeros(3), 350.0, 350.0, 200, 150)
