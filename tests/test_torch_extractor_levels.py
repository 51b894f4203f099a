"""The port's per-level ORB extraction (ORB_TPU_FORCE_PACKED=0) on the CPU
against the JAX package's per-level route, and against the port's packed
route.

JAX side: `extract_features` under jax.jit (the route flags are read when
it traces, so the compile caches are cleared between routes), on the
gather route (ORB_TPU_FORCE_PATCHES=0) and on the patch route (=1, its
Pallas level and patch kernels run by their interpreter, as JAX's own
tests run them), at 320x240, 400 features and N_LEVELS_JAX levels (the
JAX compile of eight levels alone takes ~30 s a route here).

Held equal: valid, octave, response, descriptor bits, and xy with
subpixel refinement off (integer positions times the level's float32
scale). With refinement on (the patch-route case) xy within XY_TOL px: the
offsets are the same float32 solve summed in another order. The angle on
the gather route within ANGLE_ATOL_GATHER (the same float32 moment maps;
XLA's fused atan2 rounds apart by a few ulps), on the patch route within
ANGLE_ATOL_PATCH (the JAX route sums the moments in float32, the port in
float64: tests/test_torch_extractor.py measured 7.9e-5 rad at most).

The port's per-level route against its packed route at 8 levels and
400 features, on a random and a rendered frame, held as JAX
tests/test_packed_extractor.py holds its two routes: valid, octave,
response and descriptors equal, xy within 2e-3 px, the angle within 1e-6
rad on the patch route (the same windows and float64 sums); on the gather
route within ANGLE_ATOL_PATCH (float32 moment maps against float64 sums).

Also alone: resize_bilinear (within RESIZE_ATOL: the CPU's BLAS and XLA's
sum the products in their own orders), two_threshold_score_maps and
two_threshold_scores (bit for bit), select_keypoints (equal, ties and a
budget above the candidates included), gather_patches (centres at and
past every edge) and unpack_bits (equal). On the CPU nothing launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import descriptors as jdesc
from orb_slam2_commit_tpu.ops import extractor as jext
from orb_slam2_commit_tpu.ops import fast as jfast
from orb_slam2_commit_tpu.ops import pyramid as jpyramid
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import descriptors, extractor, fast, pyramid
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

H, W, N_FEAT = 240, 320, 400
N_LEVELS_JAX = 3
XY_TOL = 1e-4
ANGLE_ATOL_GATHER = 1e-5
ANGLE_ATOL_PATCH = 2e-4
RESIZE_ATOL = 1e-3       # on 0-255 pixels


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _random_image(h=H, w=W, seed=42):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def _configs(**changes):
    jc = dataclasses.replace(j_synthetic_config(width=W, height=H, n_features=N_FEAT).orb,
                             **changes)
    tc = dataclasses.replace(synthetic_config(width=W, height=H, n_features=N_FEAT).orb,
                             **changes)
    return jc, tc


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b))))


@pytest.mark.parametrize("patches,refine", [("0", False), ("1", True)])
def test_per_level_route_matches_jax(monkeypatch, patches, refine):
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "0")
    monkeypatch.setenv("ORB_TPU_FORCE_PATCHES", patches)
    img = _random_image()
    jc, tc = _configs(n_levels=N_LEVELS_JAX, subpixel_refine=refine)
    jax.clear_caches()
    with jax.enable_x64(False):
        ref = {k: np.asarray(v) for k, v in
               jext.extract_features_jit(jnp.asarray(img), jc, H, W)._asdict().items()}
    jax.clear_caches()
    got = interop.features_to_numpy(extractor.extract_features(torch.from_numpy(img), tc, H, W))
    v = ref["valid"]
    assert v.sum() > 0.9 * N_FEAT
    for key in ("valid", "octave", "response"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(got["desc"][v], ref["desc"][v])
    if refine:
        np.testing.assert_allclose(got["xy"][v], ref["xy"][v], atol=XY_TOL)
    else:
        np.testing.assert_array_equal(got["xy"], ref["xy"])
    tol = ANGLE_ATOL_PATCH if patches == "1" else ANGLE_ATOL_GATHER
    assert _wrapped(got["angle"], ref["angle"])[v].max() <= tol


def _rendered_frame():
    cam = synthetic_config(width=W, height=H).camera
    return synthetic.render_sequence(cam, n_frames=1, n_points=150, seed=5)[0][0]


@pytest.mark.parametrize("make_image", [_random_image, _rendered_frame])
@pytest.mark.parametrize("patches", ["0", "1"])
def test_per_level_route_matches_packed(monkeypatch, make_image, patches):
    img = torch.from_numpy(make_image())
    _, tc = _configs()
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    ref = interop.features_to_numpy(extractor.extract_features(img, tc, H, W))
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "0")
    monkeypatch.setenv("ORB_TPU_FORCE_PATCHES", patches)
    got = interop.features_to_numpy(extractor.extract_features(img, tc, H, W))
    v = ref["valid"]
    assert v.sum() > 0.5 * N_FEAT
    for key in ("valid", "octave", "response"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(got["desc"][v], ref["desc"][v])
    np.testing.assert_allclose(got["xy"][v], ref["xy"][v], atol=2e-3)
    tol = 1e-6 if patches == "1" else ANGLE_ATOL_PATCH
    assert _wrapped(got["angle"], ref["angle"])[v].max() <= tol


def test_routes_are_read_at_each_call(monkeypatch):
    cpu = torch.zeros(1)
    monkeypatch.delenv("ORB_TPU_FORCE_PACKED", raising=False)
    monkeypatch.delenv("ORB_TPU_FORCE_PATCHES", raising=False)
    assert extractor.use_packed_route() and not descriptors.use_patch_route(cpu)
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "0")
    monkeypatch.setenv("ORB_TPU_FORCE_PATCHES", "1")
    assert not extractor.use_packed_route() and descriptors.use_patch_route(cpu)


@pytest.mark.parametrize("shape,out", [((240, 320), (200, 266)), ((97, 131), (60, 200))])
def test_resize_bilinear_matches_jax(shape, out):
    img = _random_image(*shape, seed=7)
    want = np.asarray(jpyramid.resize_bilinear(jnp.asarray(img), out))
    got = pyramid.resize_bilinear(torch.from_numpy(img), out).numpy()
    assert got.shape == want.shape == out
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)


def test_score_maps_match_jax():
    img = _random_image(120, 150, seed=3)
    want = jfast.two_threshold_score_maps(jnp.asarray(img), 20.0, 7.0)
    got = fast.two_threshold_score_maps(torch.from_numpy(img), 20.0, 7.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        fast.two_threshold_scores(torch.from_numpy(img), 20.0, 7.0, 32).numpy(),
        np.asarray(jfast.two_threshold_scores(jnp.asarray(img), 20.0, 7.0, 32)))


@pytest.mark.parametrize("n_keypoints,levels", [(150, 0), (150, 6), (4000, 0)])
def test_select_keypoints_matches_jax(n_keypoints, levels):
    """A score map from the two-threshold combine; with `levels`, scores
    rounded to that many values so ties are everywhere; 4000 keypoints is
    more than the cells hold (padded, invalid slots parked)."""
    img = _random_image(150, 190, seed=11)
    score = fast.two_threshold_scores(torch.from_numpy(img), 20.0, 7.0, 32)
    if levels:
        score = torch.ceil(score / score.max() * levels)
    got = fast.select_keypoints(score, n_keypoints, 32, 8, 22)
    want = jfast.select_keypoints(jnp.asarray(score.numpy()), n_keypoints, 32, 8, 22)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 50


def test_gather_patches_and_unpack_bits_match_jax():
    from orb_slam2_commit_tpu_torch import interop as ti

    img = _random_image(60, 80, seed=5)
    yx = np.asarray([[0, 0], [59, 79], [30, 40], [-3, 85], [2, 77]], np.int32)
    for half in (4, descriptors.HALF_PATCH_SIZE):
        np.testing.assert_array_equal(
            descriptors.gather_patches(torch.from_numpy(img), torch.from_numpy(yx), half).numpy(),
            np.asarray(jdesc.gather_patches(jnp.asarray(img), jnp.asarray(yx), half)))
    words = np.random.default_rng(9).integers(0, 2 ** 32, (7, 8), dtype=np.uint64)
    words = words.astype(np.uint32)
    got = descriptors.unpack_bits(ti.to_device(words, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdesc.unpack_bits(jnp.asarray(words))))
