"""Port's ORB extraction (packed canvas, no subpixel refinement) on the CPU
against the JAX package's packed route, forced on and run through its
Pallas interpreter, at 320x240 / 400 features.

Exact: the canvas, valid, octave, xy and response.

Angle, two checks. Against the JAX packed route's output: atol 2e-4 rad.
That route sums the IC moments in float32, the port in float64; the
largest difference measured is 7.9e-5 rad on the random image and
8.6e-6 rad on the rendered frame, where the moments nearly cancel.
Against the JAX package's `ic_angle_from_patches` run in float64 on
patches of the JAX canvas: atol 1e-5 rad.

Descriptor bits: the port's equal, bit for bit, the JAX package's BRIEF
(gather route and patch route) on the XLA blur of the JAX canvas at the
same angles. The JAX packed route itself samples the blur of the Pallas
level kernel run by its interpreter, which rounds differently from plain
float32 (test_pallas_level.py holds it to 1e-3); on rendered frames with
near-equal sample pairs that flips a few bits. So its descriptors are held
to BRIEF on that interpreter blur (exact), and the port's to BRIEF on the
XLA blur at the reference's angles, exact except within 1e-4 rad of an
angle-bin edge (<= 0.5% of keypoints), where the steering bin can flip.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import descriptors as jdesc
from orb_slam2_commit_tpu.ops import extractor as jext
from orb_slam2_commit_tpu.ops import packed_extractor as jpe
from orb_slam2_commit_tpu.ops import pallas_level
from orb_slam2_commit_tpu.ops import pyramid as jpyramid
from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.ops import descriptors, extractor, packed_extractor, pyramid
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

H, W, N_FEAT = 240, 320, 400
ANGLE_ATOL_JAX_ROUTE = 2e-4   # see the module docstring
ANGLE_ATOL_FLOAT64 = 1e-5


def _configs():
    jc = j_synthetic_config(width=W, height=H, n_features=N_FEAT).orb
    tc = synthetic_config(width=W, height=H, n_features=N_FEAT).orb
    return (dataclasses.replace(jc, subpixel_refine=False),
            dataclasses.replace(tc, subpixel_refine=False))


def test_tables_equal_reference():
    np.testing.assert_array_equal(descriptors.brief_pattern(), jdesc.brief_pattern())
    np.testing.assert_array_equal(descriptors.binned_offsets(), jdesc.binned_offsets())
    np.testing.assert_array_equal(descriptors.circular_umax(), jdesc.circular_umax())
    np.testing.assert_array_equal(descriptors._moment_weights()[0], jdesc._moment_weights()[0])
    np.testing.assert_array_equal(descriptors._moment_weights()[1], jdesc._moment_weights()[1])
    np.testing.assert_array_equal(pyramid.gaussian_kernel_1d(), jpyramid.gaussian_kernel_1d())
    shapes = _configs()[1].level_shapes(H, W)
    for a, b in zip(pyramid._direct_resize_mats(shapes),
                    jpyramid._direct_resize_mats(shapes)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pyramid._resize_matrix(480, 400),
                                  jpyramid._resize_matrix(480, 400))


def test_render_sequence_equals_reference():
    cam = synthetic_config(width=W, height=H).camera
    jcam = j_synthetic_config(width=W, height=H).camera
    imgs, poses, scene = synthetic.render_sequence(cam, n_frames=2, n_points=60, seed=5)
    jimgs, jposes, jscene = jsynthetic.render_sequence(jcam, n_frames=2, n_points=60, seed=5)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(scene.points, jscene.points)
    for (R, t), (jR, jt) in zip(poses, jposes):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)


def _random_image():
    return np.random.default_rng(42).uniform(0, 255, (H, W)).astype(np.float32)


def _synthetic_frame():
    cam = synthetic_config(width=W, height=H).camera
    images, _, _ = synthetic.render_sequence(cam, n_frames=1, n_points=150, seed=5)
    return images[0]


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b))))


@pytest.mark.parametrize("make_image", [_random_image, _synthetic_frame])
def test_extract_features_matches_jax_packed(monkeypatch, make_image):
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    img = make_image()
    jc, tc = _configs()
    ref = {k: np.asarray(v) for k, v in
           jext.extract_features_jit(jnp.asarray(img), jc, H, W)._asdict().items()}
    got = interop.features_to_numpy(
        extractor.extract_features(torch.from_numpy(img), tc, H, W))

    for key in ("valid", "octave", "xy"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(got["response"], ref["response"].astype(np.float32))
    v = ref["valid"]
    assert v.sum() > 0.5 * N_FEAT

    # Canvas: the port's equals the JAX package's, bit for bit.
    plan = jpe.make_plan(jc, H, W)
    canvas = jpe.build_canvas(jnp.asarray(img), plan)
    np.testing.assert_array_equal(
        packed_extractor.build_canvas(
            torch.from_numpy(img), packed_extractor.make_plan(tc, H, W)).numpy(),
        np.asarray(canvas))
    scale = np.asarray(jc.scale_factors(), np.float32)[ref["octave"]]
    row_off = np.asarray(plan.row_offsets)[ref["octave"]]
    yx = np.stack([np.rint(ref["xy"][:, 1] / scale) + row_off,
                   np.rint(ref["xy"][:, 0] / scale)], -1).astype(np.int32)

    # Angle: against the JAX route, and against the JAX formula in float64.
    assert _wrapped(got["angle"], ref["angle"])[v].max() <= ANGLE_ATOL_JAX_ROUTE
    d = np.arange(descriptors.PATCH_SIZE) - descriptors.PATCH_SIZE // 2
    c64 = np.asarray(canvas, np.float64)
    P = c64[np.clip(yx[:, 0, None, None] + d[None, :, None], 0, c64.shape[0] - 1),
            np.clip(yx[:, 1, None, None] + d[None, None, :], 0, c64.shape[1] - 1)]
    angle64 = np.asarray(jdesc.ic_angle_from_patches(jnp.asarray(P)))
    assert angle64.dtype == np.float64
    assert _wrapped(got["angle"], angle64)[v].max() <= ANGLE_ATOL_FLOAT64

    # Descriptors.
    xla_blur = jpyramid.gaussian_blur(canvas)
    interp_blur = pallas_level.level_preprocess(canvas, 20.0, 7.0, interpret=True)[0]
    yx_j = jnp.asarray(yx)

    def brief(blur, angle, patch_route=False):
        fn = jdesc.brief_descriptors_patches if patch_route else jdesc.brief_descriptors
        return np.asarray(fn(blur, yx_j, jnp.asarray(angle)))[v]

    np.testing.assert_array_equal(got["desc"][v], brief(xla_blur, got["angle"]))
    np.testing.assert_array_equal(got["desc"][v], brief(xla_blur, got["angle"], True))
    np.testing.assert_array_equal(ref["desc"][v], brief(interp_blur, ref["angle"]))
    width = 2.0 * np.pi / descriptors.N_ANGLE_BINS
    pos = (ref["angle"][v].astype(np.float64) + np.pi) / width
    near_edge = np.abs(pos - np.round(pos)) * width < 1e-4
    differ = np.any(got["desc"][v] != brief(xla_blur, ref["angle"]), axis=1)
    assert not np.any(differ & ~near_edge)
    assert differ.sum() <= 0.005 * v.sum()


@pytest.mark.parametrize("size,changes,min_valid", [
    ((240, 320), dict(cell_size=30), 100),        # unfused combine route
    # A canvas below 128 rows: every level is too small to hold the
    # detection border, so no keypoint is valid (the parked layout is
    # still compared).
    ((32, 128), dict(n_levels=2, n_features=40), 0),
])
def test_other_combine_routes_match_jax_packed(monkeypatch, size, changes, min_valid):
    """The routes the packed extractor takes besides the fused combine
    kernel, under the same route condition as the JAX package."""
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    h, w = size
    img = np.random.default_rng(h + w).uniform(0, 255, (h, w)).astype(np.float32)
    jc = dataclasses.replace(j_synthetic_config(width=w, height=h).orb,
                             subpixel_refine=False, **changes)
    tc = dataclasses.replace(synthetic_config(width=w, height=h).orb,
                             subpixel_refine=False, **changes)
    ref = {k: np.asarray(v) for k, v in
           jext.extract_features_jit(jnp.asarray(img), jc, h, w)._asdict().items()}
    got = interop.features_to_numpy(
        extractor.extract_features(torch.from_numpy(img), tc, h, w))
    assert ref["valid"].sum() >= min_valid
    for key in ("valid", "octave", "xy"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(got["response"], ref["response"].astype(np.float32))


def test_subpixel_refinement_not_ported_yet():
    """Refinement, once refused by the port, runs with the default
    configuration and moves each keypoint by at most 1 px of its level
    (tests/test_torch_subpix.py holds it against the JAX package)."""
    tc = synthetic_config(width=W, height=H, n_features=N_FEAT).orb
    assert tc.subpixel_refine
    img = torch.from_numpy(_random_image())
    got = extractor.extract_features(img, tc, H, W)
    plain = extractor.extract_features(
        img, dataclasses.replace(tc, subpixel_refine=False), H, W)
    scale = torch.tensor(tc.scale_factors())[got.octave.long()][:, None]
    moved = (got.xy - plain.xy).abs()
    assert bool((moved <= scale + 1e-4).all()) and bool((moved > 0).any())


def test_pyramid_products_ignore_a_tf32_setting(monkeypatch):
    """A caller that allows TF32 still gets full float32 pyramid products,
    and keeps its own setting after the call."""
    seen = []
    matmul = torch.matmul

    def spy(*args):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*args)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        shapes = _configs()[1].level_shapes(H, W)
        pyramid.direct_pyramid_stack(torch.from_numpy(_random_image()), shapes)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest", "highest"]
