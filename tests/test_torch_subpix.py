"""Port's subpixel refinement (K5's plain version, and the packed extraction
with refinement on) on the CPU against the JAX package: offsets within
1e-5 px of offsets_from_windows and of the Pallas kernel in interpret
mode (the tolerance tests/test_subpix.py uses between the JAX routes);
the fused launch's offsets (`describe_patches`) within 1e-5 px of the JAX
image route; extraction's integer outputs exact and its coordinates within
1e-4 px of the JAX packed route, the extraction refining through one
fused call."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import extractor as jext
from orb_slam2_commit_tpu.ops import subpix as jsubpix
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.kernels import patches as kpatches
from orb_slam2_commit_tpu_torch.kernels import subpix as ksubpix
from orb_slam2_commit_tpu_torch.ops import extractor, subpix
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


ATOL = 1e-5          # px, between offset routes
XY_ATOL = 1e-4       # px, level-0 coordinates after refinement
P, C = 31, 15        # K4's IC-angle patch and its centre


def _checker_aa(h, w, cy, cx, amp=100.0):
    """Antialiased checkerboard corner at subpixel (cy, cx), as in
    tests/test_subpix.py."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = 2 * np.clip(xs + 0.5 - cx, 0, 1) - 1
    sy = 2 * np.clip(ys + 0.5 - cy, 0, 1) - 1
    return (amp * sx * sy + amp).astype(np.float32)


def _patches(kind):
    """[K, 31, 31] float32 patches with the keypoint at (15, 15)."""
    rng = np.random.default_rng(3)
    if kind == "random":
        return rng.uniform(0, 255, (64, P, P)).astype(np.float32)
    if kind == "checker":
        out = []
        for fy, fx in [(0.0, 0.0), (0.3, -0.2), (-0.45, 0.4), (0.15, 0.35)]:
            img = _checker_aa(48, 64, 20.0 + fy, 30.0 + fx)
            out.append(img[20 - C:20 + C + 1, 30 - C:30 + C + 1])
        return np.stack(out)
    if kind == "flat":
        return np.full((4, P, P), 57.0, np.float32)
    if kind == "edge":
        p = np.zeros((4, P, P), np.float32)
        p[:, :, C:] = 100.0
        p[2:] = np.transpose(p[2:], (0, 2, 1))        # horizontal edges too
        return p
    if kind == "clamped":
        # A corner far off the window centre pulls the solve past +-1 px.
        out = []
        for dy, dx in [(2.6, 2.2), (-2.4, 1.7), (2.9, -2.8)]:
            img = _checker_aa(48, 64, 20.0 + dy, 30.0 + dx)
            out.append(img[20 - C:20 + C + 1, 30 - C:30 + C + 1])
        return np.stack(out)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "checker", "flat", "edge", "clamped"])
def test_offsets_match_jax_routes(kind):
    pat = _patches(kind)
    got = ksubpix.corner_subpix_from_patches(torch.from_numpy(pat), C, C).numpy()
    r = subpix.HALF + 1
    win = pat[:, C - r:C + r + 1, C - r:C + r + 1]
    want = np.asarray(jsubpix.offsets_from_windows(jnp.asarray(win)))
    pallas = np.asarray(jsubpix.corner_subpix_from_patches_pallas(
        jnp.asarray(pat), C, C, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    assert got.dtype == np.float32 and np.all(np.abs(got) <= 1.0)
    if kind == "flat":
        np.testing.assert_array_equal(got, 0.0)
    if kind == "clamped":
        assert np.all(np.abs(got).max(axis=1) == 1.0)
    if kind == "checker":
        frac = np.array([(0.0, 0.0), (0.3, -0.2), (-0.45, 0.4), (0.15, 0.35)])
        np.testing.assert_allclose(got, frac, atol=0.08)


def test_corner_subpix_offsets_from_image():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    yx = rng.integers(0, 96, (40, 2)).astype(np.int32)      # edges included
    yx[:, 1] = rng.integers(0, 128, 40)
    want = np.asarray(jsubpix.corner_subpix_offsets(jnp.asarray(img), jnp.asarray(yx)))
    got = subpix.corner_subpix_offsets(torch.from_numpy(img), torch.from_numpy(yx))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        ksubpix.corner_subpix_from_patches(torch.zeros((2, P, P), dtype=torch.float64), C, C)
    with pytest.raises(ValueError):
        ksubpix.corner_subpix_from_patches(torch.zeros((2, P, P)), 2, C)


@pytest.mark.parametrize("source", ["random", "rendered"])
def test_extraction_with_refinement_matches_jax_packed(monkeypatch, source):
    h, w, n = 240, 320, 400
    if source == "random":
        img = np.random.default_rng(42).uniform(0, 255, (h, w)).astype(np.float32)
    else:
        cam = synthetic_config(width=w, height=h).camera
        img = synthetic.render_sequence(cam, n_frames=1, n_points=150, seed=5)[0][0]
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    jc = j_synthetic_config(width=w, height=h, n_features=n).orb
    tc = synthetic_config(width=w, height=h, n_features=n).orb
    assert jc.subpixel_refine and tc.subpixel_refine
    with jax.enable_x64(False):
        ref = {k: np.asarray(v) for k, v in
               jext.extract_features_jit(jnp.asarray(img), jc, h, w)._asdict().items()}
    got = interop.features_to_numpy(
        extractor.extract_features(torch.from_numpy(img), tc, h, w))
    plain = interop.features_to_numpy(extractor.extract_features(
        torch.from_numpy(img), dataclasses.replace(tc, subpixel_refine=False), h, w))

    for key in ("valid", "octave"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(got["response"], ref["response"].astype(np.float32))
    np.testing.assert_allclose(got["xy"], ref["xy"], atol=XY_ATOL, rtol=0)
    # Refinement moves coordinates by at most 1 px of the keypoint's level
    # and leaves angle and descriptor where they were.
    v = got["valid"]
    scale = np.asarray(tc.scale_factors(), np.float32)[got["octave"]][:, None]
    moved = np.abs(got["xy"] - plain["xy"])
    assert np.all(moved <= scale * 1.0 + 1e-4) and (moved[v] > 0).mean() > 0.5
    np.testing.assert_array_equal(got["desc"], plain["desc"])
    np.testing.assert_array_equal(got["angle"], plain["angle"])


@pytest.mark.parametrize("kind", ["random", "checker", "flat", "edge"])
def test_describe_patches_offsets_match_jax_image_route(kind):
    """The fused launch's offsets, read from the 9x9 centre of each 31x31
    window, against the JAX package's image route (its own 9x9 gather), on
    centres inside the image up to its edges, where both clamp alike."""
    rng = np.random.default_rng(9)
    h, w = 72, 96
    if kind == "random":
        img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    elif kind == "checker":
        img = _checker_aa(h, w, 36.3, 47.6)
    elif kind == "flat":
        img = np.full((h, w), 57.0, np.float32)
    else:
        img = _checker_aa(h, w, 36.3, -10.0)       # one straight edge
    yx = interop.patch_edge_yx(h, w)
    inside = (yx >= 0).all(1) & (yx[:, 0] < h) & (yx[:, 1] < w)
    yx = np.concatenate([yx[inside], [[36, 47], [37, 48]],
                         np.stack([rng.integers(0, h, 12), rng.integers(0, w, 12)], -1)]
                        ).astype(np.int32)
    want = np.asarray(jsubpix.corner_subpix_offsets(jnp.asarray(img), jnp.asarray(yx)))
    t = torch.from_numpy(img)
    _, _, got = kpatches.describe_patches(t, t, torch.from_numpy(yx), True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if kind == "flat":
        np.testing.assert_array_equal(got.numpy(), 0.0)
    if kind == "checker":      # the corner at (36.3, 47.6), seen from 2 pixels
        np.testing.assert_allclose(got.numpy()[-14:-12] + yx[-14:-12], [(36.3, 47.6)] * 2,
                                   atol=0.1)


@pytest.mark.parametrize("refine", [True, False])
def test_extraction_describes_in_one_fused_call(monkeypatch, refine):
    """Packed extraction gathers both windows and refines through one
    describe_patches call, and never through the standalone K4 or K5."""
    calls = []
    fused = kpatches.describe_patches

    def spy(*args):
        calls.append(args[3])
        return fused(*args)

    def refused(*args):
        raise AssertionError("a standalone kernel wrapper was called")

    monkeypatch.setattr(kpatches, "describe_patches", spy)
    monkeypatch.setattr(kpatches, "extract_patches", refused)
    monkeypatch.setattr(ksubpix, "corner_subpix_from_patches", refused)
    cfg = dataclasses.replace(synthetic_config(width=320, height=240, n_features=200).orb,
                              n_levels=3, subpixel_refine=refine)
    img = np.random.default_rng(4).uniform(0, 255, (240, 320)).astype(np.float32)
    extractor.extract_features(torch.from_numpy(img), cfg, 240, 320)
    assert calls == [refine]
