"""Port's patch gather (K4) and its fused launch with subpixel refinement
(K4 + K5, `describe_patches`) on the CPU, where the wrappers run their
plain versions, against the Pallas kernels run by their interpreter (lane
padding cut off): windows exact, border keypoints included, offsets within
1e-5 px (the tolerance tests/test_subpix.py uses between the JAX routes).
Also the build's cache key, which must cover the headers a source
includes."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import pallas_patches
from orb_slam2_commit_tpu.ops import subpix as jsubpix
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build, patches

torch.set_num_threads(1)

ATOL = 1e-5      # px, offsets between routes


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _image(kind, h, w, rng):
    """An h x w float32 test image: random, a checkerboard of 9x11 squares
    (corners everywhere), flat, or one vertical and one horizontal step
    edge."""
    if kind == "random":
        return rng.uniform(0, 255, (h, w)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    if kind == "checker":
        return (100.0 * (((ys // 9) + (xs // 11)) % 2) + 20.0).astype(np.float32)
    if kind == "flat":
        return np.full((h, w), 57.0, np.float32)
    if kind == "edge":
        return (60.0 * (xs >= w // 3) + 90.0 * (ys >= 2 * h // 3)).astype(np.float32)
    raise ValueError(kind)


def _pallas_patches(img, yx, patch):
    out = pallas_patches.extract_patches(jnp.asarray(img), jnp.asarray(yx), patch,
                                         interpret=True, k_tile=4)
    return np.asarray(out)[:, :patch, :patch]


@pytest.mark.parametrize("patch", [31, 39, 17])
def test_extract_patches_matches_pallas(patch):
    rng = np.random.default_rng(patch)
    h, w = 96, 140
    img = rng.normal(size=(h, w)).astype(np.float32)
    yx = np.concatenate([
        np.array([[0, 0], [h - 1, w - 1], [3, w - 2], [h - 4, 1],
                  [-5, 7], [h + 3, w + 9]]),      # centres outside clamp
        np.stack([rng.integers(0, h, 10), rng.integers(0, w, 10)], -1),
    ]).astype(np.int32)
    ref = np.asarray(pallas_patches.extract_patches(
        jnp.asarray(img), jnp.asarray(yx), patch, interpret=True, k_tile=4))
    got = patches.extract_patches(torch.from_numpy(img), torch.from_numpy(yx),
                                  patch)
    assert got.shape == (yx.shape[0], patch, patch)
    np.testing.assert_array_equal(got.numpy(), ref[:, :patch, :patch])


def test_extract_patches_checks_inputs():
    img = torch.zeros((16, 16))
    with pytest.raises(TypeError):
        patches.extract_patches(img, torch.zeros((3, 2), dtype=torch.int64), 31)
    with pytest.raises(ValueError):
        patches.extract_patches(img, torch.zeros((3, 2), dtype=torch.int32), 30)


@pytest.mark.parametrize("kind", ["random", "checker", "flat", "edge"])
def test_describe_patches_matches_pallas(kind):
    """Both windows exact against the Pallas gather, the offsets within
    1e-5 px of the Pallas subpixel kernel on the Pallas 31x31 windows; the
    centres lie on, inside and beyond every border of the canvas, and the
    blurred map has pad rows and columns past it, as K1's output has."""
    rng = np.random.default_rng(7)
    h, w = 64, 80
    canvas = _image(kind, h, w, rng)
    blur = _image(kind, h + 16, w + 48, rng)
    if kind == "random":
        blur = rng.normal(size=blur.shape).astype(np.float32)
    yx = np.concatenate([interop.patch_edge_yx(h, w),
                         np.stack([rng.integers(0, h, 8), rng.integers(0, w, 8)], -1)]
                        ).astype(np.int32)
    ic_ref = _pallas_patches(canvas, yx, 31)
    brief_ref = _pallas_patches(blur, yx, 39)
    off_ref = np.asarray(jsubpix.corner_subpix_from_patches_pallas(
        jnp.asarray(ic_ref), 15, 15, interpret=True))
    ic, brief, off = patches.describe_patches(
        torch.from_numpy(canvas), torch.from_numpy(blur), torch.from_numpy(yx), True)
    assert ic.shape == (yx.shape[0], 31, 31) and brief.shape == (yx.shape[0], 39, 39)
    np.testing.assert_array_equal(ic.numpy(), ic_ref)
    np.testing.assert_array_equal(brief.numpy(), brief_ref)
    assert off.shape == (yx.shape[0], 2) and off.dtype == torch.float32
    np.testing.assert_allclose(off.numpy(), off_ref, atol=ATOL, rtol=0)
    if kind == "flat":
        np.testing.assert_array_equal(off.numpy(), 0.0)
    elif kind != "edge":     # a straight edge leaves the 2x2 solve singular
        assert (off.abs() > 0).any()


def test_describe_patches_without_refinement():
    """refine=False: the same windows, no offsets."""
    rng = np.random.default_rng(8)
    canvas = torch.from_numpy(_image("random", 48, 56, rng))
    blur = torch.from_numpy(_image("random", 64, 128, rng))
    yx = torch.from_numpy(interop.patch_edge_yx(48, 56))
    ic, brief, off = patches.describe_patches(canvas, blur, yx, False)
    ic_r, brief_r, off_r = patches.describe_patches(canvas, blur, yx, True)
    assert off is None and off_r is not None
    assert torch.equal(ic, ic_r) and torch.equal(brief, brief_r)
    assert torch.equal(ic, patches.extract_patches(canvas, yx, 31))
    assert torch.equal(brief, patches.extract_patches(blur, yx, 39))


@pytest.mark.parametrize("case", ["dtype", "yx_shape", "image_shapes", "devices"])
def test_describe_patches_checks_inputs(case):
    img = torch.zeros((40, 48))
    yx = torch.zeros((3, 2), dtype=torch.int32)
    args = {
        "dtype": (img, img.double(), yx),
        "yx_shape": (img, img, torch.zeros((3, 3), dtype=torch.int32)),
        "image_shapes": (img, torch.zeros((40, 40)), yx),   # blur_c narrower
        "devices": (img, img, yx.to("meta")),
    }[case]
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        patches.describe_patches(*args, True)
    if case == "devices":
        with pytest.raises(ValueError):
            patches.describe_patches(img, img.to("meta"), yx, True)


def test_library_path_hashes_included_headers(monkeypatch, tmp_path):
    """A library's name hashes the headers its source includes: editing the
    shared subpixel solve rebuilds both libraries that include it, and only
    those."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    header = csrc / "subpix_solve.cuh"
    assert header in _build.source_files("patches")
    assert header in _build.source_files("subpix")
    before = {name: _build._library_path(name) for name in _build.SOURCES}
    header.write_bytes(header.read_bytes() + b"// edited\n")
    changed = {n for n in _build.SOURCES if _build._library_path(n) != before[n]}
    assert changed == {"patches", "subpix"}
