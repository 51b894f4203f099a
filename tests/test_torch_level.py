"""Port's level kernels (K1 blur+FAST, K2 combine+NMS) on the CPU, where
the wrappers run their plain versions, against the JAX package.

K1 is held against the Pallas kernel run by its interpreter and against
the XLA blur and FAST maps, with the tolerances of test_pallas_level.py
(the interpreter under jax_enable_x64 contracts and reorders float32
arithmetic, so it is not bit-exact even against its own XLA route; the
port's plain blur equals the XLA blur bit for bit). K2 is exact. The
kernel reads the unpadded canvas through two index tables; gathered on
the CPU, they give pad_level's padded canvas exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import fast as jfast
from orb_slam2_commit_tpu.ops import pallas_level, pyramid as jpyramid
from orb_slam2_commit_tpu_torch.kernels import _build, level
from orb_slam2_commit_tpu_torch.ops import fast, pyramid
from orb_slam2_commit_tpu_torch.ops import packed_extractor as pe
from orb_slam2_commit_tpu_torch.utils.config import ORBConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(96, 130), (70, 100), (128, 128)])
def test_level_preprocess_matches_pallas(hw):
    h, w = hw
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    jb, jhi, jlo = (np.asarray(a) for a in pallas_level.level_preprocess(
        jnp.asarray(img), 20.0, 7.0, interpret=True, full_canvas=True))
    before = dict(_build.launches)
    tb, thi, tlo = (a.numpy() for a in level.level_preprocess(
        torch.from_numpy(img), 20.0, 7.0))
    assert _build.launches == before   # the CPU takes the plain version
    assert tb.shape == jb.shape == (-(-h // 64) * 64, -(-w // 128) * 128)
    np.testing.assert_allclose(tb, jb, atol=1e-3)
    for got, ref in ((thi, jhi), (tlo, jlo)):
        np.testing.assert_allclose(got, ref, atol=1e-2)
        np.testing.assert_array_equal(got > 0, ref > 0)


@pytest.mark.parametrize("hw", [(96, 130), (64, 129)])
def test_level_preprocess_matches_xla(hw):
    h, w = hw
    rng = np.random.default_rng(h + w)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    tb, thi, tlo = (a.numpy()[:h, :w] for a in level.level_preprocess(
        torch.from_numpy(img), 20.0, 7.0))
    # The port's blur is the XLA blur's arithmetic in the same order.
    np.testing.assert_array_equal(
        tb, np.asarray(jpyramid.gaussian_blur(jnp.asarray(img))))
    np.testing.assert_array_equal(
        tb, pyramid.gaussian_blur(torch.from_numpy(img)).numpy())
    for got, th in ((thi, 20.0), (tlo, 7.0)):
        corner, score = (np.asarray(a) for a in jfast.fast_score_map(
            jnp.asarray(img), th))
        np.testing.assert_allclose(got, score, atol=1e-2)
        np.testing.assert_array_equal(got > 0, corner & (score > 0))
        t_corner, t_score = fast.fast_score_map(torch.from_numpy(img), th)
        np.testing.assert_array_equal(got, t_score.numpy())
        np.testing.assert_array_equal(t_corner.numpy(), corner)


def _canvas(shape):
    """A random image of shape (h, w), or the packed 640x480 canvas."""
    rng = np.random.default_rng(7)
    if shape == "packed 640x480":
        image = torch.from_numpy(rng.uniform(0, 255, (480, 640)).astype(np.float32))
        return pe.build_canvas(image, pe.make_plan(ORBConfig(), 480, 640))
    return torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(96, 130), (70, 100), (64, 129), (240, 320),
                                   "packed 640x480"])
def test_pad_tables_gather_pad_level(shape):
    """K1's row and column tables, used as a gather on the unpadded canvas,
    give pad_level's output bit for bit (the kernel reads the first
    hp + 6 rows and wp + 6 columns of them)."""
    canvas = _canvas(shape)
    h, w = canvas.shape
    padded, hp, wp = level.pad_level(canvas)
    rows = torch.from_numpy(level.pad_index(h, padded.shape[0])).long()
    cols = torch.from_numpy(level.pad_index(w, padded.shape[1])).long()
    assert padded.shape[0] >= hp + 6 and padded.shape[1] >= wp + 6
    assert torch.equal(canvas[rows][:, cols], padded)


def _score_maps(rng, hp, wp):
    # FAST-like sparse non-negative maps; small integer values make ties.
    s = rng.integers(0, 6, (hp, wp)).astype(np.float32)
    return s * (rng.random((hp, wp)) < 0.08)


@pytest.mark.parametrize("hw", [(128, 128), (256, 384), (192, 256)])
def test_combine_nms_matches_pallas(hw):
    hp, wp = hw
    rng = np.random.default_rng(hp + wp)
    hi, lo = _score_maps(rng, hp, wp), _score_maps(rng, hp, wp)
    bounds = np.zeros((hp, 128), np.int32)
    bounds[20: hp // 2 - 20] = (19, wp - 23) + (0,) * 126
    bounds[hp // 2 + 20: hp - 20] = (19, wp // 2) + (0,) * 126
    ref = np.asarray(pallas_level.combine_nms(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bounds), interpret=True))
    got = level.combine_nms(torch.from_numpy(hi), torch.from_numpy(lo),
                            torch.from_numpy(bounds)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_combine_nms_all_low_cells():
    hp, wp = 128, 256
    rng = np.random.default_rng(4)
    lo = _score_maps(rng, hp, wp)
    hi = np.zeros((hp, wp), np.float32)
    bounds = np.zeros((hp, 128), np.int32)
    bounds[19: hp - 19, 0] = 19
    bounds[19: hp - 19, 1] = wp - 19
    ref = np.asarray(pallas_level.combine_nms(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bounds), interpret=True))
    got = level.combine_nms(torch.from_numpy(hi), torch.from_numpy(lo),
                            torch.from_numpy(bounds)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrappers_check_inputs():
    with pytest.raises(TypeError):
        level.level_preprocess(torch.zeros((8, 8), dtype=torch.float64), 20.0, 7.0)
    with pytest.raises(ValueError):
        level.combine_nms(torch.zeros((100, 128)), torch.zeros((100, 128)),
                          torch.zeros((100, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        level.level_preprocess(torch.zeros((64, 128)).t(), 20.0, 7.0)
    with pytest.raises(ValueError):   # neither a card nor the CPU
        level.level_preprocess(torch.zeros((64, 128), device="meta"), 20.0, 7.0)
    with pytest.raises(ValueError):   # neither a card nor the CPU
        level.combine_nms(*(torch.zeros((64, 128), device="meta") for _ in range(2)),
                          torch.zeros((64, 2), dtype=torch.int32, device="meta"))
    # K2 (and K6) load 16 bytes at a time: a view that starts off that
    # boundary is copied before the launch, an aligned one is passed as is.
    flat = torch.arange(64 * 128 + 1, dtype=torch.float32)
    view = flat[1:].view(64, 128)
    copy = _build.aligned(view)
    assert view.data_ptr() % 16 and copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    assert _build.aligned(flat) is flat
