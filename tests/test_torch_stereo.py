"""The port's stereo front end on the CPU against the JAX package, at
320x240 / 400 features on frame 0 of render_stereo_sequence (seed 5):

- the renderers (stereo pairs, depth maps) equal the JAX package's bit for
  bit;
- build_pyramid / pyramid_stack equal the JAX package's in float32, bit
  for bit;
- stereo_match on identical inputs (the JAX stereo front end's features
  and pyramid stacks): the match indices and the mutual check equal
  (K7's plain version against the dense route), valid flags equal,
  u_right within U_RIGHT_TOL wherever both are valid, and on each side
  depth = bf / (x_l - u_right) to 1e-5 relative;
- stereo_frontend end to end, from the images.

U_RIGHT_TOL: the SAD of each 11x11 window is a sum of 121 float32 terms,
which XLA sums in float32 in its own order and the port in float64 (then
rounded once), so the SADs differ by a few float32 ulps and the parabola
offset with them. Measured: 7.6e-6 px at most, on both comparisons; no
valid flag flipped.

The JAX front end runs its packed extraction route (the port's route) in
32-bit mode; its Pallas level kernel runs in the interpreter, whose blur
rounds a few values differently from plain float32 (ROADMAP.md section
3), so end to end at most 1% of descriptors may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.ops import pyramid as jpyramid
from orb_slam2_commit_tpu.ops import stereo as jstereo
from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.kernels import matching as kmatching
from orb_slam2_commit_tpu_torch.ops import pyramid, stereo
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT = 320, 240, 400
U_RIGHT_TOL = 1e-3      # px, see the module docstring
DEPTH_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _configs():
    return (synthetic_config(W, H, N_FEAT, sensor="stereo"),
            j_synthetic_config(W, H, N_FEAT, sensor="stereo"))


def _np(named):
    return {k: np.asarray(v) for k, v in named._asdict().items()}


def _t(a):
    a = np.array(a, order="C")     # a writable copy: JAX's arrays are read-only
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def reference():
    """Frame 0 of the stereo sequence, and the JAX stereo front end on it:
    (left, right, JAX left features, right features, stacks, match)."""
    config, jconfig = _configs()
    lefts, rights, _, _ = synthetic.render_stereo_sequence(
        config.camera, n_frames=1, n_points=300, seed=5, step=0.05)
    cam = jconfig.camera
    shapes = jconfig.orb.level_shapes(H, W)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setenv("ORB_TPU_FORCE_PACKED", "1")
        fl, fr, m = jstereo.stereo_frontend_jit(
            jnp.asarray(lefts[0]), jnp.asarray(rights[0]), orb_config=jconfig.orb,
            height=H, width=W, bf=cam.bf, baseline=cam.baseline)
        stacks = [np.asarray(jstereo.pyramid_stack(jpyramid.build_pyramid(
            jnp.asarray(im), shapes))) for im in (lefts[0], rights[0])]
    return lefts[0], rights[0], _np(fl), _np(fr), stacks, _np(m)


def test_render_stereo_sequence_equals_jax():
    config, jconfig = _configs()
    got = synthetic.render_stereo_sequence(config.camera, n_frames=2, n_points=80, seed=5)
    ref = jsynthetic.render_stereo_sequence(jconfig.camera, n_frames=2, n_points=80, seed=5)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert not np.array_equal(got[0], got[1])
    for (R, t), (jR, jt) in zip(got[2], ref[2]):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(got[3].points, ref[3].points)


def test_render_sequence_with_depth_equals_jax():
    config, jconfig = _configs()
    imgs, poses, scene, depths = synthetic.render_sequence(
        config.camera, n_frames=2, n_points=80, seed=5, with_depth=True)
    jimgs, _, _, jdepths = jsynthetic.render_sequence(
        jconfig.camera, n_frames=2, n_points=80, seed=5, with_depth=True)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(depths, jdepths)
    assert depths.dtype == np.float32 and 0.05 < (depths > 0).mean() < 0.9
    # The image drawn without depth is the same.
    np.testing.assert_array_equal(
        synthetic.render(scene, *poses[1], config.camera), imgs[1])


@pytest.mark.parametrize("image", ["random", "rendered"])
def test_build_pyramid_and_stack_equal_jax(reference, image):
    img = (np.random.default_rng(3).uniform(0, 255, (H, W)).astype(np.float32)
           if image == "random" else reference[0])
    shapes = _configs()[0].orb.level_shapes(H, W)
    with jax.enable_x64(False):
        ref = [np.asarray(lv) for lv in jpyramid.build_pyramid(jnp.asarray(img), shapes)]
        ref_stack = np.asarray(jstereo.pyramid_stack(tuple(jnp.asarray(lv) for lv in ref)))
    got = pyramid.build_pyramid(torch.from_numpy(img), shapes)
    assert len(got) == len(ref)
    for g, r, shape in zip(got, ref, shapes):
        assert tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), r)
    np.testing.assert_array_equal(stereo.pyramid_stack(got).numpy(), ref_stack)
    if image == "rendered":
        np.testing.assert_array_equal(ref_stack, reference[4][0])


def test_constants_equal_jax():
    assert (stereo.SAD_HALF, stereo.SLIDE, int(stereo.TH_ORB)) == (
        jstereo.SAD_HALF, jstereo.SLIDE, int(jstereo.TH_ORB)) == (5, 5, 75)


def _check_match(got, ref, xy_l, bf):
    """The acceptance of a stereo match against the JAX package's."""
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = ref["valid"]
    assert v.sum() > 0.3 * N_FEAT
    assert np.abs(got["u_right"] - ref["u_right"])[v].max() <= U_RIGHT_TOL
    for m in (got, ref):
        assert (m["u_right"][~v] == -1).all() and (m["depth"][~v] == -1).all()
        np.testing.assert_allclose(
            m["depth"][v], bf / (xy_l[v, 0] - m["u_right"][v]), rtol=DEPTH_RTOL, atol=0)


def test_stereo_match_equals_jax(reference, monkeypatch):
    _, _, fl, fr, (stack_l, stack_r), ref = reference
    config, jconfig = _configs()
    cam = config.camera
    calls = []
    top2 = kmatching.masked_hamming_top2

    def spy(*args):
        calls.append([a.numpy() for a in args])
        return top2(*args)

    monkeypatch.setattr(kmatching, "masked_hamming_top2", spy)
    sf = torch.tensor(np.asarray(jconfig.orb.scale_factors(), np.float32))
    got = stereo.stereo_match(
        _t(fl["xy"]), _t(fl["octave"]), _t(fl["desc"]), _t(fl["valid"]),
        _t(fr["xy"]), _t(fr["octave"]), _t(fr["desc"]), _t(fr["valid"]),
        _t(stack_l), _t(stack_r), cam.bf, cam.baseline, sf)
    _check_match(_np(got), ref, fl["xy"], cam.bf)

    # K7 ran twice: left -> right, then right -> left on the transposed
    # mask. Its results equal the dense route's: the left -> right match
    # (best_match_with_ratio) and jnp.argmin over axis 0, which gives 0
    # for a right keypoint with no candidate.
    assert len(calls) == 2
    (dl, dr, mask), (dr2, dl2, mask_t) = calls
    np.testing.assert_array_equal(mask_t, mask.T)
    assert (dr2 == dr).all() and (dl2 == dl).all()
    empty_cols = ~mask.any(axis=0)
    assert 0 < empty_cols.sum() < mask.shape[1]
    with jax.enable_x64(False):
        dist = jmatching.hamming_distance_matrix(jnp.asarray(fl["desc"]), jnp.asarray(fr["desc"]))
        ref_m = jmatching.best_match_with_ratio(dist, jnp.asarray(mask), int(jstereo.TH_ORB))
        ref_col = np.asarray(jnp.argmin(jnp.where(jnp.asarray(mask), dist, 1 << 20), axis=0))
    best, bidx, second, sidx = top2(_t(dl), _t(dr), _t(mask))
    m = stereo.matching.match_from_top2(best, bidx, second, sidx, int(stereo.TH_ORB))
    np.testing.assert_array_equal(m.idx.numpy(), np.asarray(ref_m.idx))
    col = top2(_t(dr), _t(dl), _t(mask_t))[1].numpy()
    np.testing.assert_array_equal(col, ref_col)
    assert (col[empty_cols] == 0).all()


def test_stereo_frontend_matches_jax(reference):
    left, right, fl, fr, _, ref = reference
    config, _ = _configs()
    cam = config.camera
    got_l, got_r, got = stereo.stereo_frontend(
        torch.from_numpy(left), torch.from_numpy(right), config.orb, H, W,
        cam.bf, cam.baseline)
    for feats, want in ((got_l, fl), (got_r, fr)):
        g = interop.features_to_numpy(feats)
        for key in ("valid", "octave"):
            np.testing.assert_array_equal(g[key], want[key])
        np.testing.assert_allclose(g["xy"], want["xy"], atol=1e-4, rtol=0)
        assert np.any(g["desc"] != want["desc"], axis=1).mean() <= 0.01
    _check_match(_np(got), ref, fl["xy"], cam.bf)
