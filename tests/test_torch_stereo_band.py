"""K7 on the stereo band (kernels/matching.stereo_band_top2) on the CPU,
where it runs its plain route, against the JAX package: the candidate mask
as the JAX stereo matcher builds it (orb_slam2_commit_tpu/ops/stereo.py,
stereo_match, built here from the same numpy inputs) and the Pallas kernel
`masked_hamming_top2` in interpret mode, left -> right on the mask and
right -> left on its transpose. All four outputs of both directions are
equal on every case of interop.BAND_CASES, one of which sits on each edge
of the band: the float32 value of max_d and its neighbours, the -2 px
disparity edge, |dy| equal to 2 scale_l, octaves at +-1 and +-2, invalid
rows and columns, and rows with no candidate and with one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import matching as jmatching
from orb_slam2_commit_tpu.ops import pallas_matching as jpm
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.kernels import matching as kmatching

torch.set_num_threads(1)

BIG = kmatching.BIG_DIST


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def _jax_mask(xy_l, octave_l, valid_l, xy_r, octave_r, valid_r, scale_factors, max_d):
    """The JAX stereo matcher's candidate mask (its stereo_match, with
    min_d = 0), on jnp arrays."""
    row_band = jnp.abs(xy_l[:, 1:2] - xy_r[None, :, 1]) <= (
        2.0 * scale_factors[jnp.clip(octave_l, 0, scale_factors.shape[0] - 1)][:, None]
    )
    octave_band = jmatching.octave_band_mask(octave_r, octave_l - 1, octave_l + 1)
    disp = xy_l[:, 0:1] - xy_r[None, :, 0]
    disp_ok = (disp >= 0.0 - 2.0) & (disp <= max_d)
    return valid_l[:, None] & valid_r[None, :] & row_band & octave_band & disp_ok


@pytest.fixture(scope="module")
def reference():
    """Each case's problem, the JAX mask, and the Pallas kernel's outputs
    on the mask and on its transpose."""
    out = {}
    with jax.enable_x64(False):
        for name, kw in interop.BAND_CASES.items():
            p = interop.band_problem(**kw)
            dl, xy_l, ol, vl, dr, xy_r, orr, vr = (jnp.asarray(a) for a in p)
            mask = _jax_mask(xy_l, ol, vl, xy_r, orr, vr, jnp.asarray(interop.BAND_SCALES),
                             interop.BAND_MAX_D)
            lr = jpm.masked_hamming_top2(dl, dr, mask, interpret=True)
            rl = jpm.masked_hamming_top2(dr, dl, mask.T, interpret=True)
            out[name] = (p, np.asarray(mask), [np.asarray(a) for a in lr],
                         [np.asarray(a) for a in rl])
    return out


def _port_args(p):
    """band_problem's arrays -> stereo_band_top2's tensors (scale_l from
    the left octaves)."""
    dl, xy_l, ol, vl, dr, xy_r, orr, vr = (interop.to_device(a, "cpu") for a in p)
    scale_l = torch.from_numpy(interop.BAND_SCALES)[torch.clamp(ol, 0, 7).long()]
    return dl, xy_l, ol, scale_l, vl, dr, xy_r, orr, vr


@pytest.mark.parametrize("case", sorted(interop.BAND_CASES))
def test_band_mask_equals_jax(reference, case):
    p, mask, _, _ = reference[case]
    dl, xy_l, ol, scale_l, vl, dr, xy_r, orr, vr = _port_args(p)
    got = kmatching.stereo_band_mask(xy_l, ol, scale_l, vl, xy_r, orr, vr,
                                     interop.BAND_MAX_D)
    np.testing.assert_array_equal(got.numpy(), mask)
    assert not mask.all() and (mask.any() or mask.shape[1] == 1)


@pytest.mark.parametrize("case", sorted(interop.BAND_CASES))
def test_band_top2_equals_pallas(reference, case):
    p, _, lr, rl = reference[case]
    got_lr, got_rl = kmatching.stereo_band_top2(*_port_args(p), interop.BAND_MAX_D)
    for got, want in ((got_lr, lr), (got_rl, rl)):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)


def test_band_edges(reference):
    """The edges case decides each edge as the JAX mask does, and the
    fallback indices where a row has no candidate or one."""
    _, mask, lr, rl = reference["edges"]
    want = {(0, 0): True, (0, 1): False, (0, 2): True,      # d = f32(max_d), up, down
            (1, 3): True, (1, 4): False, (1, 5): True,      # d = -2, below, above
            (2, 6): True, (2, 7): True, (2, 8): False,      # |dy| = 2 s, below, above
            (3, 9): False, (3, 10): True, (3, 11): True, (3, 12): False,  # octave 1, 2, 4, 5
            (4, 13): False, (6, 14): True, (6, 15): False, (7, 14): True}
    for (r, c), v in want.items():
        assert mask[r, c] == v, (r, c)
    assert mask[0].sum() == 2 and not mask[4].any() and not mask[5].any()
    assert mask[6].sum() == 1 and mask[7].sum() == 1
    best, bidx, second, sidx = lr
    for row in (4, 5):   # no candidate: BIG twice, best index 0, second 1
        assert (best[row], bidx[row], second[row], sidx[row]) == (BIG, 0, BIG, 1)
    for row in (6, 7):   # one candidate: the second index is the lowest other column
        assert bidx[row] == 14 and (second[row], sidx[row]) == (BIG, 0)
    best, bidx, second, sidx = rl
    for col in (13, 15):  # the right rows with no candidate
        assert (best[col], bidx[col], second[col], sidx[col]) == (BIG, 0, BIG, 1)
    # Rows 6 and 7 share a descriptor: a tie, to the lower row.
    assert (bidx[14], sidx[14]) == (6, 7) and best[14] == second[14] < BIG


def test_max_d_is_compared_in_float32():
    """PyTorch compares a float32 disparity with the Python float max_d in
    float32 (max_d rounded to nearest), as the JAX package does; the
    kernel is handed that float32 value."""
    md = interop.BAND_MAX_D
    f = np.float32(md)
    assert float(f) > md
    d = torch.tensor([f, np.nextafter(f, np.float32(np.inf))])
    assert (d <= md).tolist() == [True, False]
    with jax.enable_x64(False):
        assert np.asarray(jnp.asarray(d.numpy()) <= md).tolist() == [True, False]


def test_wrapper_checks_its_inputs():
    args = list(_port_args(interop.band_problem(**interop.BAND_CASES["edges"])))
    for i, bad in ((0, args[0][:, :7].contiguous()), (2, args[2][:-1]),
                   (3, args[3].to(torch.float64)), (6, args[6].t()),
                   (8, args[8].to(torch.int32)), (5, args[5][:0])):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises((TypeError, ValueError)):
            kmatching.stereo_band_top2(*wrong, interop.BAND_MAX_D)
