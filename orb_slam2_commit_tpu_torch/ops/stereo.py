"""Stereo keypoint matching with SAD subpixel refinement (PyTorch port of
ops/stereo.py; the reference's Frame::ComputeStereoMatches,
src/Frame.cc:547-788).

The candidate pairs are a band of the [N_l, N_r] keypoint pairs (epipolar
row band + octave band + disparity window + validity), and the Hamming
top-2 under it comes from K7 (kernels/matching.stereo_band_top2): left ->
right for each left keypoint's best match, right -> left for the mutual
check, in one launch that tests the band itself, so on the card neither
the [N_l, N_r] mask nor the distance matrix exists. Then an 11x11 SAD
scan over +-5 px with a parabola fit on the matched pairs, and the
median-based outlier cut (:770-787).

Level-dependent image access uses a padded pyramid stack [L, H0, W0], so
an octave held in a tensor can index it.

SAD sums: each window's 121 absolute differences (float32) are summed in
float64 and rounded once to float32. The float64 sum is far inside half a
float32 ulp of the exact sum whatever the order of its terms, so the card
and the CPU give the same float32 sums. The JAX package sums in float32 in
XLA's order, a few ulps away; tests/test_torch_stereo.py states what that
does to u_right.

`stereo_frontend_jit` is the single-dispatch form (the JAX package's
jitted namesake, the same arguments): on CUDA tensors one replay of a
CUDA graph (utils/cuda_graph.py; K1-K5 for both images and K7 on the
band), on CPU tensors the same function run eagerly. The staged stereo
frame (slam/frame.make_stereo_frame) calls it; the fused tracker's graph
calls `stereo_frontend` inside its own capture.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam2_commit_tpu_torch.kernels import matching as matching_kernel
from orb_slam2_commit_tpu_torch.ops import extractor as ext
from orb_slam2_commit_tpu_torch.ops import matching, pyramid
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.config import ORBConfig
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

SAD_HALF = 5          # 11x11 window (reference w=5, src/Frame.cc:675)
SLIDE = 5             # +/-5 px scan (reference L=5, :683)
TH_ORB = (matching.TH_HIGH + matching.TH_LOW) / 2  # 75 (:556)

_scale_factors = device_table(
    lambda orb: np.asarray(orb.scale_factors(), np.float32))


def pyramid_stack(levels: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Pad pyramid levels to level 0's shape with zeros and stack them:
    [L, H0, W0]."""
    h0, w0 = levels[0].shape
    return torch.stack([
        F.pad(lv, (0, w0 - lv.shape[1], 0, h0 - lv.shape[0])) for lv in levels])


class StereoMatch(NamedTuple):
    u_right: torch.Tensor   # [N] refined right u in level-0 coords (-1 invalid)
    depth: torch.Tensor     # [N] metric depth (-1 invalid)
    valid: torch.Tensor     # [N] bool


def stereo_frontend(
    image_l: torch.Tensor,
    image_r: torch.Tensor,
    orb_config: ORBConfig,
    height: int,
    width: int,
    bf: float,
    baseline: float,
) -> Tuple[ext.Features, ext.Features, StereoMatch]:
    """The stereo front end: extract both images, build both pyramid
    stacks, match left to right. -> (left features, right features,
    StereoMatch over the left features)."""
    image_l = image_l.to(torch.float32)
    image_r = image_r.to(torch.float32)
    feats_l = ext.extract_features(image_l, orb_config, height, width)
    feats_r = ext.extract_features(image_r, orb_config, height, width)
    shapes = orb_config.level_shapes(height, width)
    stack_l = pyramid_stack(pyramid.build_pyramid(image_l, shapes))
    stack_r = pyramid_stack(pyramid.build_pyramid(image_r, shapes))
    match = stereo_match(
        feats_l.xy, feats_l.octave, feats_l.desc, feats_l.valid,
        feats_r.xy, feats_r.octave, feats_r.desc, feats_r.valid,
        stack_l, stack_r, bf, baseline,
        _scale_factors(image_l.device, orb_config),
    )
    return feats_l, feats_r, match


def _frontend(image_l, image_r, key):
    return stereo_frontend(image_l, image_r, *key)


@full_float32
def stereo_frontend_jit(
    image_l: torch.Tensor,
    image_r: torch.Tensor,
    orb_config: ORBConfig,
    height: int,
    width: int,
    bf: float,
    baseline: float,
) -> Tuple[ext.Features, ext.Features, StereoMatch]:
    """stereo_frontend through utils/cuda_graph.call: one replay on the
    card, eagerly on the CPU."""
    return cuda_graph.call(_frontend, (image_l, image_r),
                           (orb_config, height, width, bf, baseline), static=ext.routes())


# The functions stereo_frontend_jit captures (cuda_graph.release's owners).
GRAPHED = (_frontend,)


def _gather_window(stack, level, yc, xc, half):
    """[..., 2h+1, 2h+1] windows of stack[level] centred on the integer
    (yc, xc), which broadcast together with level. Rows and columns are
    clipped to the stack's H0, W0, not to the level's own size: near a
    small level's right or bottom edge a window reads the stack's zero
    padding, as in the JAX package."""
    _, h, w = stack.shape
    d = torch.arange(-half, half + 1, device=stack.device)
    ys = torch.clamp(yc[..., None] + d, 0, h - 1)
    xs = torch.clamp(xc[..., None] + d, 0, w - 1)
    return stack[level[..., None, None], ys[..., :, None], xs[..., None, :]]


def stereo_match(
    xy_l: torch.Tensor, octave_l: torch.Tensor, desc_l: torch.Tensor,
    valid_l: torch.Tensor,
    xy_r: torch.Tensor, octave_r: torch.Tensor, desc_r: torch.Tensor,
    valid_r: torch.Tensor,
    stack_l: torch.Tensor, stack_r: torch.Tensor,
    bf: float,
    min_z: float,
    scale_factors: torch.Tensor,   # [n_levels] float32
) -> StereoMatch:
    """Match left keypoints to right keypoints along epipolar rows.

    Coordinates in level-0 pixels (rectified pair: epipolar lines are rows).
    min_z = baseline, so the largest disparity is bf / b = fx (reference
    src/Frame.cc:559-561). Runs on the device of its inputs without
    waiting for it."""
    dev = xy_l.device
    n_l = xy_l.shape[0]
    max_d = bf / min_z
    min_d = 0.0
    lvl = torch.clamp(octave_l, 0, scale_factors.shape[0] - 1).long()
    scale = scale_factors[lvl]

    # --- Hamming best match and mutual check under the candidate band (K7)
    (best, best_idx, second, second_idx), (_, best_l_for_r, _, _) = \
        matching_kernel.stereo_band_top2(
            *(t.contiguous() for t in (desc_l, xy_l, octave_l, scale, valid_l,
                                       desc_r, xy_r, octave_r, valid_r)), max_d)
    m = matching.match_from_top2(best, best_idx, second, second_idx, int(TH_ORB))
    has = m.idx >= 0
    ridx = torch.clamp_min(m.idx, 0).long()

    # Left-right consistency (beyond the reference): the matched right
    # keypoint's own best left candidate must be this left keypoint. A
    # right keypoint with no candidate has best index 0, as jnp.argmin
    # gives over an all-BIG column.
    rows = torch.arange(n_l, dtype=torch.int32, device=dev)
    has = has & (best_l_for_r[ridx] == rows)

    # --- SAD subpixel refinement at the keypoint's own pyramid level -------
    inv_scale = torch.reciprocal(scale)
    uL = xy_l[:, 0] * inv_scale
    vL = xy_l[:, 1] * inv_scale
    uR0 = xy_r[ridx, 0] * inv_scale
    iuL = torch.round(uL).long()
    ivL = torch.round(vL).long()
    iuR0 = torch.round(uR0).long()

    c = slice(SAD_HALF, SAD_HALF + 1)
    win_l = _gather_window(stack_l, lvl, ivL, iuL, SAD_HALF)    # [N, 11, 11]
    # Normalize by the centre intensity (reference :678-681).
    win_l = win_l - win_l[:, c, c]
    shifts = torch.arange(-SLIDE, SLIDE + 1, device=dev)
    win_r = _gather_window(stack_r, lvl[:, None], ivL[:, None],
                           iuR0[:, None] + shifts, SAD_HALF)    # [N, 11, 11, 11]
    win_r = win_r - win_r[..., c, c]
    sads = torch.abs(win_l[:, None] - win_r).to(torch.float64).sum(dim=(2, 3))
    sads = sads.to(torch.float32)                               # [N, 11]
    best = matching._first_argmin(sads)
    # Parabola fit over the best and its neighbours (reference :719-728).
    ib = torch.clamp(best, 1, 2 * SLIDE - 1)
    s_m, s_c, s_p = (sads.gather(1, (ib + k).long()[:, None])[:, 0] for k in (-1, 0, 1))
    denom = 2.0 * (s_m + s_p - 2.0 * s_c)
    delta = torch.where(torch.abs(denom) > 1e-9, (s_m - s_p) / denom, 0.0)
    # An out-of-range parabola offset means no true SAD valley: the
    # reference rejects it (src/Frame.cc:729-730) rather than clipping.
    delta_ok = torch.abs(delta) <= 1.0
    delta = torch.clamp(delta, -1.0, 1.0)

    u_r_level = iuR0.to(torch.float32) + (ib - SLIDE) + delta
    u_r0 = u_r_level * scale
    disparity = xy_l[:, 0] - u_r0
    ok = (
        has
        & delta_ok
        & (disparity > min_d)
        & (disparity < max_d)
        & (best >= 1)
        & (best <= 2 * SLIDE - 1)
    )
    # bf / disparity rounded once, as in the JAX package (a Python number
    # over a tensor is reciprocal-then-multiply in PyTorch).
    bf_over_d = torch.full_like(disparity, bf) / torch.where(ok, disparity, 1.0)
    depth = torch.where(ok, bf_over_d, -1.0)

    # --- median-based outlier cut (reference :770-787) ----------------------
    dist_best = torch.where(ok, m.dist, matching.BIG_DIST)
    sorted_d = torch.sort(dist_best).values
    mid = torch.clamp(torch.sum(ok) // 2, 0, n_l - 1)
    median = sorted_d[mid[None]][0].to(torch.float32)
    th = 1.5 * 1.4 * median
    keep = ok & (m.dist.to(torch.float32) < th)

    return StereoMatch(
        u_right=torch.where(keep, u_r0, -1.0),
        depth=torch.where(keep, depth, -1.0),
        valid=keep,
    )
