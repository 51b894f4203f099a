"""K1 level_preprocess (blur + FAST) and K2 combine_nms, with their plain
versions (PyTorch port of ops/pallas_level.py; kernels in csrc/level.cu).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
runs the plain version. Both produce the same bits.

K1's plain version reads the canvas padded in memory by `pad_level`; the
kernel reads the unpadded canvas and finds each padded pixel through
`pad_index`'s tables, which gather the same values.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import fast, pyramid
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table

HALO = 3          # blur radius 3, FAST circle radius 3
STRIPE = 64       # canvas rows are padded to a multiple of this
CELL = 32         # cell size of the fused combine (ORBConfig.cell_size)
CNMS_WIN = 128    # least canvas height the fused combine takes


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_level(image: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Reflect-101 by HALO on every side, then edge-pad to
    [round_up(H, 64) + 9, round_up(W, 128) + 128], as the Pallas wrapper
    pads. -> (padded, hp, wp): outputs are [hp, wp], and output (y, x) is
    centred on padded[y + 3, x + 3]; pad rows and columns of the outputs
    hold values of the edge-padded image that later masking ignores."""
    h, w = image.shape
    hp = _round_up(h, STRIPE)
    wp = _round_up(w, 128)
    wp_in = wp + 128
    x = F.pad(image[None, None], (HALO,) * 4, mode="reflect")
    x = F.pad(x, (0, wp_in - w - 2 * HALO, 0, hp - h + HALO), mode="replicate")
    return x[0, 0].contiguous(), hp, wp


def pad_index(n: int, n_padded: int) -> np.ndarray:
    """[n_padded] int32: padded index -> image index along an axis of n
    pixels, as `pad_level` pads it (reflect-101 by HALO, then the last
    entry repeated). So pad_level(image)[0] equals
    image[pad_index(h, hp + 9)][:, pad_index(w, wp + 128)]."""
    idx = np.pad(np.arange(n, dtype=np.int32), HALO, mode="reflect")
    return np.pad(idx, (0, n_padded - n - 2 * HALO), mode="edge")


_pad_index_table = device_table(pad_index)


def level_preprocess_plain(
    padded: torch.Tensor, hp: int, wp: int, th_hi: float, th_lo: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1 on the padded image."""
    blur = pyramid.separable_blur(padded, hp, wp)
    (_, hi), (_, lo) = fast.fast_scores_multi(padded, hp, wp, (th_hi, th_lo))
    return blur, hi, lo


def level_preprocess(
    image: torch.Tensor, th_hi: float, th_lo: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """image [H, W] float32 -> (blurred, score_hi, score_lo), each
    [round_up(H, 64), round_up(W, 128)] (the full stripe-padded canvas;
    [:H, :W] is the image): 7x7 sigma=2 blur and FAST-9/16 V-scores at
    both thresholds, with reflect-101 borders."""
    _build.require(image, "level_preprocess", torch.float32, 2)
    if not _build.on_card(image, "level_preprocess"):
        padded, hp, wp = pad_level(image)
        return level_preprocess_plain(padded, hp, wp, th_hi, th_lo)
    h, w = image.shape
    if min(h, w) <= HALO:
        raise ValueError(f"level_preprocess: reflect-101 by {HALO} needs more "
                         f"than {HALO} rows and columns, got {tuple(image.shape)}")
    hp, wp = _round_up(h, STRIPE), _round_up(w, 128)
    rows = _pad_index_table(image.device, h, hp + 2 * HALO)
    cols = _pad_index_table(image.device, w, wp + 2 * HALO)
    lib = _build.library("level")
    blur = torch.empty((hp, wp), dtype=torch.float32, device=image.device)
    hi = torch.empty_like(blur)
    lo = torch.empty_like(blur)
    taps = (ctypes.c_float * 7)(*pyramid.gaussian_kernel_1d(7, 2.0).tolist())
    err = lib.level_preprocess_launch(
        image.data_ptr(), h, w, rows.data_ptr(), cols.data_ptr(), blur.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), hp, wp, float(th_hi), float(th_lo), taps,
        _build.stream_of(image))
    _build.check(err, "level_preprocess")
    _build.count_launch("level_preprocess")
    return blur, hi, lo


def bounds_mask(bounds: torch.Tensor, wp: int) -> torch.Tensor:
    """[hp, wp] bool: column x of row y lies in [bounds[y, 0], bounds[y, 1])."""
    ix = torch.arange(wp, device=bounds.device)[None, :]
    return (ix >= bounds[:, 0:1]) & (ix < bounds[:, 1:2])


def combine_nms_plain(
    score_hi: torch.Tensor, score_lo: torch.Tensor, bounds: torch.Tensor
) -> torch.Tensor:
    """Plain version of K2."""
    mask = bounds_mask(bounds, score_hi.shape[1])
    zero = torch.zeros_like(score_hi)
    return fast.combine_two_threshold(
        torch.where(mask, score_hi, zero), torch.where(mask, score_lo, zero),
        CELL)


def combine_nms(
    score_hi: torch.Tensor, score_lo: torch.Tensor, bounds: torch.Tensor
) -> torch.Tensor:
    """Row-bounds mask + per-cell two-threshold combine + 3x3 NMS ->
    [hp, wp] float32. score_hi, score_lo: [hp, wp] float32 with hp % 64 == 0
    and wp % 128 == 0; bounds: [hp, >= 2] int32, each row's valid
    detection columns [bounds[y, 0], bounds[y, 1])."""
    for t, n in ((score_hi, "score_hi"), (score_lo, "score_lo")):
        _build.require(t, f"combine_nms {n}", torch.float32, 2)
    _build.require(bounds, "combine_nms bounds", torch.int32, 2)
    hp, wp = score_hi.shape
    if (score_lo.shape != score_hi.shape or bounds.shape[0] != hp
            or bounds.shape[1] < 2 or hp % STRIPE or wp % 128
            or not score_hi.device == score_lo.device == bounds.device):
        raise ValueError(
            f"combine_nms: shapes {tuple(score_hi.shape)}, "
            f"{tuple(score_lo.shape)}, {tuple(bounds.shape)} on "
            f"{score_hi.device}, {score_lo.device}, {bounds.device}")
    if not _build.on_card(score_hi, "combine_nms"):
        return combine_nms_plain(score_hi, score_lo, bounds)
    # The kernels read the maps 16 bytes at a time.
    score_hi, score_lo = _build.aligned(score_hi), _build.aligned(score_lo)
    lib = _build.library("level")
    out = torch.empty_like(score_hi)
    flags = torch.empty((hp // CELL, wp // CELL), dtype=torch.uint8,
                        device=score_hi.device)
    err = lib.combine_nms_launch(
        score_hi.data_ptr(), score_lo.data_ptr(), bounds.data_ptr(),
        bounds.shape[1], flags.data_ptr(), out.data_ptr(), hp, wp,
        _build.stream_of(score_hi))
    _build.check(err, "combine_nms")
    _build.count_launch("combine_nms")
    return out
