"""FAST-9/16 corner scores, cell fallback, NMS and per-row top-k
(PyTorch port of ops/fast.py).

These are the plain versions of the extraction kernels: the level kernel
(blur + FAST) and the combine+NMS kernel in kernels/level.py, and the
per-cell top-k kernel in kernels/select.py, hold their results against
the functions here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# The 16-pixel Bresenham circle of radius 3, (row, col) offsets, starting at
# the top and proceeding clockwise — the standard FAST ordering.
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LENGTH = 9  # FAST-9: contiguous arc of >= 9 pixels.


def _has_arc(mask16: torch.Tensor) -> torch.Tensor:
    """True where the 16-bit circular mask (int32, bits 0..15) has a run of
    >= ARC_LENGTH ones: double the mask for wrap-around, then collapse runs
    with log-step AND-shifts. Bits stay below 2**32, so the arithmetic
    shifts of int64 are logical here."""
    m = mask16.to(torch.int64)
    m = m | (m << 16)
    r = m & (m >> 1)      # run >= 2
    r = r & (r >> 2)      # run >= 4
    r = r & (r >> 4)      # run >= 8
    r = r & (m >> 8)      # run >= 9
    return (r & 0xFFFF) != 0


def fast_scores_padded(
    padded: torch.Tensor, out_h: int, out_w: int, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment test + V-score at every output pixel of an image padded by 3
    on the top and left: pixel (y, x) is padded[y+3, x+3]. The 16 circle
    differences are taken in CIRCLE_OFFSETS order and the bright/dark
    V-scores summed in that order (the level kernel's order)."""
    center = padded[3 : 3 + out_h, 3 : 3 + out_w]
    bright_bits = torch.zeros_like(center, dtype=torch.int32)
    dark_bits = torch.zeros_like(center, dtype=torch.int32)
    bright_score = None
    dark_score = None
    for bit, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        ring = padded[3 + int(dy) : 3 + int(dy) + out_h,
                      3 + int(dx) : 3 + int(dx) + out_w]
        d = ring - center
        bright_bits |= (d > threshold).to(torch.int32) << bit
        dark_bits |= (d < -threshold).to(torch.int32) << bit
        sb = torch.clamp_min(d - threshold, 0.0)
        sd = torch.clamp_min(-d - threshold, 0.0)
        bright_score = sb if bright_score is None else bright_score + sb
        dark_score = sd if dark_score is None else dark_score + sd
    is_corner = _has_arc(bright_bits) | _has_arc(dark_bits)
    score = torch.maximum(bright_score, dark_score)
    return is_corner, torch.where(is_corner, score, torch.zeros_like(score))


def fast_score_map(
    image: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FAST-9/16 over image[H, W] with reflect-101 neighbourhoods:
    (corner_mask[H, W] bool, score[H, W] float32)."""
    h, w = image.shape
    padded = F.pad(image[None, None], (3, 3, 3, 3), mode="reflect")[0, 0]
    return fast_scores_padded(padded, h, w, threshold)


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep local maxima of a 3x3 neighbourhood; equal-score plateaus go to
    the raster-first pixel. Outside the image counts as -inf (for the max)
    and as no candidate (for the index)."""
    h, w = score.shape
    pad_max = F.pad(score[None, None], (1, 1, 1, 1), value=float("-inf"))[0, 0]
    nb_max = score
    for dy in range(3):
        for dx in range(3):
            nb_max = torch.maximum(nb_max, pad_max[dy : dy + h, dx : dx + w])
    is_max = (score >= nb_max) & (score > 0)
    flat_idx = torch.arange(h * w, dtype=torch.int64,
                            device=score.device).reshape(h, w)
    big = h * w
    idx_map = torch.where(is_max, flat_idx, torch.full_like(flat_idx, big))
    pad_idx = F.pad(idx_map[None, None], (1, 1, 1, 1), value=big)[0, 0]
    nb_min = idx_map
    for dy in range(3):
        for dx in range(3):
            nb_min = torch.minimum(nb_min, pad_idx[dy : dy + h, dx : dx + w])
    keep = is_max & (flat_idx == nb_min)
    return torch.where(keep, score, torch.zeros_like(score))


def combine_two_threshold(
    score_hi: torch.Tensor, score_lo: torch.Tensor, cell_size: int
) -> torch.Tensor:
    """Per-cell high->low threshold fallback (a cell takes its high-threshold
    scores if any of them is > 0, else its low-threshold ones), then 3x3
    NMS."""
    h, w = score_hi.shape
    pad_h = (-h) % cell_size
    pad_w = (-w) % cell_size
    hi_p = F.pad(score_hi, (0, pad_w, 0, pad_h))
    cells = hi_p.reshape(
        (h + pad_h) // cell_size, cell_size, (w + pad_w) // cell_size, cell_size
    )
    cell_has_hi = cells.amax(dim=(1, 3)) > 0
    full = cell_has_hi.repeat_interleave(cell_size, 0).repeat_interleave(
        cell_size, 1)[:h, :w]
    return nms_3x3(torch.where(full, score_hi, score_lo))


def topk_iterative(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis by k rounds of (max, lowest index
    attaining it, mask to -inf): values descending, ties to the lowest
    index, as lax.top_k. The index is taken explicitly as a minimum, since
    neither torch.topk nor torch.argmax promises lowest-index ties on
    every device."""
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    vals, args = [], []
    for _ in range(k):
        v = x.amax(dim=-1, keepdim=True)
        a = torch.where(x == v, idx, n).amin(dim=-1, keepdim=True)
        vals.append(v)
        args.append(a)
        x = torch.where(idx == a, float("-inf"), x)
    return (torch.cat(vals, dim=-1),
            torch.cat(args, dim=-1).to(torch.int32))
