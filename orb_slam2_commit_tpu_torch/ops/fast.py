"""FAST-9/16 corner scores, cell fallback, NMS, per-row top-k and the
per-level keypoint selection (PyTorch port of ops/fast.py).

These are the plain versions of the extraction kernels: the level kernel
(blur + FAST) and the combine+NMS kernel in kernels/level.py, and the
per-cell top-k kernel in kernels/select.py, hold their results against
the functions here. The per-level extraction route (ops/extractor.py)
takes `two_threshold_score_maps` on the gather route and
`select_keypoints` on both of its routes.
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


def _circle_stack(image: torch.Tensor) -> torch.Tensor:
    """[16, H, W] shifted copies, stack[i, y, x] = image[y + dy_i, x + dx_i],
    with BORDER_REFLECT_101 neighbourhoods at the image border (the level
    kernel's borders, so the dense score maps equal its maps bit for
    bit)."""
    h, w = image.shape
    padded = F.pad(image[None, None], (3, 3, 3, 3), mode="reflect")[0, 0]
    return torch.stack([padded[3 + int(dy) : 3 + int(dy) + h, 3 + int(dx) : 3 + int(dx) + w]
                        for dy, dx in CIRCLE_OFFSETS])


def _score_from_diffs(d, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment test + V-score from the 16 circle differences d[i] = ring_i -
    centre, taken in CIRCLE_OFFSETS order (a [16, H, W] tensor or any
    iterable of [H, W] maps): (corner_mask, score). The bright and dark
    V-scores are summed left to right in that order (the level kernel's
    order)."""
    bright_bits = dark_bits = bright_score = dark_score = None
    for bit, di in enumerate(d):
        b = (di > threshold).to(torch.int32) << bit
        k = (di < -threshold).to(torch.int32) << bit
        sb = torch.clamp_min(di - threshold, 0.0)
        sd = torch.clamp_min(-di - threshold, 0.0)
        if bit == 0:
            bright_bits, dark_bits, bright_score, dark_score = b, k, sb, sd
        else:
            bright_bits, dark_bits = bright_bits | b, dark_bits | k
            bright_score, dark_score = bright_score + sb, dark_score + sd
    is_corner = _has_arc(bright_bits) | _has_arc(dark_bits)
    score = torch.maximum(bright_score, dark_score)
    return is_corner, torch.where(is_corner, score, torch.zeros_like(score))


def fast_scores_padded(
    padded: torch.Tensor, out_h: int, out_w: int, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment test + V-score at every output pixel of an image padded by 3
    on the top and left: pixel (y, x) is padded[y+3, x+3]. One circle
    difference map at a time, in CIRCLE_OFFSETS order."""
    center = padded[3 : 3 + out_h, 3 : 3 + out_w]
    return _score_from_diffs(
        (padded[3 + int(dy) : 3 + int(dy) + out_h, 3 + int(dx) : 3 + int(dx) + out_w]
         - center for dy, dx in CIRCLE_OFFSETS), threshold)


# The compass points of the circle (CIRCLE_OFFSETS indices): any run of
# ARC_LENGTH >= 9 consecutive circle pixels holds at least two of them.
COMPASS = (0, 4, 8, 12)


def _has_arc_stack(mask: torch.Tensor) -> torch.Tensor:
    """_has_arc on a [16, N] bool stack in CIRCLE_OFFSETS order -> [N]."""
    m = torch.cat([mask, mask[:ARC_LENGTH - 1]])
    r = m[:-1] & m[1:]        # run >= 2
    r = r[:-2] & r[2:]        # run >= 4
    r = r[:-4] & r[4:]        # run >= 8
    r = r[:16] & m[8:24]      # run >= 9, from each start
    for half in (8, 4, 2, 1):
        r = r[:half] | r[half:]
    return r[0]


def fast_scores_multi(
    padded: torch.Tensor, out_h: int, out_w: int, thresholds: Tuple[float, ...]
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """fast_scores_padded at each threshold, bit for bit. On a CUDA tensor
    it is that function (no host sync, so it can be captured in a CUDA
    graph); on the CPU the segment test and the V-score run only at the
    candidate pixels: those where at least two compass points pass the
    lowest threshold in one direction (a corner at any of the thresholds
    is one), each score summed in the same order from the same
    differences."""
    if padded.device.type != "cpu":
        return tuple(fast_scores_padded(padded, out_h, out_w, t) for t in thresholds)
    padded = padded.contiguous()
    pw = padded.shape[1]
    t0 = min(thresholds)
    center = padded[3 : 3 + out_h, 3 : 3 + out_w]
    n_bright = n_dark = 0
    for i in COMPASS:
        dy, dx = (int(v) for v in CIRCLE_OFFSETS[i])
        di = padded[3 + dy : 3 + dy + out_h, 3 + dx : 3 + dx + out_w] - center
        n_bright = n_bright + (di > t0).to(torch.uint8)
        n_dark = n_dark + (di < -t0).to(torch.uint8)
    idx = ((n_bright >= 2) | (n_dark >= 2)).reshape(-1).nonzero().squeeze(1)
    at = (idx // out_w + 3) * pw + idx % out_w + 3
    flat = padded.reshape(-1)
    offsets = torch.as_tensor(CIRCLE_OFFSETS[:, 0] * pw + CIRCLE_OFFSETS[:, 1],
                              dtype=torch.int64)
    d = flat[at[None] + offsets[:, None]] - flat[at][None]
    out = []
    for t in thresholds:
        is_corner = _has_arc_stack(d > t) | _has_arc_stack(d < -t)
        sb, sd = torch.clamp_min(d - t, 0.0), torch.clamp_min(-d - t, 0.0)
        bright, dark = sb[0].clone(), sd[0].clone()
        for i in range(1, 16):
            bright += sb[i]
            dark += sd[i]
        corner = torch.zeros(out_h * out_w, dtype=torch.bool)
        score = torch.zeros(out_h * out_w, dtype=padded.dtype)
        corner[idx] = is_corner
        score[idx] = torch.where(is_corner, torch.maximum(bright, dark), 0.0)
        out.append((corner.reshape(out_h, out_w), score.reshape(out_h, out_w)))
    return tuple(out)


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


def two_threshold_scores(
    image: torch.Tensor, ini_threshold: float, min_threshold: float, cell_size: int
) -> torch.Tensor:
    """Two-threshold FAST with the per-cell fallback, after 3x3 NMS
    (src/ORBextractor.cc:892-915): a cell takes its iniThFAST corners, and
    only a cell with none takes its minThFAST corners. No path of the port
    calls it (the per-level route combines the maps in _extract_level, as
    JAX's does): it keeps the JAX module's name, and the tests hold it to
    JAX's."""
    score_hi, score_lo = two_threshold_score_maps(image, ini_threshold, min_threshold)
    return combine_two_threshold(score_hi, score_lo, cell_size)


def two_threshold_score_maps(
    image: torch.Tensor, ini_threshold: float, min_threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense FAST score maps of image[H, W] at both thresholds (no fallback
    or NMS yet), sharing one 16-map circle stack: the gather route's
    counterpart of the level kernel's (score_hi, score_lo)."""
    if image.device.type == "cpu":
        h, w = image.shape
        padded = F.pad(image[None, None], (3, 3, 3, 3), mode="reflect")[0, 0]
        (_, hi), (_, lo) = fast_scores_multi(padded, h, w, (ini_threshold, min_threshold))
        return hi, lo
    d = _circle_stack(image) - image[None]
    return _score_from_diffs(d, ini_threshold)[1], _score_from_diffs(d, min_threshold)[1]


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
    """Exact top-k along the last axis, as k rounds of (max, lowest index
    attaining it, mask to -inf) give it (topk_rounds): values descending,
    ties to the lowest index, as lax.top_k. The index is taken explicitly
    as a minimum, since neither torch.topk nor torch.argmax promises
    lowest-index ties on every device. On the CPU with every entry finite
    and no -0.0 the same result comes from torch.topk's values: every
    entry above the k-th value, then the lowest-index entries equal to it,
    ordered by value (stable, so ties stay in index order)."""
    n = x.shape[-1]
    if x.device.type == "cpu" and 1 <= k <= n and x.numel() and bool(
            (torch.isfinite(x) & ~((x == 0) & torch.signbit(x))).all()):
        rows = x.reshape(-1, n)
        kth = torch.topk(rows, k, dim=-1).values[:, -1:]
        above, tied = rows > kth, rows == kth
        keep = above | (tied & (torch.cumsum(tied, dim=-1) <= k - above.sum(-1, keepdim=True)))
        picked = keep.nonzero()[:, 1].reshape(-1, k)
        vals, order = torch.sort(rows.gather(1, picked), dim=-1, descending=True, stable=True)
        return (vals.reshape(x.shape[:-1] + (k,)),
                picked.gather(1, order).to(torch.int32).reshape(x.shape[:-1] + (k,)))
    return topk_rounds(x, k)


def topk_rounds(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """topk_iterative by its k rounds, on any device and any entries."""
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


def select_keypoints(
    score: torch.Tensor, n_keypoints: int, cell_size: int, cell_top_k: int, border: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially balanced top-n selection with fixed output shapes, the
    stand-in for the reference's DistributeOctTree
    (src/ORBextractor.cc:562-815): zero the scores within `border` of the
    edge, keep each cell's cell_top_k best, then the n_keypoints best of
    those. Ties go to the lowest index at both steps, as lax.top_k breaks
    them (topk_iterative in the cells, a stable descending sort over the
    survivors). -> (yx [n, 2] int32, response [n] float32, valid [n]
    bool); an invalid slot is parked at (border, border)."""
    h, w = score.shape
    dev = score.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(inside, score, torch.zeros_like(score))

    pad_h, pad_w = (-h) % cell_size, (-w) % cell_size
    wp = w + pad_w
    n_cy, n_cx = (h + pad_h) // cell_size, wp // cell_size
    cells = F.pad(score, (0, pad_w, 0, pad_h)).reshape(n_cy, cell_size, n_cx, cell_size)
    cells = cells.permute(0, 2, 1, 3).reshape(n_cy * n_cx, cell_size * cell_size)
    cell_vals, cell_arg = topk_iterative(cells, cell_top_k)

    cell_ids = torch.arange(n_cy * n_cx, device=dev)[:, None]
    iy = (cell_ids // n_cx) * cell_size + cell_arg // cell_size
    ix = (cell_ids % n_cx) * cell_size + cell_arg % cell_size
    flat_idx = (iy * wp + ix).reshape(-1)
    flat_vals = cell_vals.reshape(-1)

    k = min(n_keypoints, flat_vals.shape[0])
    top_vals, top_pos = torch.sort(flat_vals, descending=True, stable=True)
    top_vals, top_pos = top_vals[:k], top_pos[:k]
    if k < n_keypoints:
        top_vals = F.pad(top_vals, (0, n_keypoints - k))
        top_pos = F.pad(top_pos, (0, n_keypoints - k))
    top_idx = flat_idx[top_pos]
    yx = torch.stack([top_idx // wp, top_idx % wp], dim=-1).to(torch.int32)
    valid = top_vals > 0
    yx = torch.where(valid[:, None], yx, torch.full_like(yx, border))
    return yx, torch.where(valid, top_vals, torch.zeros_like(top_vals)), valid
