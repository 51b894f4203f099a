"""Packed-canvas ORB extraction: every pyramid level through each stage at
once (PyTorch port of ops/packed_extractor.py).

All levels are stacked vertically into one canvas [sum(aligned heights),
W0] and each stage runs once on it:

  image -> pyramid (two batched products) -> canvas
  canvas -> blur + FAST at both thresholds  (K1, kernels/level.py)
         -> border mask + cell fallback + NMS (K2, kernels/level.py)
         -> per-cell top-k, read from the score map (K3, kernels/select.py)
         -> per-level top-k                 (one stable sort)
         -> 31x31 canvas and 39x39 blurred patches, and the subpixel
            offsets from the 31x31 windows when ORBConfig.subpixel_refine
            is on: one fused launch (K4 + K5, kernels/patches.py)
         -> IC angle from the 31x31 patches, rotated BRIEF from the 39x39

Level start rows are aligned to the cell size, so the canvas cell grid
restricted to a level is that level's own grid; the detection border
(>= 22 px) keeps every selected keypoint's score, IC patch and BRIEF
samples inside its own level. Integer outputs (positions, octaves,
descriptor bits) equal the JAX package's packed route; refined
coordinates agree with it within 1e-4 px.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.kernels import level, patches, select
from orb_slam2_commit_tpu_torch.ops import descriptors, fast, pyramid
from orb_slam2_commit_tpu_torch.ops.extractor import Features, detection_border
from orb_slam2_commit_tpu_torch.utils.config import ORBConfig
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PackPlan(NamedTuple):
    """Static canvas layout for one (config, image-size) combination."""

    shapes: Tuple[Tuple[int, int], ...]   # per-level (h, w)
    row_offsets: Tuple[int, ...]          # level start row in the canvas
    aligned_heights: Tuple[int, ...]      # cell-aligned level heights
    canvas_h: int
    width: int                            # canvas width == level-0 width
    border: int                           # detection border (>= 22)


def make_plan(config: ORBConfig, height: int, width: int) -> PackPlan:
    shapes = config.level_shapes(height, width)
    cell = config.cell_size
    offsets, aligned = [], []
    off = 0
    for (h, _w) in shapes:
        ha = _round_up(h, cell)
        offsets.append(off)
        aligned.append(ha)
        off += ha
    return PackPlan(
        shapes=tuple(shapes),
        row_offsets=tuple(offsets),
        aligned_heights=tuple(aligned),
        canvas_h=off,
        width=shapes[0][1],
        border=detection_border(config),
    )


@functools.lru_cache(maxsize=None)
def _bounds_np(plan: PackPlan, hp: int) -> np.ndarray:
    """[hp, 128] int32 row-wise detection bounds: col 0 = x0, col 1 = x1
    ([x0, x1) valid detection columns; 0-width outside level interiors)."""
    out = np.zeros((hp, 128), np.int32)
    b = plan.border
    for (h, w), off in zip(plan.shapes, plan.row_offsets):
        if h > 2 * b and w > 2 * b:
            out[off + b: off + h - b, 0] = b
            out[off + b: off + h - b, 1] = w - b
    return out


@functools.lru_cache(maxsize=None)
def _border_mask_np(plan: PackPlan) -> np.ndarray:
    """[canvas_h, W] float32 {0,1}: 1 inside some level's detection
    interior (>= border px from every level edge)."""
    m = np.zeros((plan.canvas_h, plan.width), np.float32)
    b = plan.border
    for (h, w), off in zip(plan.shapes, plan.row_offsets):
        if h > 2 * b and w > 2 * b:
            m[off + b : off + h - b, b : w - b] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _canvas_row_map(plan: PackPlan) -> np.ndarray:
    """[canvas_h - aligned_h0] row gather map into the [L-1, h0, w0] stack
    (viewed as [(L-1)*h0, w0]); alignment-gap rows point at zero rows of
    the stack (every stack row >= level height is zero)."""
    h0 = plan.shapes[0][0]
    rows = []
    for lvl in range(1, len(plan.shapes)):
        ha = plan.aligned_heights[lvl]
        h = plan.shapes[lvl][0]
        if not (ha <= h0 and h < h0):
            raise ValueError("pyramid levels must shrink (scale_factor > 1)")
        rows.append((lvl - 1) * h0 + np.minimum(np.arange(ha), h0 - 1))
    return np.concatenate(rows).astype(np.int64)


def _slot_gather_np(plan: PackPlan, n_cy: int, n_cx: int, cell_size: int,
                    cell_top_k: int) -> np.ndarray:
    """[L, slot_max] flat candidate ids per level: level l owns the
    contiguous range of its cell rows; padding points at the zero slot
    (the id after the last candidate)."""
    slot_counts = [
        (ha // cell_size) * n_cx * cell_top_k for ha in plan.aligned_heights
    ]
    zero_slot = n_cy * n_cx * cell_top_k
    out = np.full((len(plan.shapes), max(slot_counts)), zero_slot, np.int64)
    for lvl, count in enumerate(slot_counts):
        start = (plan.row_offsets[lvl] // cell_size) * n_cx * cell_top_k
        out[lvl, :count] = start + np.arange(count)
    return out


def _compaction_np(budgets: Tuple[int, ...]) -> np.ndarray:
    """Slots of the [L, max(budgets)] matrices kept in the N = sum(budgets)
    output layout, level-major."""
    kmax = max(budgets)
    return np.concatenate(
        [np.arange(b, dtype=np.int64) + l * kmax for l, b in enumerate(budgets)])


_row_map_t = device_table(_canvas_row_map)
_bounds_t = device_table(_bounds_np)
_border_mask_t = device_table(_border_mask_np)
_slot_gather_t = device_table(_slot_gather_np)
_compaction_t = device_table(_compaction_np)
_column_t = device_table(lambda values: np.asarray(values, np.int32)[:, None])
_per_slot_t = device_table(lambda values, budgets, dtype: np.concatenate(
    [np.full(b, v, dtype) for v, b in zip(values, budgets)]))


def build_canvas(image: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """Packed canvas [canvas_h, W0]: level 0 is the image (zero-padded to
    its aligned slot), levels 1+ one row gather of the pyramid stack."""
    stack = pyramid.direct_pyramid_stack(image, plan.shapes)
    h0, w0 = plan.shapes[0]
    rest = stack.reshape(-1, w0)[_row_map_t(image.device, plan)]
    lvl0 = torch.nn.functional.pad(image, (0, 0, 0, plan.aligned_heights[0] - h0))
    return torch.cat([lvl0, rest], dim=0)


def packed_select(
    score: torch.Tensor,
    plan: PackPlan,
    budgets: Tuple[int, ...],
    cell_size: int,
    cell_top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially balanced selection for every level at once.

    Returns per-level padded matrices over kmax = max(budgets) slots:
      yx[L, kmax, 2] canvas coords (parked in-level when invalid),
      response[L, kmax], valid[L, kmax].
    """
    dev = score.device
    n_cy = score.shape[0] // cell_size
    n_cx = _round_up(score.shape[1], cell_size) // cell_size
    cell_vals, cell_arg = select.cell_topk_map(score, cell_size, cell_top_k)
    cell_vals = cell_vals.clamp_min(0.0)   # -inf pads (k > nonzeros) -> 0

    cell_ids = torch.arange(n_cy * n_cx, dtype=torch.int32, device=dev)[:, None]
    cy, cx = cell_ids // n_cx, cell_ids % n_cx
    iy = cy * cell_size + cell_arg // cell_size
    ix = cx * cell_size + cell_arg % cell_size

    # One extra zero slot at the end backs the padding of every level row.
    zero_i = torch.zeros(1, dtype=torch.int32, device=dev)
    flat_vals = torch.cat([cell_vals.reshape(-1), torch.zeros(1, device=dev)])
    flat_iy = torch.cat([iy.reshape(-1), zero_i])
    flat_ix = torch.cat([ix.reshape(-1), zero_i])

    # Regroup candidate slots by level with one static gather: level l owns
    # the contiguous flat range of its cell rows; padding points at the
    # zero slot.
    gather_idx = _slot_gather_t(dev, plan, n_cy, n_cx, cell_size, cell_top_k)
    lvl_vals = flat_vals[gather_idx]                      # [L, slot_max]

    # Per-level top-kmax, ties to the lowest slot (as lax.top_k): a stable
    # descending sort keeps equal values in slot order.
    kmax = max(budgets)
    top_vals, top_pos = torch.sort(lvl_vals, dim=1, descending=True, stable=True)
    top_vals, top_pos = top_vals[:, :kmax], top_pos[:, :kmax]
    flat_pos = torch.gather(gather_idx, 1, top_pos)
    top_iy = flat_iy[flat_pos]
    top_ix = flat_ix[flat_pos]

    slot = torch.arange(kmax, dtype=torch.int32, device=dev)[None, :]
    valid = (slot < _column_t(dev, budgets)) & (top_vals > 0)

    # Park invalid slots inside their own level's interior.
    park_y = _column_t(dev, plan.row_offsets) + plan.border
    yx = torch.stack(
        [
            torch.where(valid, top_iy, park_y),
            torch.where(valid, top_ix, torch.full_like(top_ix, plan.border)),
        ],
        dim=-1,
    ).to(torch.int32)
    return yx, torch.where(valid, top_vals, torch.zeros_like(top_vals)), valid


def detect(
    canvas: torch.Tensor, plan: PackPlan, config: ORBConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blur + FAST (K1), then border mask + cell fallback + NMS (K2) ->
    (blurred canvas, NMS'd score map)."""
    blur_c, hi_c, lo_c = level.level_preprocess(
        canvas, float(config.ini_th_fast), float(config.min_th_fast))
    hp = hi_c.shape[0]
    mask = _border_mask_t(canvas.device, plan)
    if config.cell_size != level.CELL:
        # The fused combine assumes 32-px cells: combine the image part.
        crop = (slice(0, plan.canvas_h), slice(0, plan.width))
        return blur_c[crop].contiguous(), fast.combine_two_threshold(
            hi_c[crop] * mask, lo_c[crop] * mask, config.cell_size)
    if hp >= level.CNMS_WIN and hi_c.shape[1] <= 128 * level.CELL:
        # Fused mask + combine + NMS (the same route condition as the JAX
        # package); the row bounds zero the pad rows and columns of the
        # full-canvas maps.
        bounds = _bounds_t(canvas.device, plan, hp)
        return blur_c, level.combine_nms(hi_c, lo_c, bounds)
    m = torch.zeros_like(hi_c)    # tiny canvas
    m[: plan.canvas_h, : plan.width] = mask
    return blur_c, fast.combine_two_threshold(hi_c * m, lo_c * m, config.cell_size)


def select_flat(
    score: torch.Tensor, plan: PackPlan, config: ORBConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """packed_select compacted to the N = sum(budgets) output layout:
    (yx [N, 2] int32 canvas coords, response [N], valid [N])."""
    budgets = config.features_per_level()
    yx, resp, valid = packed_select(
        score, plan, budgets, config.cell_size, config.cell_top_k
    )
    sel = _compaction_t(score.device, budgets)
    return (yx.reshape(-1, 2)[sel].contiguous(), resp.reshape(-1)[sel],
            valid.reshape(-1)[sel])


def describe(
    canvas: torch.Tensor, blur_c: torch.Tensor, yx: torch.Tensor, refine: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """IC angle from 31x31 canvas patches and BRIEF from 39x39 blurred
    patches, both gathered, with the subpixel offsets when refine is set,
    by one fused launch (K4 + K5) -> (angle [N], desc [N, 8] int32,
    offsets [N, 2] (dy, dx) or None)."""
    ic_patches, brief_patches, offsets = patches.describe_patches(canvas, blur_c, yx, refine)
    angle = descriptors.ic_angle_from_patches(ic_patches)
    return angle, descriptors.brief_from_patches(brief_patches, angle), offsets


def extract_features_packed(
    image: torch.Tensor, config: ORBConfig, height: int, width: int
) -> Features:
    """Packed-canvas ORB extraction of image[height, width] float32;
    output layout: level-major concatenation of the per-level budgets,
    coords rescaled to level 0."""
    plan = make_plan(config, height, width)
    return features_from_canvas(build_canvas(image, plan), plan, config)


def features_from_canvas(
    canvas: torch.Tensor, plan: PackPlan, config: ORBConfig
) -> Features:
    """Everything after the pyramid: detection, selection, orientation,
    BRIEF and refinement on a packed canvas."""
    budgets = config.features_per_level()
    scales = config.scale_factors()
    dev = canvas.device

    blur_c, score = detect(canvas, plan, config)
    yx, resp, valid = select_flat(score, plan, config)
    # Every keypoint sits >= border px inside its level's canvas rows, so
    # the 9x9 refinement window never crosses a level boundary.
    angle, desc, offsets = describe(canvas, blur_c, yx, config.subpixel_refine)

    row_off = _per_slot_t(dev, plan.row_offsets, budgets, np.float32)
    scale = _per_slot_t(dev, scales, budgets, np.float32)
    xy_f = yx.to(torch.float32)
    if offsets is not None:
        xy_f = xy_f + offsets
    x0 = xy_f[:, 1] * scale
    y0 = (xy_f[:, 0] - row_off) * scale
    return Features(
        xy=torch.stack([x0, y0], dim=-1),
        response=resp,
        angle=angle,
        octave=_per_slot_t(dev, tuple(range(len(budgets))), budgets, np.int32),
        desc=desc,
        valid=valid,
    )
