"""The ORB feature extractor: pyramid -> FAST -> select -> orient -> BRIEF
(PyTorch port of ops/extractor.py).

Output layout (Features):
  xy        [N, 2] float32 — (x, y) in level-0 coords
  response  [N]    float32
  angle     [N]    float32 — radians
  octave    [N]    int32
  desc      [N, 8] int32   — 256-bit rotated BRIEF (uint32 bits)
  valid     [N]    bool
N = sum of per-level budgets (== config n_features up to rounding).

Two routes give the same features (JAX tests/test_packed_extractor.py
holds its two to that): the packed canvas (ops/packed_extractor.py, every
level through each stage at once) and the per-level route, one level at a
time, which is the JAX package's readable oracle. The per-level route has
two forms, `descriptors.use_patch_route`: the patch route (K1 per level,
then the standalone K4 twice per level) and the gather route (dense maps
in plain PyTorch).

`extract_features_jit` is the single-dispatch form (the JAX package's
jitted namesake, the same arguments): on CUDA tensors one replay of a
CUDA graph captured at the first call for its key (utils/cuda_graph.py;
the routes below are part of it), on CPU tensors the same function run
eagerly. The staged frame (slam/frame.make_frame) calls it; the fused
tracker's graphs call `extract_features` inside their own captures.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.ops import descriptors, fast, pyramid
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.config import ORBConfig
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


class Features(NamedTuple):
    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    octave: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def detection_border(config: ORBConfig) -> int:
    """Detection border, px: the reference's EDGE_THRESHOLD-3 = 16
    (src/ORBextractor.cc:822-825), widened so every BRIEF sample plus its
    blur taps stays inside the level."""
    return max(config.edge_threshold - 3, descriptors.BRIEF_HALF + 3)


def use_packed_route() -> bool:
    """Packed-canvas extraction? ORB_TPU_FORCE_PACKED=0/1 decides, read at
    each call, as in the JAX package. Unset, every device takes the packed
    route; the JAX package's default differs on the CPU only, where it
    takes the per-level route, and the two routes give the same
    features."""
    return os.environ.get("ORB_TPU_FORCE_PACKED", "1") != "0"


def routes() -> tuple:
    """The extraction routes, read at call time (`use_packed_route`,
    ops/descriptors.use_patch_route) and so fixed in a graph at its
    capture: part of the key of every graph that extracts."""
    return use_packed_route(), os.environ.get("ORB_TPU_FORCE_PATCHES")


def _border_premask(score: torch.Tensor, border: int) -> torch.Tensor:
    """Zero the scores within `border` of the level's edge, before the cell
    fallback and NMS (the packed route's order)."""
    h, w = score.shape
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    return torch.where(inside, score, torch.zeros_like(score))


def _extract_level(
    image: torch.Tensor, budget: int, config: ORBConfig
) -> Tuple[torch.Tensor, ...]:
    """FAST, selection, orientation and BRIEF on one pyramid level
    image[h, w] float32 -> (yx [budget, 2] int32, response, angle, desc
    [budget, 8] int32, valid).

    On the patch route the level kernel (K1, kernels/level.py) gives the
    blur and both score maps, stripe-padded, cropped here to the level; it
    needs more than 3 rows and columns (its reflect-101 halo), so every
    level must keep min(h, w) > 3: a configuration whose smallest level
    is 3 px or less on a side (e.g. 8 levels at scale 1.2 of an image
    under 12 px on a side) is refused there, and such a level could hold
    no keypoint anyway (the detection border is >= 22 px)."""
    from orb_slam2_commit_tpu_torch.kernels import level

    border = detection_border(config)
    h, w = image.shape
    patch_route = descriptors.use_patch_route(image)
    if patch_route:
        blurred, s_hi, s_lo = level.level_preprocess(
            image, float(config.ini_th_fast), float(config.min_th_fast))
        blurred, s_hi, s_lo = (t[:h, :w] for t in (blurred, s_hi, s_lo))
    else:
        s_hi, s_lo = fast.two_threshold_score_maps(
            image, float(config.ini_th_fast), float(config.min_th_fast))
        blurred = pyramid.gaussian_blur(image)
    score = fast.combine_two_threshold(
        _border_premask(s_hi, border), _border_premask(s_lo, border), config.cell_size)
    yx, response, valid = fast.select_keypoints(
        score, budget, config.cell_size, config.cell_top_k, border)
    if patch_route:
        angle = descriptors.ic_angle_patches(image, yx)
        desc = descriptors.brief_descriptors_patches(blurred.contiguous(), yx, angle)
    else:
        angle = descriptors.ic_angle(image, yx)
        desc = descriptors.brief_descriptors(blurred, yx, angle)
    return yx, response, angle, desc, valid


def extract_features(
    image: torch.Tensor, config: ORBConfig, height: int, width: int
) -> Features:
    """ORB front end on image[height, width] (grayscale 0-255, any real
    dtype; cast to float32 on its device). Keypoint coords are rescaled to
    level 0 by scale_factor**level, as the reference does
    (src/ORBextractor.cc:1203-1209). The packed-canvas route
    (ops/packed_extractor.py) unless `use_packed_route()` says otherwise;
    then one level at a time (`_extract_level`), subpixel offsets from
    ops/subpix.corner_subpix_offsets on the level."""
    image = image.to(torch.float32)
    if use_packed_route():
        from orb_slam2_commit_tpu_torch.ops import packed_extractor

        return packed_extractor.extract_features_packed(image, config, height, width)
    from orb_slam2_commit_tpu_torch.ops import subpix

    levels = pyramid.build_pyramid(image, config.level_shapes(height, width))
    budgets = config.features_per_level()
    parts = []
    for lvl, (img_l, budget, scale) in enumerate(
            zip(levels, budgets, config.scale_factors())):
        img_l = img_l.contiguous()
        yx, resp, angle, desc, valid = _extract_level(img_l, budget, config)
        xy_f = yx.to(torch.float32)
        if config.subpixel_refine:
            xy_f = xy_f + subpix.corner_subpix_offsets(img_l, yx)
        parts.append((xy_f.flip(-1) * float(np.float32(scale)),
                      resp.to(torch.float32), angle.to(torch.float32),
                      torch.full((budget,), lvl, dtype=torch.int32, device=image.device),
                      desc, valid))
    return Features(*(torch.cat(cols, dim=0) for cols in zip(*parts)))


def _extract(image: torch.Tensor, key) -> Features:
    config, height, width = key
    return extract_features(image, config, height, width)


@full_float32
def extract_features_jit(
    image: torch.Tensor, config: ORBConfig, height: int, width: int
) -> Features:
    """extract_features through utils/cuda_graph.call: one replay on the
    card (K1-K5, or K1 and the standalone K4 per level on
    ORB_TPU_FORCE_PACKED=0), eagerly on the CPU."""
    return cuda_graph.call(_extract, (image,), (config, height, width), static=routes())


# The functions extract_features_jit captures (cuda_graph.release's owners).
GRAPHED = (_extract,)
