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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_commit_tpu_torch.ops import descriptors
from orb_slam2_commit_tpu_torch.utils.config import ORBConfig


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


def extract_features(
    image: torch.Tensor, config: ORBConfig, height: int, width: int
) -> Features:
    """ORB front end on image[height, width] (grayscale 0-255, any real
    dtype; cast to float32 on its device). Keypoint coords are rescaled to
    level 0 by scale_factor**level, as the reference does
    (src/ORBextractor.cc:1203-1209). Every device takes the packed-canvas
    route (ops/packed_extractor.py)."""
    from orb_slam2_commit_tpu_torch.ops import packed_extractor

    return packed_extractor.extract_features_packed(
        image.to(torch.float32), config, height, width
    )
