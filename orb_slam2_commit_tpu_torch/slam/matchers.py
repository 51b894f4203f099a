"""Tracker-level matching (PyTorch port of the motion-model matcher of
slam/matchers.py): dense masked Hamming matrix -> best/ratio -> rotation
histogram -> duplicate resolution, over fixed-shape padded tensors."""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.ops.matching import MatchResult, TH_HIGH
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


def _projection_match(
    pt_desc, proj, radius, oct_lo, oct_hi, valid_a,
    xy, desc, octave, valid_b, max_dist,
) -> MatchResult:
    """Window + octave-band projection matching on the dense route (the
    fused projection-matcher kernel is not ported yet)."""
    dist = matching.hamming_distance_matrix(pt_desc, desc)
    mask = (
        valid_a[:, None]
        & valid_b[None, :]
        & matching.window_mask(proj, xy, radius)
        & matching.octave_band_mask(octave, oct_lo, oct_hi)
    )
    return matching.best_match_with_ratio(dist, mask, max_dist)


_scale_sigmas = device_table(
    lambda n_levels, scale: np.array([scale ** i for i in range(n_levels)],
                                     np.float32))


@full_float32
def match_projection_last_frame(
    pt_pos: torch.Tensor,       # [M, 3] last frame's bound points (world)
    pt_desc: torch.Tensor,      # [M, 8] int32
    pt_octave: torch.Tensor,    # [M] octave of the last-frame feature
    pt_angle: torch.Tensor,     # [M]
    pt_valid: torch.Tensor,     # [M]
    R: torch.Tensor, t: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor, angle: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    th: float = 15.0,
    n_levels: int = 8,
    scale: float = 1.2,
) -> MatchResult:
    """Monocular motion-model tracking: project the last frame's points
    with the predicted pose and search a window of th * sigma(octave)
    around each, over octaves [oct-1, oct+1]
    (SearchByProjection(Frame&, const Frame&, th, bMono=true),
    src/ORBmatcher.cc:1489-1646)."""
    sigmas = _scale_sigmas(pt_pos.device, n_levels, scale)
    pc = torch.einsum("ij,mj->mi", R, pt_pos) + t
    z = pc[:, 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = fx * pc[:, 0] * inv_z + cx
    v = fy * pc[:, 1] * inv_z + cy
    proj = torch.stack([u, v], dim=-1)
    in_img = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)

    oct_lo, oct_hi = pt_octave - 1, pt_octave + 1
    radius = th * sigmas[torch.clamp(pt_octave, 0, sigmas.shape[0] - 1).long()]
    m = _projection_match(
        pt_desc, proj, radius, oct_lo, oct_hi,
        pt_valid & in_img, xy, desc, octave, valid, TH_HIGH,
    )
    m = matching.rotation_consistency_filter(m, pt_angle, angle)
    return matching.resolve_duplicate_targets(m, desc.shape[0])
