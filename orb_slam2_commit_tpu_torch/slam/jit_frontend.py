"""The per-frame tracking step: ORB extraction -> map-point projection
matching -> pose-only BA (PyTorch port of tracking_forward_step in
slam/jit_frontend.py; the reference's Tracking::Track hot path,
src/Tracking.cc:275-587).

The step runs on the device of its inputs and never waits for the
device inside: every count it returns is a tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.ops import extractor as ext
from orb_slam2_commit_tpu_torch.optim import pose_opt
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations
from orb_slam2_commit_tpu_torch.slam import matchers
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table

_level_sigma2 = device_table(
    lambda orb: np.asarray(orb.level_sigma2(), np.float32))


class TrackStepResult(NamedTuple):
    R: torch.Tensor          # [3, 3] optimized Tcw rotation
    t: torch.Tensor          # [3]
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    feat_xy: torch.Tensor    # [N, 2] extracted keypoints (diagnostics)


def bind_last_write(idx: torch.Tensor, n_feat: int) -> torch.Tensor:
    """Invert point->feature matches into per-feature bindings:
    binding[f] = the point bound to feature f, or -1.

    The JAX step scatters `where(idx >= 0, row, -1)` to `max(idx, 0)`, so
    every unmatched point also writes -1 to feature 0, and XLA keeps the
    LAST write in row order. The port reproduces that deterministically
    (a scatter with duplicate indices is not ordered on the card): the
    winning row per feature is the largest writing row, and the feature
    takes that row's value."""
    rows = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    target = torch.clamp_min(idx, 0).to(torch.int64)
    last = torch.full((n_feat,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, target, rows, reduce="amax")
    value = torch.where(idx >= 0, rows, -1)[torch.clamp_min(last, 0)]
    return torch.where(last >= 0, value, -1).to(torch.int32)


def pose_inputs(
    feats: ext.Features, idx: torch.Tensor, pt_pos: torch.Tensor,
    config: SLAMConfig,
) -> Tuple[torch.Tensor, BAObservations, torch.Tensor]:
    """Point->feature matches idx [M] -> (the map point bound to each
    feature [N, 3], the pose optimizer's mono observation table over the
    features, the per-feature bound mask)."""
    n_feat = feats.xy.shape[0]
    binding = bind_last_write(idx, n_feat)
    bound = binding >= 0
    dev = feats.xy.device
    sigma2 = _level_sigma2(dev, config.orb)
    inv_sigma2 = 1.0 / sigma2[
        torch.clamp(feats.octave, 0, config.orb.n_levels - 1).long()]
    obs = BAObservations(
        cam_idx=torch.zeros(n_feat, dtype=torch.int32, device=dev),
        pt_idx=torch.arange(n_feat, dtype=torch.int32, device=dev),
        uvr=torch.cat([feats.xy, torch.zeros((n_feat, 1), device=dev)], dim=1),
        inv_sigma2=inv_sigma2,
        is_stereo=torch.zeros(n_feat, dtype=torch.bool, device=dev),
        valid=bound & feats.valid,
    )
    return pt_pos[torch.clamp_min(binding, 0).long()], obs, bound


def tracking_forward_step(
    image: torch.Tensor,         # [H, W] float32 grayscale
    pt_pos: torch.Tensor,        # [M, 3] local map points (world)
    pt_desc: torch.Tensor,       # [M, 8] int32 (uint32 bits)
    pt_octave: torch.Tensor,     # [M] source octave for search radii
    pt_angle: torch.Tensor,      # [M]
    pt_valid: torch.Tensor,      # [M]
    R_pred: torch.Tensor,        # [3, 3] motion-model pose prediction
    t_pred: torch.Tensor,        # [3]
    config: SLAMConfig,
) -> TrackStepResult:
    cam = config.camera
    feats = ext.extract_features(image, config.orb, cam.height, cam.width)

    m = matchers.match_projection_last_frame(
        pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
        R_pred, t_pred,
        feats.xy, feats.desc, feats.angle, feats.octave, feats.valid,
        cam.fx, cam.fy, cam.cx, cam.cy,
        float(cam.width), float(cam.height),
        th=15.0,
        n_levels=config.orb.n_levels,
        scale=config.orb.scale_factor,
    )

    pts_per_feat, obs, bound = pose_inputs(feats, m.idx, pt_pos, config)
    res = pose_opt.pose_optimization(
        R_pred, t_pred, pts_per_feat, obs,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
    )
    return TrackStepResult(
        R=res.R,
        t=res.t,
        n_matches=torch.sum(bound),
        n_inliers=res.n_inliers,
        feat_xy=feats.xy,
    )
