"""The per-frame tracker on the device (PyTorch port of
slam/jit_frontend.py; the reference's Tracking::Track hot path,
src/Tracking.cc:275-587):

- `tracking_forward_step`: ORB extraction -> projection matching against
  the local map -> pose-only BA;
- `fused_motion_track` and its packed-transfer twin
  `fused_motion_track_packed`: extraction, undistortion, motion-model
  matching with the widen-on-failure retry, pose-only BA;
- `fused_stereo_motion_track` / `fused_rgbd_motion_track` and their
  packed twins: the same stage for a stereo pair (both extractions and the
  stereo matcher, ops/stereo.py) or an image with its depth map, with
  stereo observations (u, v, u_right) in the pose-only BA;
- `fused_local_map_track`: TrackLocalMap's device part (frustum gates,
  projection matching, the final pose-only BA) on the features the motion
  stage left on the device.

Every function runs on the device of its inputs and never waits for the
device inside: every count it returns is a tensor.

Each of the eight has a single-dispatch form, named as the JAX package's
jitted one (`*_jit`, the same arguments in the same order): on the card
one replay of a CUDA graph captured at the first call for its key
(utils/cuda_graph.py), on CPU tensors the eager function. The System's
tracker calls the packed forms and `fused_local_map_track_jit`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.ops import camera as cam_ops
from orb_slam2_commit_tpu_torch.ops import extractor as ext
from orb_slam2_commit_tpu_torch.ops import stereo as stereo_ops
from orb_slam2_commit_tpu_torch.optim import pose_opt
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations
from orb_slam2_commit_tpu_torch.slam import matchers
from orb_slam2_commit_tpu_torch.utils import cuda_graph
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


def observations(
    xy: torch.Tensor, ur: torch.Tensor, octave: torch.Tensor,
    obs_ok: torch.Tensor, config: SLAMConfig,
) -> BAObservations:
    """The pose optimizer's observation table over the N features: (u, v,
    u_right) rows, stereo where ur >= 0 and the row is observed, the
    octave's information, valid = obs_ok."""
    n_feat = xy.shape[0]
    dev = xy.device
    sigma2 = _level_sigma2(dev, config.orb)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(octave, 0, config.orb.n_levels - 1).long()]
    has_ur = ur >= 0
    return BAObservations(
        cam_idx=torch.zeros(n_feat, dtype=torch.int32, device=dev),
        pt_idx=torch.arange(n_feat, dtype=torch.int32, device=dev),
        uvr=torch.cat([xy, torch.where(has_ur, ur, 0.0)[:, None]], dim=1),
        inv_sigma2=inv_sigma2,
        is_stereo=has_ur & obs_ok,
        valid=obs_ok,
    )


def pose_inputs(
    feats: ext.Features, idx: torch.Tensor, pt_pos: torch.Tensor,
    config: SLAMConfig,
) -> Tuple[torch.Tensor, BAObservations, torch.Tensor]:
    """Point->feature matches idx [M] -> (the map point bound to each
    feature [N, 3], the pose optimizer's mono observation table over the
    features, the per-feature bound mask)."""
    binding = bind_last_write(idx, feats.xy.shape[0])
    bound = binding >= 0
    no_ur = torch.full_like(feats.xy[:, 0], -1.0)
    obs = observations(feats.xy, no_ur, feats.octave, bound & feats.valid, config)
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


class FusedMotionResult(NamedTuple):
    """Everything the host tracker needs from one fused per-frame call."""

    R: torch.Tensor          # [3, 3] optimized Tcw rotation
    t: torch.Tensor          # [3]
    n_matches: torch.Tensor  # matches at the accepted search radius
    n_inliers: torch.Tensor
    binding: torch.Tensor    # [N] int32: row into the PASSED point arrays, -1 none
    inliers: torch.Tensor    # [N] bool (pose-BA chi2 classification)
    # Extraction outputs (the host builds its Frame from these):
    xy_und: torch.Tensor     # [N, 2] undistorted
    xy_raw: torch.Tensor     # [N, 2]
    response: torch.Tensor
    angle: torch.Tensor
    octave: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    depth: torch.Tensor      # [N] stereo depth (-1 mono / no match)
    ur: torch.Tensor         # [N] right-image u (-1 mono / no match)


def _fused_match_and_pose(
    feats, xy_und, ur, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
    R_pred, t_pred, config: SLAMConfig, tz_rel=0.0,
):
    """Shared tail of the fused motion-tracking stages: projective match
    against the last frame's points with the widen-on-failure retry
    (src/Tracking.cc:1090-1092), match inversion, pose-only BA (stereo rows
    use (u, v, ur) where ur >= 0, the mixed mono/stereo edges of
    src/Optimizer.cc:330-435).

    The JAX package decides the retry with lax.cond on the device; reading
    the first count on the host would stall it, so both searches run (at
    th and 2 th, from one projection and one K6 launch) and torch.where
    keeps the second when the first found fewer than 20 matches."""
    cam = config.camera
    th0 = float(config.tracker.search_radius_motion)
    m1, m2 = matchers.match_projection_last_frame(
        pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
        R_pred, t_pred,
        xy_und, feats.desc, feats.angle, feats.octave, feats.valid,
        cam.fx, cam.fy, cam.cx, cam.cy,
        float(cam.width), float(cam.height),
        th=(th0, 2.0 * th0),
        tz_rel=tz_rel,
        mono=config.sensor == "monocular",
        baseline=float(cam.baseline),
        n_levels=config.orb.n_levels,
        scale=config.orb.scale_factor,
    )
    idx = torch.where(torch.sum(m1.idx >= 0) >= 20, m1.idx, m2.idx)
    n_matches = torch.sum(idx >= 0)

    binding = bind_last_write(idx, feats.xy.shape[0])
    bound = binding >= 0
    pts_per_feat = pt_pos[torch.clamp_min(binding, 0).long()]
    obs = observations(xy_und, ur, feats.octave, bound & feats.valid, config)
    res = pose_opt.pose_optimization(
        R_pred, t_pred, pts_per_feat, obs,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
    )
    return res, binding, n_matches


def fused_motion_track(
    image: torch.Tensor,
    pt_pos: torch.Tensor,        # [M, 3] last frame's bound points (world)
    pt_desc: torch.Tensor,       # [M, 8] int32
    pt_octave: torch.Tensor,     # [M]
    pt_angle: torch.Tensor,      # [M]
    pt_valid: torch.Tensor,      # [M]
    R_pred: torch.Tensor,
    t_pred: torch.Tensor,
    config: SLAMConfig,
) -> FusedMotionResult:
    """The whole monocular motion-model tracking stage: extraction,
    undistortion, projective matching with the reference's
    widen-on-failure retry (fewer than 20 matches -> search again at twice
    the radius), match inversion and pose-only BA."""
    cam = config.camera
    feats = ext.extract_features(image, config.orb, cam.height, cam.width)
    xy_und = cam_ops.undistort_pixels(feats.xy, cam)
    no_ur = torch.full_like(xy_und[:, 0], -1.0)

    res, binding, n_matches = _fused_match_and_pose(
        feats, xy_und, no_ur, pt_pos, pt_desc, pt_octave, pt_angle,
        pt_valid, R_pred, t_pred, config,
    )
    return _motion_result(res, binding, n_matches, feats, xy_und, no_ur, no_ur)


def _motion_result(res, binding, n_matches, feats, xy_und, depth, ur):
    return FusedMotionResult(
        R=res.R, t=res.t, n_matches=n_matches, n_inliers=res.n_inliers,
        binding=binding, inliers=res.inliers,
        xy_und=xy_und, xy_raw=feats.xy, response=feats.response,
        angle=feats.angle, octave=feats.octave, desc=feats.desc,
        valid=feats.valid, depth=depth, ur=ur,
    )


def fused_stereo_motion_track(
    image_l: torch.Tensor,
    image_r: torch.Tensor,
    pt_pos: torch.Tensor,
    pt_desc: torch.Tensor,
    pt_octave: torch.Tensor,
    pt_angle: torch.Tensor,
    pt_valid: torch.Tensor,
    R_pred: torch.Tensor,
    t_pred: torch.Tensor,
    tz_rel: torch.Tensor,
    config: SLAMConfig,
) -> FusedMotionResult:
    """Stereo counterpart of fused_motion_track: both extractions and the
    epipolar stereo matcher (ops/stereo.stereo_frontend; the reference's
    dual extraction threads + ComputeStereoMatches), projective last-frame
    matching with the stereo octave rule, and mixed mono/stereo pose BA.
    tz_rel: z of the current camera centre in the last frame's camera
    coordinates."""
    cam = config.camera
    feats, _, smatch = stereo_ops.stereo_frontend(
        image_l, image_r, config.orb, cam.height, cam.width,
        cam.bf, cam.baseline,
    )
    xy_und = cam_ops.undistort_pixels(feats.xy, cam)
    ur = torch.where(smatch.valid, smatch.u_right, -1.0)

    res, binding, n_matches = _fused_match_and_pose(
        feats, xy_und, ur, pt_pos, pt_desc, pt_octave, pt_angle,
        pt_valid, R_pred, t_pred, config, tz_rel=tz_rel,
    )
    depth = torch.where(smatch.valid, smatch.depth, -1.0)
    return _motion_result(res, binding, n_matches, feats, xy_und, depth, ur)


def fused_rgbd_motion_track(
    image: torch.Tensor,
    depth_image: torch.Tensor,   # [H, W] float32 raw depth map
    pt_pos: torch.Tensor,
    pt_desc: torch.Tensor,
    pt_octave: torch.Tensor,
    pt_angle: torch.Tensor,
    pt_valid: torch.Tensor,
    R_pred: torch.Tensor,
    t_pred: torch.Tensor,
    tz_rel: torch.Tensor,
    config: SLAMConfig,
) -> FusedMotionResult:
    """RGB-D counterpart of fused_motion_track: each keypoint's depth read
    from the depth map at its rounded raw position, and the virtual right
    coordinate ur = u - bf / z (reference Frame::ComputeStereoFromRGBD,
    src/Frame.cc:791-816), on the device."""
    cam = config.camera
    feats = ext.extract_features(image, config.orb, cam.height, cam.width)
    xy_und = cam_ops.undistort_pixels(feats.xy, cam)

    u = torch.clamp(torch.round(feats.xy[:, 0]), 0, cam.width - 1).long()
    v = torch.clamp(torch.round(feats.xy[:, 1]), 0, cam.height - 1).long()
    d = depth_image[v, u].to(xy_und.dtype)
    if cam.depth_map_factor not in (0.0, 1.0):
        # Raw units times the float32 reciprocal of the factor, as XLA
        # compiles the JAX package's d / factor and as the reference scales
        # the depth map (Tracking::GrabImageRGBD's convertTo by
        # 1 / DepthMapFactor).
        d = d * torch.full_like(d, float(np.float32(1.0 / cam.depth_map_factor)))
    has = d > 0
    depth = torch.where(has, d, -1.0)
    # bf / d rounded once, as in the JAX package (a Python number over a
    # tensor is reciprocal-then-multiply in PyTorch).
    bf_over_d = torch.full_like(d, cam.bf) / torch.where(has, d, 1.0)
    ur = torch.where(has, xy_und[:, 0] - bf_over_d, -1.0)

    res, binding, n_matches = _fused_match_and_pose(
        feats, xy_und, ur, pt_pos, pt_desc, pt_octave, pt_angle,
        pt_valid, R_pred, t_pred, config, tz_rel=tz_rel,
    )
    return _motion_result(res, binding, n_matches, feats, xy_und, depth, ur)


# Packed-transfer layout: the host packs the per-frame point inputs into
# one float32 matrix, the descriptor table and one meta vector, and the
# call returns one float32 feature matrix, one meta vector and the
# descriptor table (the JAX package's layout, jit_frontend.py:404-412).
#
# Input meta: R_pred(9) t_pred(3) tz_rel -> [13].
IN_META_LEN = 13
# Packed point columns: pos(3) octave angle valid -> [M, 6].
IN_PT_COLS = 6
# Output meta: R(9) t(3) n_matches n_inliers -> [14].
OUT_META_LEN = 14
# Packed feature columns (all exactly representable in float32):
# xy_und(2) xy_raw(2) response angle octave valid depth ur binding inlier
OUT_FEAT_COLS = 12


def _unpack_inputs(pt_f32, meta_f32):
    pt_f32 = pt_f32.to(torch.float32)
    meta_f32 = meta_f32.to(torch.float32)
    pt_pos = pt_f32[:, 0:3]
    pt_octave = pt_f32[:, 3].to(torch.int32)
    pt_angle = pt_f32[:, 4]
    pt_valid = pt_f32[:, 5] > 0.5
    R_pred = meta_f32[0:9].reshape(3, 3)
    t_pred = meta_f32[9:12]
    tz_rel = meta_f32[12]
    return pt_pos, pt_octave, pt_angle, pt_valid, R_pred, t_pred, tz_rel


def _pack_result(res: FusedMotionResult):
    f32 = torch.float32
    meta = torch.cat([
        res.R.reshape(-1).to(f32), res.t.to(f32),
        res.n_matches.to(f32)[None], res.n_inliers.to(f32)[None],
    ])
    feat = torch.stack([
        res.xy_und[:, 0], res.xy_und[:, 1],
        res.xy_raw[:, 0], res.xy_raw[:, 1],
        res.response.to(f32), res.angle.to(f32),
        res.octave.to(f32), res.valid.to(f32),
        res.depth.to(f32), res.ur.to(f32),
        res.binding.to(f32), res.inliers.to(f32),
    ], dim=1)
    return meta, feat, res.desc


def fused_motion_track_packed(image, pt_f32, pt_desc, meta_f32, config: SLAMConfig):
    """fused_motion_track on the packed layout (the twin of
    fused_motion_track_packed_jit): image [H, W], pt_f32 [M, 6],
    pt_desc [M, 8] int32, meta_f32 [13] -> (meta [14], feat [N, 12],
    desc [N, 8] int32)."""
    pt_pos, pt_octave, pt_angle, pt_valid, R_pred, t_pred, _ = (
        _unpack_inputs(pt_f32, meta_f32))
    return _pack_result(fused_motion_track(
        image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
        R_pred, t_pred, config))


def fused_stereo_motion_track_packed(image_l, image_r, pt_f32, pt_desc, meta_f32,
                                     config: SLAMConfig):
    """fused_stereo_motion_track on the packed layout (the twin of
    fused_stereo_motion_track_packed_jit); tz_rel is meta_f32[12]."""
    pt_pos, pt_octave, pt_angle, pt_valid, R_pred, t_pred, tz_rel = (
        _unpack_inputs(pt_f32, meta_f32))
    return _pack_result(fused_stereo_motion_track(
        image_l, image_r, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
        R_pred, t_pred, tz_rel, config))


def fused_rgbd_motion_track_packed(image, depth_image, pt_f32, pt_desc, meta_f32,
                                   config: SLAMConfig):
    """fused_rgbd_motion_track on the packed layout (the twin of
    fused_rgbd_motion_track_packed_jit); tz_rel is meta_f32[12]."""
    pt_pos, pt_octave, pt_angle, pt_valid, R_pred, t_pred, tz_rel = (
        _unpack_inputs(pt_f32, meta_f32))
    return _pack_result(fused_rgbd_motion_track(
        image, depth_image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
        R_pred, t_pred, tz_rel, config))


# Fused local-map tracking: frustum check -> projection matching -> pose
# BA, on the motion stage's packed features.
#
# Candidate columns: pos(3) normal(3) dmin dmax valid -> [M, 9].
LM_CAND_COLS = 9
# Per-feature state: bound-point pos(3) has_bound -> [N, 4].
LM_FEAT_COLS = 4
# Input meta: R(9) t(3) th -> [13]; output meta: R(9) t(3) n_in -> [13].
LM_META_LEN = 13


def fused_local_map_track(
    feat_dev,        # [N, OUT_FEAT_COLS] packed features of the motion stage
    desc_dev,        # [N, 8] int32
    feat_state,      # [N, LM_FEAT_COLS] float32: current binding state
    cand_f32,        # [M, LM_CAND_COLS] float32 candidate map points
    cand_desc,       # [M, 8] int32
    meta_f32,        # [LM_META_LEN]
    config: SLAMConfig,
):
    """TrackLocalMap's device part (src/Tracking.cc:1137-1202:
    SearchLocalPoints' frustum gates, SearchByProjection and the final
    PoseOptimization), the twin of fused_local_map_track_jit. Returns
    (meta_out [13] float32, perfeat [N, 2] float32: candidate-row binding
    (-1 none) and inlier flag, visible [M] float32). The search radius th
    arrives in the meta vector, as a tensor."""
    cam = config.camera
    f32 = torch.float32
    feat_dev = feat_dev.to(f32)
    feat_state = feat_state.to(f32)
    cand_f32 = cand_f32.to(f32)
    meta_f32 = meta_f32.to(f32)
    xy_und = feat_dev[:, 0:2]
    octave = feat_dev[:, 6].to(torch.int32)
    f_valid = feat_dev[:, 7] > 0.5
    ur = feat_dev[:, 9]
    bound_pos = feat_state[:, 0:3]
    has_bound = feat_state[:, 3] > 0.5

    R0 = meta_f32[0:9].reshape(3, 3)
    t0 = meta_f32[9:12]
    th = meta_f32[12]

    info = matchers.frustum_check(
        cand_f32[:, 0:3], cand_f32[:, 3:6], cand_f32[:, 6], cand_f32[:, 7],
        cand_f32[:, 8] > 0.5, R0, t0,
        cam.fx, cam.fy, cam.cx, cam.cy,
        float(cam.width), float(cam.height),
        n_levels=config.orb.n_levels, scale=config.orb.scale_factor,
    )
    m = matchers.match_local_map(
        info, cand_desc, xy_und, desc_dev, octave, f_valid,
        has_bound, th=th,
        n_levels=config.orb.n_levels, scale=config.orb.scale_factor,
    )
    binding = bind_last_write(m.idx, xy_und.shape[0])
    new = binding >= 0
    pos = torch.where(
        new[:, None], cand_f32[torch.clamp_min(binding, 0).long(), 0:3], bound_pos)
    obs = observations(xy_und, ur, octave, (new | has_bound) & f_valid, config)
    res = pose_opt.pose_optimization(
        R0, t0, pos, obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
    )
    meta_out = torch.cat([
        res.R.reshape(-1).to(f32), res.t.to(f32), res.n_inliers.to(f32)[None],
    ])
    perfeat = torch.stack([binding.to(f32), res.inliers.to(f32)], dim=1)
    return meta_out, perfeat, info.visible.to(f32)


# ---------------------------------------------------------------------------
# The single-dispatch forms (the JAX package's *_jit): one CUDA graph replay
# a call on the card, the eager function on the CPU.
# ---------------------------------------------------------------------------

def _graphed(fn, args, config: SLAMConfig):
    """fn(*args, config) through utils/cuda_graph.call, the extraction
    routes in its key."""
    return cuda_graph.call(fn, args, config, static=ext.routes())


def tracking_forward_step_jit(image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
                              R_pred, t_pred, config: SLAMConfig) -> TrackStepResult:
    return _graphed(tracking_forward_step, (
        image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R_pred, t_pred), config)


def fused_motion_track_jit(image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
                           R_pred, t_pred, config: SLAMConfig) -> FusedMotionResult:
    return _graphed(fused_motion_track, (
        image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R_pred, t_pred), config)


def fused_stereo_motion_track_jit(image_l, image_r, pt_pos, pt_desc, pt_octave, pt_angle,
                                  pt_valid, R_pred, t_pred, tz_rel,
                                  config: SLAMConfig) -> FusedMotionResult:
    return _graphed(fused_stereo_motion_track, (
        image_l, image_r, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R_pred, t_pred,
        tz_rel), config)


def fused_rgbd_motion_track_jit(image, depth_image, pt_pos, pt_desc, pt_octave, pt_angle,
                                pt_valid, R_pred, t_pred, tz_rel,
                                config: SLAMConfig) -> FusedMotionResult:
    return _graphed(fused_rgbd_motion_track, (
        image, depth_image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R_pred, t_pred,
        tz_rel), config)


def fused_motion_track_packed_jit(image, pt_f32, pt_desc, meta_f32, config: SLAMConfig):
    return _graphed(fused_motion_track_packed, (image, pt_f32, pt_desc, meta_f32), config)


def fused_stereo_motion_track_packed_jit(image_l, image_r, pt_f32, pt_desc, meta_f32,
                                         config: SLAMConfig):
    return _graphed(fused_stereo_motion_track_packed,
                    (image_l, image_r, pt_f32, pt_desc, meta_f32), config)


def fused_rgbd_motion_track_packed_jit(image, depth_image, pt_f32, pt_desc, meta_f32,
                                       config: SLAMConfig):
    return _graphed(fused_rgbd_motion_track_packed,
                    (image, depth_image, pt_f32, pt_desc, meta_f32), config)


def fused_local_map_track_jit(feat_dev, desc_dev, feat_state, cand_f32, cand_desc, meta_f32,
                              config: SLAMConfig):
    return _graphed(fused_local_map_track,
                    (feat_dev, desc_dev, feat_state, cand_f32, cand_desc, meta_f32), config)
