"""Tracker- and mapper-level matching (PyTorch port of slam/matchers.py):
a candidate set -> Hamming top-2 per row (K6 for projection windows, K7
under a candidate test, kernels/matching.py) -> best/ratio gating -> rotation
histogram -> duplicate resolution, over fixed-shape padded tensors.

The variants: motion-model and local-map projection matching (K6),
reference-keyframe brute force (K7 under validity flags), monocular
initialization's matcher (K7 under the level-0 flags and a window),
relocalization's brute force over a batch of candidate keyframes (K7, one
launch, the frame's descriptors shared), the mapper's triangulation
matcher under the epipolar band (K7, one launch over a batch of neighbour
pairs) and its fuse projection (K6, one launch over a batch of target
keyframes), and loop closing's SearchBySim3 projection (K6, one launch a
direction) and its brute force over the loop candidates (K7, one launch,
the keyframe's descriptors shared).

The staged tracker's matchers have single-dispatch forms (`*_jit`, each
with its eager function's arguments; the JAX package jits these
matchers themselves): `match_for_initialization_jit`,
`match_projection_last_frame_jit`, `match_brute_force_jit` and
`search_local_points_jit` (frustum_check and match_local_map in one
call). On CUDA tensors each is one replay of a CUDA graph
(utils/cuda_graph.py) captured at the first call for its key, which holds
the float arguments (the search radii, the camera constants); on CPU
tensors the same function runs eagerly. The fused tracker's and the
mapper's graphs call the eager matchers inside their own captures.

The loop closer's and the staged mapper's matchers have such forms too:
`match_brute_force_jit` over the loop candidates (batched, the candidate
count padded to a power of two), `search_by_sim3_jit` (both directions of
SearchBySim3 and their mutual check, two K6 launches), `match_fuse_jit`
(the loop's widening), `match_for_triangulation_jit` (one neighbour pair,
K7 under the epipolar band) and `search_fuse_jit` (frustum_check and
match_fuse, one K6 launch)."""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.kernels import matching as matching_kernel
from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.ops.matching import MatchResult, TH_HIGH, TH_LOW
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


def _projection_match(
    pt_desc, proj, radii, oct_lo, oct_hi, valid_a,
    xy, desc, octave, valid_b,
    max_dist, ratio=1.0, ratio_octave_rule=False,
) -> Tuple[MatchResult, ...]:
    """Window + octave-band projection matching through K6 (its plain
    version on the CPU), then the ratio gating, for each window of radii
    (one or two [M] radii; two come from one K6 launch) -> one MatchResult
    per window. Shared by the SearchByProjection family."""
    i32, f32 = torch.int32, torch.float32
    tops = matching_kernel.projection_hamming_top2(
        pt_desc.contiguous(), proj.to(f32).contiguous(),
        tuple(r.to(f32).contiguous() for r in radii), oct_lo.to(i32).contiguous(),
        oct_hi.to(i32).contiguous(), valid_a.contiguous(),
        desc.contiguous(), xy.to(f32).contiguous(),
        octave.to(i32).contiguous(), valid_b.contiguous(),
    )
    return tuple(matching.match_from_top2(
        *top, max_dist, ratio, octave_b=octave if ratio_octave_rule else None)
        for top in tops)


_scale_sigmas = device_table(
    lambda n_levels, scale: np.array([scale ** i for i in range(n_levels)],
                                     np.float32))


def _project(R, t, pt_pos, fx, fy, cx, cy):
    """World points [M, 3] -> (camera points [M, 3], pixels [M, 2]), with
    depth clamped to 1e-6 for the division."""
    pc = torch.einsum("ij,mj->mi", R, pt_pos) + t
    z = pc[:, 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = fx * pc[:, 0] * inv_z + cx
    v = fy * pc[:, 1] * inv_z + cy
    return pc, torch.stack([u, v], dim=-1)


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
    th=15.0,
    tz_rel=0.0,                 # z of the current camera centre in the LAST
                                # frame's coordinates (stereo/RGB-D only)
    mono: bool = True,
    baseline: float = 0.0,
    n_levels: int = 8,
    scale: float = 1.2,
) -> Union[MatchResult, Tuple[MatchResult, MatchResult]]:
    """Motion-model tracking: project the last frame's points with the
    predicted pose and search a window of th * sigma(octave) around each
    (SearchByProjection(Frame&, const Frame&, th, bMono),
    src/ORBmatcher.cc:1489-1646). Octaves [oct-1, oct+1] for mono; for
    stereo/RGB-D the forward/backward rule (:1522-1529, :1555-1570): a
    camera that moved forward by more than the baseline searches octaves
    >= the last one, backward <= it. th may be a float or a 0-d tensor,
    or a pair (th, th_wide): then both searches share the projection and
    one K6 launch, and each gives its own MatchResult (the motion stage's
    widen-on-failure retry)."""
    sigmas = _scale_sigmas(pt_pos.device, n_levels, scale)
    pc, proj = _project(R, t, pt_pos, fx, fy, cx, cy)
    z, u, v = pc[:, 2], proj[:, 0], proj[:, 1]
    in_img = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)

    if mono:
        oct_lo, oct_hi = pt_octave - 1, pt_octave + 1
    else:
        tz = torch.as_tensor(tz_rel, dtype=pc.dtype, device=pc.device)
        fwd, bwd = tz > baseline, -tz > baseline
        oct_lo = torch.where(fwd, pt_octave,
                             torch.where(bwd, torch.full_like(pt_octave, -127),
                                         pt_octave - 1))
        oct_hi = torch.where(fwd, torch.full_like(pt_octave, 127),
                             torch.where(bwd, pt_octave, pt_octave + 1))

    sigma = sigmas[torch.clamp(pt_octave, 0, sigmas.shape[0] - 1).long()]
    ths = th if isinstance(th, tuple) else (th,)
    found = tuple(
        matching.resolve_duplicate_targets(
            matching.rotation_consistency_filter(m, pt_angle, angle), desc.shape[0])
        for m in _projection_match(
            pt_desc, proj, tuple(th_i * sigma for th_i in ths), oct_lo, oct_hi,
            pt_valid & in_img, xy, desc, octave, valid, TH_HIGH))
    return found if isinstance(th, tuple) else found[0]


class FrustumInfo(NamedTuple):
    visible: torch.Tensor       # [M] passes all frustum gates
    proj: torch.Tensor          # [M, 2] pixel projection
    pred_octave: torch.Tensor   # [M] predicted pyramid level
    view_cos: torch.Tensor      # [M]


@full_float32
def frustum_check(
    pt_pos: torch.Tensor,       # [M, 3]
    pt_normal: torch.Tensor,    # [M, 3]
    pt_min_dist: torch.Tensor,  # [M]
    pt_max_dist: torch.Tensor,  # [M]
    pt_valid: torch.Tensor,     # [M]
    R: torch.Tensor, t: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    n_levels: int = 8, scale: float = 1.2,
) -> FrustumInfo:
    """Frame::isInFrustum (src/Frame.cc:315-378): image bounds, distance
    band [0.8 min, 1.2 max], viewing angle cos >= 0.5, predicted scale
    (MapPoint::PredictScale, src/MapPoint.cc:407-439)."""
    pc, proj = _project(R, t, pt_pos, fx, fy, cx, cy)
    z, u, v = pc[:, 2], proj[:, 0], proj[:, 1]

    center = -torch.einsum("ji,j->i", R, t)     # camera centre in world
    po = pt_pos - center[None]
    dist = torch.linalg.norm(po, dim=1)
    view_cos = torch.sum(po * pt_normal, dim=1) / torch.clamp_min(dist, 1e-9)

    # log of the float32 scale, in float32, as the JAX package takes it.
    log_scale = float(np.log(np.float32(scale)))
    ratio = pt_max_dist / torch.clamp_min(dist, 1e-9)
    pred = torch.ceil(torch.log(torch.clamp_min(ratio, 1e-9)) / log_scale)
    pred = torch.clamp(pred.to(torch.int32), 0, n_levels - 1)

    visible = (
        pt_valid
        & (z > 0)
        & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        & (dist >= 0.8 * pt_min_dist)
        & (dist <= 1.2 * pt_max_dist)
        & (view_cos >= 0.5)
    )
    return FrustumInfo(visible, proj, pred, view_cos)


def match_local_map(
    info: FrustumInfo,
    pt_desc: torch.Tensor,      # [M, 8] int32
    xy: torch.Tensor, desc: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    feat_taken: torch.Tensor,   # [N] features already bound by motion tracking
    th=1.0, ratio: float = 0.8,
    n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """Local-map point -> frame matching after frustum_check
    (SearchByProjection(Frame&, vector<MapPoint*>&, th),
    src/ORBmatcher.cc:46-142): radius = RadiusByViewingCos (2.5 if
    cos > 0.998 else 4.0) * th * sigma(predicted level), octaves
    [pred-1, pred], TH_HIGH, ratio 0.8 when best and second-best share an
    octave. th may be a float or a 0-d tensor."""
    sigmas = _scale_sigmas(pt_desc.device, n_levels, scale)
    base_r = torch.where(info.view_cos > 0.998, 2.5, 4.0).to(sigmas.dtype)
    radius = base_r * th * sigmas[info.pred_octave.long()]
    m = _projection_match(
        pt_desc, info.proj, (radius,),
        info.pred_octave - 1, info.pred_octave,
        info.visible, xy, desc, octave, valid & ~feat_taken,
        TH_HIGH, ratio, ratio_octave_rule=True,
    )[0]
    return matching.resolve_duplicate_targets(m, desc.shape[0])


def match_brute_force(
    desc_a: torch.Tensor, angle_a: torch.Tensor, valid_a: torch.Tensor,
    desc_b: torch.Tensor, angle_b: torch.Tensor, valid_b: torch.Tensor,
    max_dist: int = TH_LOW, ratio: float = 0.7,
) -> MatchResult:
    """Whole-frame descriptor matching with ratio + rotation checks: the
    stand-in for SearchByBoW (src/ORBmatcher.cc:175-325) with its gates
    (TH_LOW, ratio 0.7, rotation histogram, one-to-one) over every valid
    pair, a superset of the BoW node buckets. K7 over the pairs of valid
    features, the flags tested in the kernel on the card. Used for
    reference-keyframe tracking.

    Side A may carry a leading axis of C candidate keyframes ([C, N_a, ...])
    against one shared frame (side B, [N_b, ...]): relocalization's matcher,
    the stand-in for its per-candidate SearchByBoW (src/Tracking.cc:1713-1762).
    The C problems go through one K7 launch that reads the frame's
    descriptor table once for all of them; idx, dist come out [C, N_a].
    Or side B carries the candidate axis ([C, N_b, ...]) against one
    shared keyframe (side A, [N_a, ...]): loop closing's matcher over its
    candidates (ComputeSim3's SearchByBoW, src/LoopClosing.cc:313-327), in
    one launch that reads the keyframe's table once; idx, dist come out
    [C, N_a]."""
    m = matching.match_from_top2(
        *matching_kernel.valid_hamming_top2(
            desc_a.contiguous(), desc_b.contiguous(), valid_a.contiguous(),
            valid_b.contiguous()),
        max_dist, ratio)
    m = matching.rotation_consistency_filter(m, angle_a, angle_b)
    return matching.resolve_duplicate_targets(m, desc_b.shape[-2])


def match_by_sim3(
    pt_cam: torch.Tensor,       # [M, 3] points already in the TARGET camera frame
    pt_desc: torch.Tensor,      # [M, 8] int32
    pt_min_dist: torch.Tensor,  # [M]
    pt_max_dist: torch.Tensor,  # [M]
    pt_valid: torch.Tensor,     # [M]
    xy: torch.Tensor, desc: torch.Tensor, octave: torch.Tensor, valid: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    th: float = 7.5, n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """One direction of SearchBySim3 (src/ORBmatcher.cc:1238-1487): points
    already moved through the candidate Sim3 into the target camera, gated
    by depth > 0, the image bounds and the scale-invariance band [0.8 min,
    1.2 max] (:1311-1330); a window of th x sigma(predicted level) over
    octaves [pred-1, pred+1] at TH_HIGH with no ratio test (:1342-1365),
    through K6. The caller runs both directions and keeps the mutually
    consistent pairs (:1442-1455)."""
    z = pt_cam[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = fx * pt_cam[:, 0] * inv_z + cx
    v = fy * pt_cam[:, 1] * inv_z + cy
    dist = torch.linalg.norm(pt_cam, dim=1)
    log_scale = float(np.log(np.float32(scale)))
    ratio_d = pt_max_dist / torch.clamp_min(dist, 1e-9)
    pred = torch.ceil(torch.log(torch.clamp_min(ratio_d, 1e-9)) / log_scale).to(torch.int32)
    pred = torch.clamp(pred, 0, n_levels - 1)
    ok = (pt_valid & (z > 0.0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
          & (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist))
    radius = th * _scale_sigmas(pt_cam.device, n_levels, scale)[pred.long()]
    return _projection_match(pt_desc, torch.stack([u, v], dim=-1), (radius,), pred - 1,
                             pred + 1, ok, xy, desc, octave, valid, TH_HIGH)[0]


@full_float32
def match_for_initialization(
    xy1: torch.Tensor, desc1: torch.Tensor, angle1: torch.Tensor,
    octave1: torch.Tensor, valid1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, angle2: torch.Tensor,
    octave2: torch.Tensor, valid2: torch.Tensor,
    window: float = 100.0, ratio: float = 0.9,
) -> MatchResult:
    """Frame-1 -> frame-2 matches for the monocular bootstrap
    (SearchForInitialization, src/ORBmatcher.cc:442-587): level-0 features
    only, a 100 px window, TH_LOW, best/second ratio 0.9, the rotation
    histogram, one-to-one. K7 under the level-0 flags and the window, both
    tested in the kernel on the card."""
    m = matching.match_from_top2(
        *matching_kernel.window_hamming_top2(
            desc1.contiguous(), desc2.contiguous(), valid1 & (octave1 == 0),
            valid2 & (octave2 == 0), xy1.contiguous(), xy2.contiguous(), window),
        TH_LOW, ratio)
    m = matching.rotation_consistency_filter(m, angle1, angle2)
    return matching.resolve_duplicate_targets(m, desc2.shape[0])


@full_float32
def triangulation_mask(
    xy1, free1, xy2, free2, F12, octave2, epipole2, min_epipole_dist2,
    n_levels: int = 8, scale: float = 1.2,
) -> torch.Tensor:
    """SearchForTriangulation's candidate pairs (src/ORBmatcher.cc:738-911)
    as a [..., N1, N2] mask: both features free (no bound map point), the
    image-2 feature at least sqrt(min_epipole_dist2) px from the epipole
    (:831-838) and inside the epipolar band of the image-1 feature
    (CheckDistEpipolarLine). Leading batch dimensions broadcast: xy2
    [..., N2, 2], F12 [..., 3, 3], epipole2 [..., 2]."""
    sig2, far_from_epipole = _triangulation_terms(xy2, octave2, epipole2, min_epipole_dist2,
                                                  n_levels, scale)
    return (
        free1[..., :, None]
        & (free2 & far_from_epipole)[..., None, :]
        & matching.epipolar_mask(xy1, xy2, F12, sig2)
    )


def _triangulation_terms(xy2, octave2, epipole2, min_epipole_dist2, n_levels, scale):
    """-> (sigma^2 of each image-2 feature's octave, whether it lies at
    least sqrt(min_epipole_dist2) px from the epipole), [..., N2] each."""
    sigmas2 = _scale_sigmas(xy2.device, n_levels, scale) ** 2
    sig2 = sigmas2[torch.clamp(octave2, 0, sigmas2.shape[0] - 1).long()]
    de = xy2 - epipole2[..., None, :]
    return sig2, torch.sum(de * de, dim=-1) >= min_epipole_dist2


def match_for_triangulation(
    xy1: torch.Tensor, desc1: torch.Tensor, angle1: torch.Tensor,
    free1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, angle2: torch.Tensor,
    free2: torch.Tensor,
    F12: torch.Tensor,
    octave2: torch.Tensor,
    epipole2: torch.Tensor,          # [2] projection of camera 1's centre in image 2
    min_epipole_dist2,               # min squared px distance to the epipole
    n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """KF1 -> KF2 matches for new-point triangulation (SearchForTriangulation,
    src/ORBmatcher.cc:738-911): free features only, the epipolar band,
    epipole proximity rejection, TH_LOW, rotation histogram. K7 under the
    epipolar band, the pairs of `triangulation_mask`, tested in the kernel
    on the card. One keyframe against B neighbours: the neighbour side
    (xy2, desc2, angle2, free2, octave2 [B, N2, ...], F12 [B, 3, 3],
    epipole2 [B, 2]) and free1 ([B, N1]) take a leading batch axis, and
    idx, dist come out [B, N1]; the B problems go through one K7 launch."""
    sig2, far_from_epipole = _triangulation_terms(xy2, octave2, epipole2, min_epipole_dist2,
                                                  n_levels, scale)
    top2 = matching_kernel.epipolar_hamming_top2(
        desc1.contiguous(), desc2.contiguous(), free1.contiguous(),
        (free2 & far_from_epipole).contiguous(), xy1.contiguous(), xy2.contiguous(),
        F12.contiguous(), sig2.contiguous())
    m = matching.match_from_top2(*top2, TH_LOW)
    m = matching.rotation_consistency_filter(m, angle1, angle2)
    return matching.resolve_duplicate_targets(m, desc2.shape[-2])


def match_fuse(
    info: FrustumInfo,
    pt_desc: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    th: float = 3.0,
    n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """Project map points into a keyframe for duplicate fusion
    (ORBmatcher::Fuse, src/ORBmatcher.cc:918-1092): radius = th *
    sigma(predicted level), octaves [pred-1, pred+1], TH_LOW, through K6.
    The host decides merge vs bind per returned match (:1061-1082). One
    point set into B target keyframes: info and the target side (xy, desc,
    octave, valid) take a leading batch axis, pt_desc [P, 8] stays shared,
    and idx, dist come out [B, P]; the B problems go through one K6
    launch."""
    sigmas = _scale_sigmas(pt_desc.device, n_levels, scale)
    radius = th * sigmas[info.pred_octave.long()]
    m = _projection_match(
        pt_desc, info.proj, (radius,), info.pred_octave - 1, info.pred_octave + 1,
        info.visible, xy, desc, octave, valid, TH_LOW)[0]
    return matching.resolve_duplicate_targets(m, desc.shape[-2])


def search_local_points(
    pt_pos: torch.Tensor, pt_normal: torch.Tensor, pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor, pt_valid: torch.Tensor,
    R: torch.Tensor, t: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    pt_desc: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    feat_taken: torch.Tensor,
    th=1.0, ratio: float = 0.8,
    n_levels: int = 8, scale: float = 1.2,
) -> Tuple[FrustumInfo, MatchResult]:
    """frustum_check, then match_local_map on its result (Tracking::
    SearchLocalPoints, src/Tracking.cc:1403-1468) -> (FrustumInfo,
    MatchResult)."""
    info = frustum_check(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t,
                         fx, fy, cx, cy, width, height, n_levels=n_levels, scale=scale)
    return info, match_local_map(info, pt_desc, xy, desc, octave, valid, feat_taken,
                                 th=th, ratio=ratio, n_levels=n_levels, scale=scale)


# Each form's graph runs its matcher on the form's tensor arguments, the
# other arguments in the key.

def _init_match(xy1, desc1, angle1, octave1, valid1, xy2, desc2, angle2, octave2, valid2,
                key):
    window, ratio = key
    return match_for_initialization(xy1, desc1, angle1, octave1, valid1, xy2, desc2, angle2,
                                    octave2, valid2, window=window, ratio=ratio)


@full_float32
def match_for_initialization_jit(
    xy1: torch.Tensor, desc1: torch.Tensor, angle1: torch.Tensor,
    octave1: torch.Tensor, valid1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, angle2: torch.Tensor,
    octave2: torch.Tensor, valid2: torch.Tensor,
    window: float = 100.0, ratio: float = 0.9,
) -> MatchResult:
    """match_for_initialization: one replay (K7 under the window) on the
    card, eagerly on the CPU."""
    return cuda_graph.call(_init_match, (xy1, desc1, angle1, octave1, valid1, xy2, desc2,
                                         angle2, octave2, valid2), (window, ratio))


def _last_frame_match(pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t, xy, desc, angle,
                      octave, valid, tz_rel, key):
    fx, fy, cx, cy, width, height, th, mono, baseline, n_levels, scale = key
    return match_projection_last_frame(
        pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t, xy, desc, angle, octave, valid,
        fx, fy, cx, cy, width, height, th=th, tz_rel=tz_rel, mono=mono, baseline=baseline,
        n_levels=n_levels, scale=scale)


@full_float32
def match_projection_last_frame_jit(
    pt_pos: torch.Tensor, pt_desc: torch.Tensor, pt_octave: torch.Tensor,
    pt_angle: torch.Tensor, pt_valid: torch.Tensor,
    R: torch.Tensor, t: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor, angle: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    th=15.0,
    tz_rel=0.0,
    mono: bool = True,
    baseline: float = 0.0,
    n_levels: int = 8,
    scale: float = 1.2,
) -> Union[MatchResult, Tuple[MatchResult, MatchResult]]:
    """match_projection_last_frame: one replay (one K6 launch) on the
    card, eagerly on the CPU. th is a float or a pair of floats (part of
    the key); tz_rel, which changes every frame, goes in as a 0-d float32
    tensor, the value the eager function compares, made by a fill (a copy
    from the host would wait for the device)."""
    tz = torch.full((), float(tz_rel), dtype=torch.float32, device=pt_pos.device)
    return cuda_graph.call(
        _last_frame_match,
        (pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t, xy, desc, angle, octave, valid,
         tz),
        (fx, fy, cx, cy, width, height, th, mono, baseline, n_levels, scale))


def _brute_force(desc_a, angle_a, valid_a, desc_b, angle_b, valid_b, key):
    max_dist, ratio = key
    return match_brute_force(desc_a, angle_a, valid_a, desc_b, angle_b, valid_b,
                             max_dist=max_dist, ratio=ratio)


def match_brute_force_jit(
    desc_a: torch.Tensor, angle_a: torch.Tensor, valid_a: torch.Tensor,
    desc_b: torch.Tensor, angle_b: torch.Tensor, valid_b: torch.Tensor,
    max_dist: int = TH_LOW, ratio: float = 0.7,
) -> MatchResult:
    """match_brute_force: one replay (K7 under the flags, batched over the
    candidates in relocalization) on the card, eagerly on the CPU."""
    return cuda_graph.call(_brute_force, (desc_a, angle_a, valid_a, desc_b, angle_b, valid_b),
                           (max_dist, ratio))


def _local_points(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t, pt_desc, xy,
                  desc, octave, valid, feat_taken, key):
    fx, fy, cx, cy, width, height, th, ratio, n_levels, scale = key
    return search_local_points(
        pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t, fx, fy, cx, cy, width,
        height, pt_desc, xy, desc, octave, valid, feat_taken, th=th, ratio=ratio,
        n_levels=n_levels, scale=scale)


@full_float32
def search_local_points_jit(
    pt_pos: torch.Tensor, pt_normal: torch.Tensor, pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor, pt_valid: torch.Tensor,
    R: torch.Tensor, t: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    pt_desc: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    feat_taken: torch.Tensor,
    th=1.0, ratio: float = 0.8,
    n_levels: int = 8, scale: float = 1.2,
) -> Tuple[FrustumInfo, MatchResult]:
    """search_local_points: one replay (one K6 launch) on the card,
    eagerly on the CPU. th is a float (part of the key)."""
    return cuda_graph.call(
        _local_points,
        (pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t, pt_desc, xy, desc,
         octave, valid, feat_taken),
        (fx, fy, cx, cy, width, height, th, ratio, n_levels, scale))


def search_by_sim3(
    pc1: torch.Tensor, pt_desc1: torch.Tensor, pt_min_dist1: torch.Tensor,
    pt_max_dist1: torch.Tensor, pt_valid1: torch.Tensor,
    pc2: torch.Tensor, pt_desc2: torch.Tensor, pt_min_dist2: torch.Tensor,
    pt_max_dist2: torch.Tensor, pt_valid2: torch.Tensor,
    xy1: torch.Tensor, desc1: torch.Tensor, octave1: torch.Tensor, valid1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, octave2: torch.Tensor, valid2: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    th: float = 7.5, n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """Both directions of SearchBySim3 and their mutual check
    (src/ORBmatcher.cc:1238-1487): keyframe 1's points (a row per feature
    of keyframe 1) already in camera 2 (pc1) matched into keyframe 2's
    features, keyframe 2's points already in camera 1 (pc2) into keyframe
    1's, each by match_by_sim3 -> keyframe 1's features' matches in
    keyframe 2 that point back (:1442-1455), idx [N1]."""
    common = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height, th=th,
                  n_levels=n_levels, scale=scale)
    best_in_1 = match_by_sim3(pc2, pt_desc2, pt_min_dist2, pt_max_dist2, pt_valid2,
                              xy1, desc1, octave1, valid1, **common)
    best_in_2 = match_by_sim3(pc1, pt_desc1, pt_min_dist1, pt_max_dist1, pt_valid1,
                              xy2, desc2, octave2, valid2, **common)
    return matching.mutual_consistency(best_in_2, best_in_1)


def search_fuse(
    pt_pos: torch.Tensor, pt_normal: torch.Tensor, pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor, pt_valid: torch.Tensor,
    R: torch.Tensor, t: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    pt_desc: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    th: float = 3.0,
    n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """frustum_check, then match_fuse on its result: one point set fused
    into one keyframe (ORBmatcher::Fuse, src/ORBmatcher.cc:918-1092, as
    SearchInNeighbors calls it, src/LocalMapping.cc:560-664)."""
    info = frustum_check(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t,
                         fx, fy, cx, cy, width, height, n_levels=n_levels, scale=scale)
    return match_fuse(info, pt_desc, xy, desc, octave, valid, th=th, n_levels=n_levels,
                      scale=scale)


def _sim3_search(pc1, pt_desc1, pt_min_dist1, pt_max_dist1, pt_valid1, pc2, pt_desc2,
                 pt_min_dist2, pt_max_dist2, pt_valid2, xy1, desc1, octave1, valid1, xy2, desc2,
                 octave2, valid2, key):
    fx, fy, cx, cy, width, height, th, n_levels, scale = key
    return search_by_sim3(pc1, pt_desc1, pt_min_dist1, pt_max_dist1, pt_valid1, pc2, pt_desc2,
                          pt_min_dist2, pt_max_dist2, pt_valid2, xy1, desc1, octave1, valid1,
                          xy2, desc2, octave2, valid2, fx, fy, cx, cy, width, height, th=th,
                          n_levels=n_levels, scale=scale)


def search_by_sim3_jit(
    pc1: torch.Tensor, pt_desc1: torch.Tensor, pt_min_dist1: torch.Tensor,
    pt_max_dist1: torch.Tensor, pt_valid1: torch.Tensor,
    pc2: torch.Tensor, pt_desc2: torch.Tensor, pt_min_dist2: torch.Tensor,
    pt_max_dist2: torch.Tensor, pt_valid2: torch.Tensor,
    xy1: torch.Tensor, desc1: torch.Tensor, octave1: torch.Tensor, valid1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, octave2: torch.Tensor, valid2: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    th: float = 7.5, n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """search_by_sim3: one replay (two K6 launches) on the card, eagerly
    on the CPU."""
    return cuda_graph.call(
        _sim3_search,
        (pc1, pt_desc1, pt_min_dist1, pt_max_dist1, pt_valid1, pc2, pt_desc2, pt_min_dist2,
         pt_max_dist2, pt_valid2, xy1, desc1, octave1, valid1, xy2, desc2, octave2, valid2),
        (fx, fy, cx, cy, width, height, th, n_levels, scale))


def _fuse(info, pt_desc, xy, desc, octave, valid, key):
    th, n_levels, scale = key
    return match_fuse(info, pt_desc, xy, desc, octave, valid, th=th, n_levels=n_levels,
                      scale=scale)


def match_fuse_jit(
    info: FrustumInfo,
    pt_desc: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    th: float = 3.0,
    n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """match_fuse: one replay (one K6 launch) on the card, eagerly on the
    CPU."""
    return cuda_graph.call(_fuse, (info, pt_desc, xy, desc, octave, valid),
                           (th, n_levels, scale))


def _triangulation(xy1, desc1, angle1, free1, xy2, desc2, angle2, free2, F12, octave2,
                   epipole2, min_epipole_dist2, key):
    n_levels, scale = key
    return match_for_triangulation(xy1, desc1, angle1, free1, xy2, desc2, angle2, free2, F12,
                                   octave2, epipole2, min_epipole_dist2, n_levels=n_levels,
                                   scale=scale)


def match_for_triangulation_jit(
    xy1: torch.Tensor, desc1: torch.Tensor, angle1: torch.Tensor,
    free1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, angle2: torch.Tensor,
    free2: torch.Tensor,
    F12: torch.Tensor,
    octave2: torch.Tensor,
    epipole2: torch.Tensor,
    min_epipole_dist2,
    n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """match_for_triangulation: one replay (K7 under the epipolar band) on
    the card, eagerly on the CPU. min_epipole_dist2 is a tensor (an input)
    or a float (part of the key)."""
    return cuda_graph.call(_triangulation, (xy1, desc1, angle1, free1, xy2, desc2, angle2,
                                            free2, F12, octave2, epipole2, min_epipole_dist2),
                           (n_levels, scale))


def _search_fuse(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t, pt_desc, xy,
                 desc, octave, valid, key):
    fx, fy, cx, cy, width, height, th, n_levels, scale = key
    return search_fuse(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t, fx, fy,
                       cx, cy, width, height, pt_desc, xy, desc, octave, valid, th=th,
                       n_levels=n_levels, scale=scale)


def search_fuse_jit(
    pt_pos: torch.Tensor, pt_normal: torch.Tensor, pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor, pt_valid: torch.Tensor,
    R: torch.Tensor, t: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    width: float, height: float,
    pt_desc: torch.Tensor,
    xy: torch.Tensor, desc: torch.Tensor,
    octave: torch.Tensor, valid: torch.Tensor,
    th: float = 3.0,
    n_levels: int = 8, scale: float = 1.2,
) -> MatchResult:
    """search_fuse: one replay (one K6 launch) on the card, eagerly on the
    CPU."""
    return cuda_graph.call(
        _search_fuse,
        (pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, R, t, pt_desc, xy, desc,
         octave, valid),
        (fx, fy, cx, cy, width, height, th, n_levels, scale))


# The functions the matchers' single-dispatch forms capture
# (cuda_graph.release's owners).
GRAPHED = (_init_match, _last_frame_match, _brute_force, _local_points, _sim3_search, _fuse,
           _triangulation, _search_fuse)
