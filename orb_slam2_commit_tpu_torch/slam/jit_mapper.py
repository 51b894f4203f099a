"""Batched device functions of the local-mapping stage (PyTorch port of
slam/jit_mapper.py).

One call each serves the whole neighbour loop of a keyframe, with packed
inputs and outputs in the JAX package's layouts:

- `fused_triangulation`: CreateNewMapPoints' per-neighbour loop
  (src/LocalMapping.cc:281-558): the triangulation matcher over B
  neighbour pairs (one K7 launch under the epipolar band),
  DLT triangulation and the in-graph gates;
- `fused_fuse_forward`: SearchInNeighbors' forward fuse pass
  (src/LocalMapping.cc:560-664): this keyframe's points projected into B
  target keyframes (one K6 launch over the B problems).

The host keeps the sequential claim semantics (a feature triangulated with
an earlier neighbour is not claimed again by a later one) by replaying the
batched results in neighbour order. Both run in float32 on the device of
their inputs and never wait for it.

Each has a single-dispatch form, named as the JAX package's jitted one
(`*_jit`, the same arguments in the same order): on the card replays of
CUDA graphs captured at the first call for their key (utils/cuda_graph.py;
the callers pad B and the point count to JAX's buckets, so a System run
captures a few): one for the fuse, two for the triangulation, whose DLT
eigensolve (torch.linalg.eigh, which reads its status on the host) runs
between them; on CPU tensors the eager function. The local mapper calls
the `*_jit` forms.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.geometry import triangulation as tri
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.slam import matchers
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

# kf/neighbor feature columns: xy(2) angle octave free -> [N, 5].
TRI_FEAT_COLS = 5
# Per-pair columns: F12(9) ep(2) P2(12) R2row2(3) t2z c2(3) valid -> [B, 31].
TRI_PAIR_COLS = 31
# Global meta: P1 flat(12) c1(3) cos_gate ratio_factor -> [17].
TRI_META_LEN = 17

_scale_factors = device_table(
    lambda orb: np.asarray(orb.scale_factors(), np.float32))
_level_sigma2 = device_table(
    lambda orb: np.asarray(orb.level_sigma2(), np.float32))


def _pack_feats(xy, angle, octave, free):
    out = np.zeros((xy.shape[0], TRI_FEAT_COLS), np.float32)
    out[:, 0:2] = xy
    out[:, 2] = angle
    out[:, 3] = octave
    out[:, 4] = free
    return out


@full_float32
def fused_triangulation(
    kf_f32,       # [N, TRI_FEAT_COLS]
    kf_desc,      # [N, 8] int32
    nb_f32,       # [B, N, TRI_FEAT_COLS]
    nb_desc,      # [B, N, 8] int32
    pair_f32,     # [B, TRI_PAIR_COLS]
    meta_f32,     # [TRI_META_LEN]
    config: SLAMConfig,
):
    """All neighbour pairs of CreateNewMapPoints in one call -> (pts
    [B, N, 3] float32 triangulated world points per keyframe-feature row,
    flags [B, N, 2] float32: the gate mask and the matched neighbour
    feature index, -1 where unmatched): triangulation_match, the DLT
    eigensolve, triangulation_gates."""
    args = (kf_f32, kf_desc, nb_f32, nb_desc, pair_f32, meta_f32)
    idx, uv2, normal = triangulation_match(*args, config)
    _, V = linalg.eigh(normal)
    return triangulation_gates(idx, uv2, V, *args, config)


def _tri_inputs(kf_f32, nb_f32, pair_f32, meta_f32):
    f32 = torch.float32
    kf_f32, nb_f32 = kf_f32.to(f32), nb_f32.to(f32)
    pair_f32, meta_f32 = pair_f32.to(f32), meta_f32.to(f32)
    bsz = nb_f32.shape[0]
    return (kf_f32, nb_f32, meta_f32[0:12].reshape(3, 4),
            pair_f32[:, 11:23].reshape(bsz, 3, 4), pair_f32, meta_f32)


def triangulation_match(kf_f32, kf_desc, nb_f32, nb_desc, pair_f32, meta_f32,
                        config: SLAMConfig):
    """The triangulation matcher over the B neighbour pairs (one K7 launch
    under the epipolar band) -> (idx [B, N] the matched neighbour feature
    per keyframe feature, -1 none; its position uv2 [B, N, 2]; the DLT's
    A^T A [B, N, 4, 4])."""
    kf_f32, nb_f32, P1, P2, pair_f32, _ = _tri_inputs(kf_f32, nb_f32, pair_f32, meta_f32)
    bsz = nb_f32.shape[0]
    xy1 = kf_f32[:, 0:2]
    pair_valid = pair_f32[:, 30] > 0.5
    xy2 = nb_f32[:, :, 0:2]
    m = matchers.match_for_triangulation(
        xy1, kf_desc, kf_f32[:, 2], (kf_f32[:, 4] > 0.5)[None, :] & pair_valid[:, None],
        xy2, nb_desc, nb_f32[:, :, 2], nb_f32[:, :, 4] > 0.5,
        pair_f32[:, 0:9].reshape(bsz, 3, 3), nb_f32[:, :, 3].to(torch.int32),
        pair_f32[:, 9:11], kf_f32.new_full((), 100.0),
        n_levels=config.orb.n_levels, scale=config.orb.scale_factor,
    )
    safe = torch.clamp_min(m.idx, 0).long()
    uv2 = torch.gather(xy2, 1, safe[..., None].expand(-1, -1, 2))
    return m.idx, uv2, tri.dlt_normal_matrices(xy1.expand(bsz, -1, -1), uv2,
                                               P1.expand(bsz, -1, -1), P2)


def triangulation_gates(idx, uv2, V, kf_f32, kf_desc, nb_f32, nb_desc, pair_f32, meta_f32,
                        config: SLAMConfig):
    """The points from the DLT's eigenvectors V [B, N, 4, 4] and the
    gates (reference :388-535: parallax, cheirality, reprojection, scale
    consistency) -> fused_triangulation's (pts, flags)."""
    f32 = torch.float32
    kf_f32, nb_f32, P1, P2, pair_f32, meta_f32 = _tri_inputs(kf_f32, nb_f32, pair_f32,
                                                              meta_f32)
    dev = kf_f32.device
    xy1 = kf_f32[:, 0:2]
    octave1 = kf_f32[:, 3].to(torch.int32)
    c1 = meta_f32[12:15]
    cos_gate = meta_f32[15]
    ratio_factor = meta_f32[16]
    n_lv = config.orb.n_levels
    scale_factors = _scale_factors(dev, config.orb)
    sigma2 = _level_sigma2(dev, config.orb)
    octave2 = nb_f32[:, :, 3].to(torch.int32)
    R2z = pair_f32[:, 23:26]
    t2z = pair_f32[:, 26]
    c2 = pair_f32[:, 27:30]
    pair_valid = pair_f32[:, 30] > 0.5

    matched = idx >= 0
    safe = torch.clamp_min(idx, 0).long()
    pts = tri.dlt_points(V)
    r1 = pts - c1
    r2 = pts - c2[:, None, :]
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp_min(d1 * d2, 1e-12)
    # P1 = K [R1 | t1]: its third row is (R1 row 3, t1z), so depth in
    # camera 1 falls out of the projection matrix.
    z1 = pts @ P1[2, 0:3] + P1[2, 3]
    z2 = torch.einsum("bnj,bj->bn", pts, R2z) + t2z[:, None]
    e1 = tri.reprojection_error_sq(pts, xy1, P1)
    e2 = tri.reprojection_error_sq(pts, uv2, P2)
    o1c = torch.clamp(octave1, 0, n_lv - 1).long()
    o2c = torch.clamp(torch.gather(octave2, 1, safe), 0, n_lv - 1).long()
    ratio_dist = d2 / torch.clamp_min(d1, 1e-12)
    ratio_octave = scale_factors[o1c] / scale_factors[o2c]
    good = (
        matched
        & (cos_par > 0)
        & (cos_par < cos_gate)
        & (z1 > 0)
        & (z2 > 0)
        & (e1 < 5.991 * sigma2[o1c])
        & (e2 < 5.991 * sigma2[o2c])
        & (ratio_dist * ratio_factor >= ratio_octave)
        & (ratio_dist <= ratio_octave * ratio_factor)
        & torch.isfinite(pts).all(dim=-1)
        & pair_valid[:, None]
    )
    flags = torch.stack([good.to(f32), idx.to(f32)], dim=-1)
    return pts.to(f32), flags


# Point columns: pos(3) normal(3) dmin dmax valid -> [P, 9].
FUSE_PT_COLS = 9
# Target feature columns: xy(2) octave valid -> [B, N, 4].
FUSE_FEAT_COLS = 4
# Per-target meta: R(9) t(3) valid -> [B, 13].
FUSE_TGT_COLS = 13


def fused_fuse_forward(
    pt_f32,       # [P, FUSE_PT_COLS]
    pt_desc,      # [P, 8] int32
    tgt_feat,     # [B, N, FUSE_FEAT_COLS]
    tgt_desc,     # [B, N, 8] int32
    tgt_meta,     # [B, FUSE_TGT_COLS]
    config: SLAMConfig,
):
    """-> idx [B, P] float32: the target feature matched per point per
    target (-1 none). The frustum gates run per target; the B matching
    problems go through one K6 launch."""
    f32 = torch.float32
    pt_f32, tgt_feat, tgt_meta = pt_f32.to(f32), tgt_feat.to(f32), tgt_meta.to(f32)
    cam = config.camera
    pos = pt_f32[:, 0:3]
    normal = pt_f32[:, 3:6]
    dmin = pt_f32[:, 6]
    dmax = pt_f32[:, 7]
    pvalid = pt_f32[:, 8] > 0.5

    infos = [
        matchers.frustum_check(
            pos, normal, dmin, dmax, pvalid & (meta[12] > 0.5),
            meta[0:9].reshape(3, 3), meta[9:12],
            cam.fx, cam.fy, cam.cx, cam.cy,
            float(cam.width), float(cam.height),
            n_levels=config.orb.n_levels, scale=config.orb.scale_factor,
        )
        for meta in tgt_meta
    ]
    info = matchers.FrustumInfo(*(torch.stack(parts) for parts in zip(*infos)))
    m = matchers.match_fuse(
        info, pt_desc,
        tgt_feat[:, :, 0:2], tgt_desc, tgt_feat[:, :, 2].to(torch.int32),
        tgt_feat[:, :, 3] > 0.5,
        th=3.0, n_levels=config.orb.n_levels, scale=config.orb.scale_factor,
    )
    return m.idx.to(f32)


@full_float32
def fused_triangulation_jit(kf_f32, kf_desc, nb_f32, nb_desc, pair_f32, meta_f32,
                            config: SLAMConfig):
    args = (kf_f32, kf_desc, nb_f32, nb_desc, pair_f32, meta_f32)
    if not kf_f32.is_cuda:
        return fused_triangulation(*args, config)
    idx, uv2, normal = cuda_graph.call(triangulation_match, args, config)
    # torch.linalg.eigh reads its result's status on the host (it has no
    # _ex form), which a capture refuses: it runs between the two replays.
    _, V = linalg.eigh(normal)
    return cuda_graph.call(triangulation_gates, (idx, uv2, V) + args, config)


def fused_fuse_forward_jit(pt_f32, pt_desc, tgt_feat, tgt_desc, tgt_meta, config: SLAMConfig):
    return cuda_graph.call(fused_fuse_forward, (pt_f32, pt_desc, tgt_feat, tgt_desc, tgt_meta),
                           config)
