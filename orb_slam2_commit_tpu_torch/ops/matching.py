"""Hamming-distance descriptor matching primitives (PyTorch port of the
parts of ops/matching.py the tracker's per-frame matchers need).

A matcher is a dense masked [M, N] distance matrix, a best/second-best
ratio test, a rotation-consistency histogram (30 bins, top-3 kept) and
duplicate-target resolution. Thresholds TH_HIGH=100, TH_LOW=50,
HISTO_LENGTH=30 mirror src/ORBmatcher.cc:37-39.

Ties go where the JAX package sends them, on every device: first index
for minima and maxima, lowest bin for equal histogram counts. Each is
taken explicitly (a masked minimum of indices, a stable sort) because
torch's argmin/topk do not promise it on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from orb_slam2_commit_tpu_torch.utils.precision import full_float32


TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
INVALID = -1
BIG_DIST = 1 << 20


class MatchResult(NamedTuple):
    """idx[M] int32: matched column per row (-1 if none); dist[M] int32."""

    idx: torch.Tensor
    dist: torch.Tensor

    def count(self) -> torch.Tensor:
        return torch.sum(self.idx >= 0)


def _bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 words -> [..., 256] float32 bits (0 or 1)."""
    words = desc.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.float32)


@full_float32
def hamming_distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[..., M, 8] x [..., N, 8] int32 words -> [..., M, N] int32 Hamming
    distances (ORBmatcher::DescriptorDistance, src/ORBmatcher.cc:1844-1860),
    as |a| + |b| - 2 a.b over the 256 bits: one matrix product of 0/1
    values, whose sums (at most 256) float32 holds exactly in any order.
    Leading dimensions broadcast."""
    a, b = _bits(desc_a), _bits(desc_b)
    dot = a @ b.transpose(-1, -2)
    ones = torch.sum(a, dim=-1)[..., :, None] + torch.sum(b, dim=-1)[..., None, :]
    return (ones - 2.0 * dot).to(torch.int32)


def _first_argmin(d: torch.Tensor) -> torch.Tensor:
    """Lowest column index holding each row's minimum ([..., M, N] ->
    [..., M])."""
    cols = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device)
    m = d.amin(dim=-1, keepdim=True)
    return torch.where(d == m, cols, d.shape[-1]).amin(dim=-1)


def best_match_with_ratio(
    dist: torch.Tensor,
    mask: torch.Tensor,
    max_dist: int,
    ratio: float = 1.0,
    octave_b: Optional[torch.Tensor] = None,
) -> MatchResult:
    """Row-wise best match under a candidate mask with Lowe-style ratio test
    (best < ratio * second; 1.0 disables it). With octave_b the ratio test
    applies only when best and second are on the same octave
    (src/ORBmatcher.cc:124-132)."""
    big = torch.full_like(dist, BIG_DIST)
    d = torch.where(mask, dist, big)
    best_idx = _first_argmin(d)
    best = d.amin(dim=1)
    cols = torch.arange(d.shape[1], dtype=torch.int32, device=d.device)[None, :]
    d2 = torch.where(cols == best_idx[:, None], big, d)
    second = d2.amin(dim=1)
    second_idx = _first_argmin(d2)
    return match_from_top2(best, best_idx, second, second_idx, max_dist,
                           ratio, octave_b)


def match_from_top2(
    best: torch.Tensor,
    best_idx: torch.Tensor,
    second: torch.Tensor,
    second_idx: torch.Tensor,
    max_dist: int,
    ratio: float = 1.0,
    octave_b: Optional[torch.Tensor] = None,
) -> MatchResult:
    """best_match_with_ratio's gating applied to precomputed row top-2
    results (from the projection-matching kernel, K6). Identical
    semantics."""
    ok = best <= max_dist
    if ratio < 1.0:
        ratio_ok = best.to(torch.float32) < ratio * second.to(torch.float32)
        if octave_b is not None:
            same_octave = (
                octave_b[best_idx.long()] == octave_b[second_idx.long()]
            ) & (second < BIG_DIST)
            ratio_ok = ratio_ok | ~same_octave
        ok = ok & ratio_ok
    return MatchResult(
        idx=torch.where(ok, best_idx, INVALID).to(torch.int32),
        dist=torch.where(ok, best, BIG_DIST).to(torch.int32),
    )


def window_mask(xy_a: torch.Tensor, xy_b: torch.Tensor, radius) -> torch.Tensor:
    """[..., M, N] mask: b within a square window of half-size radius
    around a; radius is a scalar or per-row [..., M]. Leading dimensions
    broadcast."""
    r = radius
    if isinstance(r, torch.Tensor) and r.dim() >= 1:
        r = r[..., None]
    dx = torch.abs(xy_a[..., :, None, 0] - xy_b[..., None, :, 0])
    dy = torch.abs(xy_a[..., :, None, 1] - xy_b[..., None, :, 1])
    return (dx <= r) & (dy <= r)


def octave_band_mask(
    octave_b: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """[..., M, N] mask: octave of b within [lo_m, hi_m] per row."""
    ob = octave_b[..., None, :]
    return (ob >= lo[..., :, None]) & (ob <= hi[..., :, None])


def _flat_rows(t: torch.Tensor) -> torch.Tensor:
    """[..., M] -> [B, M] with B the product of the leading dimensions."""
    return t.reshape(-1, t.shape[-1])


def resolve_duplicate_targets(match: MatchResult, n_targets: int) -> MatchResult:
    """Each target column is kept by at most one row: the smallest distance,
    then the lowest row (scatter-min per column, then rows that lost their
    claim are invalidated). idx [..., M]: each leading index is a problem
    of its own, with its own n_targets columns."""
    dev = match.idx.device
    idx, dist = _flat_rows(match.idx), _flat_rows(match.dist)
    nb, m = idx.shape
    safe_idx = torch.clamp_min(idx, 0).to(torch.int64)
    claimed = idx >= 0
    best_per_col = torch.full((nb, n_targets), BIG_DIST, dtype=torch.int32, device=dev)
    best_per_col = best_per_col.scatter_reduce(
        1, safe_idx, torch.where(claimed, dist, BIG_DIST).to(torch.int32),
        reduce="amin")
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    is_best = claimed & (dist == torch.gather(best_per_col, 1, safe_idx))
    claimant = torch.full((nb, n_targets), 1 << 30, dtype=torch.int32, device=dev)
    claimant = claimant.scatter_reduce(
        1, safe_idx, torch.where(is_best, rows, 1 << 30).to(torch.int32),
        reduce="amin")
    keep = (is_best & (torch.gather(claimant, 1, safe_idx) == rows)).reshape(match.idx.shape)
    return MatchResult(
        idx=torch.where(keep, match.idx, INVALID).to(torch.int32),
        dist=torch.where(keep, match.dist, BIG_DIST).to(torch.int32),
    )


def mutual_consistency(ab: MatchResult, ba: MatchResult) -> MatchResult:
    """Keep the a -> b matches whose b -> a match points back (the
    cross-check of SearchBySim3, src/ORBmatcher.cc:1440-1459)."""
    m = ab.idx
    back = torch.where(m >= 0, ba.idx[torch.clamp_min(m, 0).long()], INVALID)
    rows = torch.arange(m.shape[0], dtype=m.dtype, device=m.device)
    ok = (m >= 0) & (back == rows)
    return MatchResult(idx=torch.where(ok, m, INVALID).to(torch.int32),
                       dist=torch.where(ok, ab.dist, BIG_DIST).to(torch.int32))


def rotation_consistency_filter(
    match: MatchResult,
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    histo_length: int = HISTO_LENGTH,
) -> MatchResult:
    """Keep only matches whose angle difference falls in the 3 dominant
    orientation-histogram bins (rotHist + ComputeThreeMaxima,
    src/ORBmatcher.cc:1797-1839): the top bin always, the 2nd and 3rd only
    at >= 0.1 x the top count. Equal counts rank by lowest bin (a stable
    descending sort), as lax.top_k ranks them. idx, angle_a [..., M] and
    angle_b [..., N]: each leading index is a problem with its own
    histogram."""
    dev = match.idx.device
    idx = _flat_rows(match.idx)
    nb = idx.shape[0]
    valid = idx >= 0
    target = torch.clamp_min(idx, 0).long()
    angle_b = _flat_rows(angle_b).expand(nb, -1)
    rot = _flat_rows(angle_a).expand(nb, -1) - torch.gather(angle_b, 1, target)
    rot = torch.remainder(rot, 2.0 * math.pi)
    bin_idx = torch.clamp(
        (rot * (histo_length / (2.0 * math.pi))).to(torch.int32), 0, histo_length - 1
    ).long()
    counts = torch.zeros((nb, histo_length), dtype=torch.int32, device=dev)
    counts = counts.scatter_add(1, bin_idx, valid.to(torch.int32))
    top_vals, top_idx = torch.sort(counts, dim=1, descending=True, stable=True)
    top_vals = top_vals[:, :3].to(torch.float32)
    keep_top = top_vals >= 0.1 * top_vals[:, :1]
    keep_top[:, 0] = True                            # the top bin always holds
    # The three bins are distinct.
    keep_bin = torch.zeros((nb, histo_length), dtype=torch.bool, device=dev)
    keep_bin = keep_bin.scatter(1, top_idx[:, :3], keep_top)
    ok = (valid & torch.gather(keep_bin, 1, bin_idx)).reshape(match.idx.shape)
    return MatchResult(
        idx=torch.where(ok, match.idx, INVALID).to(torch.int32),
        dist=torch.where(ok, match.dist, BIG_DIST).to(torch.int32),
    )


def epipolar_terms(
    xy_a: torch.Tensor,
    F12: torch.Tensor,
    sigma2_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-row and per-column parts of `epipolar_mask`: a's epipolar
    lines in image b [..., M, 3] (l = F12 @ [x, y, 1]), their l0^2 + l1^2
    clamped to 1e-12 [..., M], and b's thresholds 3.84 * sigma2 [..., N]."""
    pa = torch.cat([xy_a, torch.ones_like(xy_a[..., :1])], dim=-1)   # [..., M, 3]
    lines = pa @ F12.transpose(-1, -2)                                # [..., M, 3]
    den = torch.clamp_min(lines[..., 0] ** 2 + lines[..., 1] ** 2, 1e-12)
    return lines, den, 3.84 * sigma2_b


def epipolar_mask(
    xy_a: torch.Tensor,
    xy_b: torch.Tensor,
    F12: torch.Tensor,
    sigma2_b: torch.Tensor,
) -> torch.Tensor:
    """[..., M, N] mask: b within the chi2(1) = 3.84 band of a's epipolar
    line (CheckDistEpipolarLine, src/ORBmatcher.cc:153-173): squared
    point-line distance < 3.84 * sigma2 of b's octave. F12 maps an image-a
    point to its line in image b (l = F12 @ [x, y, 1]). Leading batch
    dimensions broadcast: xy [..., M, 2], F12 [..., 3, 3]."""
    lines, den, thr = epipolar_terms(xy_a, F12, sigma2_b)
    num = (
        lines[..., :, None, 0] * xy_b[..., None, :, 0]
        + lines[..., :, None, 1] * xy_b[..., None, :, 1]
        + lines[..., :, None, 2]
    )
    dsqr = (num * num) / den[..., :, None]
    return dsqr < thr[..., None, :]
