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
from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.utils.device_cache import device_table

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


_popcount_table = device_table(
    lambda: np.array([bin(i).count("1") for i in range(256)], np.int32))


def hamming_distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[M, 8] x [N, 8] int32 words -> [M, N] int32 Hamming distances
    (ORBmatcher::DescriptorDistance, src/ORBmatcher.cc:1844-1860): XOR, view
    the words as bytes, look each byte up in a 256-entry popcount table."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :]).contiguous()
    counts = _popcount_table(desc_a.device)[x.view(torch.uint8).to(torch.int64)]
    return counts.sum(dim=-1, dtype=torch.int32)


def _first_argmin(d: torch.Tensor) -> torch.Tensor:
    """Lowest column index holding each row's minimum."""
    cols = torch.arange(d.shape[1], dtype=torch.int32, device=d.device)
    m = d.amin(dim=1, keepdim=True)
    return torch.where(d == m, cols, d.shape[1]).amin(dim=1)


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
    """[M, N] mask: b within a square window of half-size radius around a;
    radius is a scalar or per-row [M]."""
    r = radius
    if isinstance(r, torch.Tensor) and r.dim() == 1:
        r = r[:, None]
    dx = torch.abs(xy_a[:, None, 0] - xy_b[None, :, 0])
    dy = torch.abs(xy_a[:, None, 1] - xy_b[None, :, 1])
    return (dx <= r) & (dy <= r)


def octave_band_mask(
    octave_b: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """[M, N] mask: octave of b within [lo_m, hi_m] per row."""
    return (octave_b[None, :] >= lo[:, None]) & (octave_b[None, :] <= hi[:, None])


def resolve_duplicate_targets(match: MatchResult, n_targets: int) -> MatchResult:
    """Each target column is kept by at most one row: the smallest distance,
    then the lowest row (scatter-min per column, then rows that lost their
    claim are invalidated)."""
    dev = match.idx.device
    safe_idx = torch.clamp_min(match.idx, 0).to(torch.int64)
    claimed = match.idx >= 0
    best_per_col = torch.full((n_targets,), BIG_DIST, dtype=torch.int32, device=dev)
    best_per_col = best_per_col.scatter_reduce(
        0, safe_idx, torch.where(claimed, match.dist, BIG_DIST).to(torch.int32),
        reduce="amin")
    rows = torch.arange(match.idx.shape[0], dtype=torch.int32, device=dev)
    is_best = claimed & (match.dist == best_per_col[safe_idx])
    claimant = torch.full((n_targets,), 1 << 30, dtype=torch.int32, device=dev)
    claimant = claimant.scatter_reduce(
        0, safe_idx, torch.where(is_best, rows, 1 << 30).to(torch.int32),
        reduce="amin")
    keep = is_best & (claimant[safe_idx] == rows)
    return MatchResult(
        idx=torch.where(keep, match.idx, INVALID).to(torch.int32),
        dist=torch.where(keep, match.dist, BIG_DIST).to(torch.int32),
    )


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
    descending sort), as lax.top_k ranks them."""
    dev = match.idx.device
    valid = match.idx >= 0
    rot = angle_a - angle_b[torch.clamp_min(match.idx, 0).long()]
    rot = torch.remainder(rot, 2.0 * math.pi)
    bin_idx = torch.clamp(
        (rot * (histo_length / (2.0 * math.pi))).to(torch.int32), 0, histo_length - 1
    ).long()
    counts = torch.zeros(histo_length, dtype=torch.int32, device=dev)
    counts = counts.scatter_add(0, bin_idx, valid.to(torch.int32))
    top_vals, top_idx = torch.sort(counts, descending=True, stable=True)
    top_vals = top_vals[:3].to(torch.float32)
    keep_top = top_vals >= 0.1 * top_vals[0]        # the top bin always holds
    keep_top[0] = True
    # Tensor indices (no host sync); the three bins are distinct.
    keep_bin = torch.zeros(histo_length, dtype=torch.bool, device=dev)
    keep_bin = keep_bin.index_put((top_idx[:3],), keep_top)
    ok = valid & keep_bin[bin_idx]
    return MatchResult(
        idx=torch.where(ok, match.idx, INVALID).to(torch.int32),
        dist=torch.where(ok, match.dist, BIG_DIST).to(torch.int32),
    )
