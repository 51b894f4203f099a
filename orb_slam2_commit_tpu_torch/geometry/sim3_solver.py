"""Sim(3) estimation: Horn's closed form and a batched 3-point RANSAC
(PyTorch port of geometry/sim3_solver.py; reference: src/Sim3Solver.cc).

The loop-closure relative transform between two keyframes from matched
map points: Horn's absolute orientation in its SVD form, inside a 3-point
RANSAC whose every round runs at once, with the mutual reprojection
inlier test (:396-422, chi2 9.21 sigma^2), then a weighted refit on the
best round's consensus set.

The JAX package draws each round's three indices on the device
(jax.random.choice without replacement, weights valid / sum(valid)); the
port takes the [n_iters, 3] index sets as an input, drawn on the host by
geometry/ransac.RansacSampler.sim3, so the card and the CPU see the same
sets. The winning round is the first with the most inliers
(ransac.first_argmax, jnp.argmax's rule).

The RANSAC runs in three stages around its two SVDs (the rounds' Horn
fits, one batched call, and the refit's), which read their status on the
host: the rounds' cross-covariances; the rounds' fits, inlier counts and
the winner, and the refit's weighted cross-covariance; the refit and the
choice. `sim3_ransac_jit` is the single-dispatch form (the JAX package's
jitted namesake, the same arguments): on CUDA tensors each stage is one
replay of a CUDA graph (utils/cuda_graph.py), three replays and two SVDs
a call; on CPU tensors the same stages run eagerly. `sim3_ransac` runs
them eagerly on any device (cuda_graph.eager). The loop closer calls the
form, on the card with its pairs padded to a power of two (`valid` False
on the padding).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from orb_slam2_commit_tpu_torch.geometry.ransac import first_argmax
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


def _horn_cov(x1: torch.Tensor, x2: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """Horn's fit before its SVD -> (the [..., 3, 3] cross-covariance, the
    centroids c1, c2 [..., 3], the centred squared norms n1, n2 [...])."""
    if weights is None:
        weights = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    wsum = torch.clamp_min(torch.sum(weights, dim=-1), 1e-9)
    c1 = torch.sum(x1 * weights[..., None], dim=-2) / wsum[..., None]
    c2 = torch.sum(x2 * weights[..., None], dim=-2) / wsum[..., None]
    y1 = (x1 - c1[..., None, :]) * weights[..., None]
    y2 = (x2 - c2[..., None, :]) * weights[..., None]
    H = y1.transpose(-1, -2) @ y2                   # [..., 3, 3]
    n1 = torch.sum(y1 * y1, dim=(-1, -2))
    n2 = torch.sum(y2 * y2, dim=(-1, -2))
    return H, c1, c2, n1, n2


def _horn_finish(U, Vt, c1, c2, n1, n2, fix_scale: bool):
    """Horn's fit from the SVD U, Vt of _horn_cov's H -> (s, R, t)."""
    d = torch.linalg.det(U @ Vt)
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = U @ S @ Vt
    s = torch.sqrt(n1 / torch.clamp_min(n2, 1e-12))
    if fix_scale:
        s = torch.ones_like(s)
    t = c1 - s[..., None] * torch.einsum("...ij,...j->...i", R, c2)
    return s, R, t


def _svd(H):
    """The U, Vt of H's SVD (between two stages)."""
    U, _, Vt = linalg.svd(H)
    return U, Vt


@full_float32
def horn_sim3(
    x1: torch.Tensor, x2: torch.Tensor, fix_scale: bool = False,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form similarity x1 ~ s R x2 + t from paired points
    x1, x2 [..., n, 3] (leading axes batch). fix_scale freezes s = 1
    (stereo, RGB-D); optional 0/1 weights [..., n] select a subset. The
    scale is Horn's symmetric sqrt(sum |y1|^2 / sum |y2|^2)."""
    H, *terms = _horn_cov(x1, x2, weights)
    return _horn_finish(*_svd(H), *terms, fix_scale)


class Sim3RansacResult(NamedTuple):
    ok: torch.Tensor
    s12: torch.Tensor
    R12: torch.Tensor
    t12: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _project(x, fx, fy, cx, cy):
    z = torch.where(torch.abs(x[..., 2]) > 1e-9, x[..., 2], torch.full_like(x[..., 2], 1e-9))
    return torch.stack([fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy], dim=-1)


def _count_inliers(s, R, t, x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2, key):
    """Pairs whose both reprojections through (s, R, t) pass the chi2 test
    (CheckInliers, src/Sim3Solver.cc:396-422): x2 into camera 1 and x1
    into camera 2, each projected."""
    fx, fy, cx, cy, _, _, chi2 = key
    x2_in_1 = torch.einsum("...ij,...nj->...ni", R, s[..., None, None] * x2) + t[..., None, :]
    x1_in_2 = (1.0 / s)[..., None, None] * torch.einsum(
        "...ji,...nj->...ni", R, x1 - t[..., None, :])
    e1 = torch.sum((_project(x2_in_1, fx, fy, cx, cy) - uv1) ** 2, dim=-1)
    e2 = torch.sum((_project(x1_in_2, fx, fy, cx, cy) - uv2) ** 2, dim=-1)
    return valid & (e1 < chi2 * sigma2_1) & (e2 < chi2 * sigma2_2)


def _rounds_cov(samples, x1, x2, key):
    """Stage 1: each round's minimal set -> its Horn cross-covariance,
    centroids and norms (_horn_cov, [n_iters, ...])."""
    return _horn_cov(x1[samples], x2[samples])


def _rounds_best(U, Vt, terms, x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2, key):
    """Stage 2, after the rounds' SVD (terms: the rest of their
    _horn_cov): every round's fit and inlier count, the first best round
    -> (its s, R, t, its inliers, the refit's _horn_cov on them)."""
    fix_scale = key[4]
    pairs = (x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2)
    ss, Rs, ts = _horn_finish(U, Vt, *terms, fix_scale)
    best = first_argmax(torch.sum(_count_inliers(ss, Rs, ts, *pairs, key), dim=-1))
    # index_select, not a 0-d index (that one reads the index on the host).
    s_b, R_b, t_b = (a.index_select(0, best[None])[0] for a in (ss, Rs, ts))
    inl0 = _count_inliers(s_b, R_b, t_b, *pairs, key)
    return s_b, R_b, t_b, inl0, _horn_cov(x1, x2, inl0.to(x1.dtype))


def _refit_choice(U, Vt, terms, s_b, R_b, t_b, inl0, x1, x2, valid, uv1, uv2, sigma2_1,
                  sigma2_2, key) -> Sim3RansacResult:
    """Stage 3, after the refit's SVD: the refit kept if it counts no
    fewer inliers -> Sim3RansacResult."""
    fix_scale, min_inliers = key[4], key[5]
    s_r, R_r, t_r = _horn_finish(U, Vt, *terms, fix_scale)
    inl_r = _count_inliers(s_r, R_r, t_r, x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2, key)
    use_refit = torch.sum(inl_r) >= torch.sum(inl0)
    inl_f = torch.where(use_refit, inl_r, inl0)
    n_f = torch.sum(inl_f)
    return Sim3RansacResult(
        ok=n_f >= min_inliers,
        s12=torch.where(use_refit, s_r, s_b),
        R12=torch.where(use_refit, R_r, R_b),
        t12=torch.where(use_refit, t_r, t_b),
        inliers=inl_f, n_inliers=n_f,
    )


def _ransac(samples, x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2, key) -> Sim3RansacResult:
    """The RANSAC's three stages, each through utils/cuda_graph.call, with
    the two SVDs between them."""
    pairs = (x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2)
    H, *terms = cuda_graph.call(_rounds_cov, (samples, x1, x2), key)
    s_b, R_b, t_b, inl0, (H, *terms) = cuda_graph.call(
        _rounds_best, (*_svd(H), tuple(terms)) + pairs, key)
    return cuda_graph.call(_refit_choice, (*_svd(H), tuple(terms), s_b, R_b, t_b, inl0) + pairs,
                           key)


@full_float32
def sim3_ransac(
    samples: torch.Tensor,      # [n_iters, 3] int64 indices, one minimal set a round
    x1: torch.Tensor,           # [n, 3] points in KF1's camera frame
    x2: torch.Tensor,           # [n, 3] the matched points in KF2's camera frame
    valid: torch.Tensor,        # [n] bool
    uv1: torch.Tensor,          # [n, 2] observed pixels in image 1
    uv2: torch.Tensor,          # [n, 2] observed pixels in image 2
    sigma2_1: torch.Tensor,     # [n] octave sigma^2 in image 1
    sigma2_2: torch.Tensor,     # [n]
    fx: float, fy: float, cx: float, cy: float,
    fix_scale: bool = False,
    min_inliers: int = 20,
    chi2: float = 9.21,
) -> Sim3RansacResult:
    """Every round's Horn fit and inlier count at once (Sim3Solver::iterate,
    src/Sim3Solver.cc:153-239, CheckInliers :396-422), the first best round
    kept, then the weighted refit on its consensus set, kept if it counts
    no fewer inliers. The stages of sim3_ransac_jit, run eagerly on any
    device."""
    with cuda_graph.eager():
        return _ransac(samples, x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2,
                       (fx, fy, cx, cy, fix_scale, min_inliers, chi2))


@full_float32
def sim3_ransac_jit(
    samples: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    sigma2_1: torch.Tensor,
    sigma2_2: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    fix_scale: bool = False,
    min_inliers: int = 20,
    chi2: float = 9.21,
) -> Sim3RansacResult:
    """sim3_ransac with each stage through utils/cuda_graph.call: on the
    card three replays around two SVDs, eagerly on the CPU."""
    return _ransac(samples, x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2,
                   (fx, fy, cx, cy, fix_scale, min_inliers, chi2))


# The functions sim3_ransac_jit captures (cuda_graph.release's owners).
GRAPHED = (_rounds_cov, _rounds_best, _refit_choice)
