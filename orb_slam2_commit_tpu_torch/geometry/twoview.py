"""Monocular two-view initialization: batched H/F RANSAC and reconstruction
(PyTorch port of geometry/twoview.py; reference: src/Initializer.cc).

All RANSAC rounds of both models run as one batch: sample -> normalized
DLT -> score every correspondence -> best of each, then one refit on the
consensus set. Model choice and reconstruction follow the reference:
  RH = SH / (SH + SF) > 0.40 -> homography (src/Initializer.cc:156-164)
  F -> E -> 4 (R, t) hypotheses (:648-763, DecomposeE :1317-1345)
  H -> Faugeras' 8 hypotheses (:776-983)
chosen by CheckRT's triangulation gates (:1134-1303).

The sample sets are an input ([n_iters, 8] indices into the
correspondences): `geometry/ransac.py` draws them on the host, so the card
and the CPU evaluate the same sets. Plain PyTorch in the caller's dtype;
leading dimensions broadcast where a docstring says so.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orb_slam2_commit_tpu_torch.geometry import triangulation as tri
from orb_slam2_commit_tpu_torch.geometry.ransac import first_argmax
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

N_RANSAC = 200
SAMPLE_SIZE = 8
CHI2_H = 5.991   # chi2(2 dof, 0.05): homography transfer error
CHI2_F = 3.841   # chi2(1 dof, 0.05): epipolar distance
TH_SCORE = 5.991


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x where |x| > eps, else eps."""
    return torch.where(torch.abs(x) > eps, x, torch.full_like(x, eps))


def normalize_points(xy: torch.Tensor, valid: torch.Tensor):
    """Mean / mean-absolute-deviation normalization
    (src/Initializer.cc:1076-1131) -> (normalized [N, 2], T [3, 3]), T
    mapping raw to normalized."""
    w = valid.to(xy.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    mean_dev = torch.sum(torch.abs(xy - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp_min(mean_dev, 1e-9)
    xn = (xy - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one]),
    ])
    return xn, T


def _smallest_right_singular(A: torch.Tensor) -> torch.Tensor:
    """Null vector of A [..., m, d]: the eigenvector of A^T A with the
    smallest eigenvalue (up to sign)."""
    _, V = linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def compute_h21(x1: torch.Tensor, x2: torch.Tensor, weight=None) -> torch.Tensor:
    """DLT homography x1 -> x2 from >= 4 normalized correspondences
    [..., n, 2], optionally 0/1-weighted [..., n] (src/Initializer.cc:315-360)
    -> [..., 3, 3]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    rows_a = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    rows_b = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    if weight is not None:
        A = A * torch.cat([weight, weight], dim=-1)[..., None].to(A.dtype)
    return _smallest_right_singular(A).reshape(A.shape[:-2] + (3, 3))


def compute_f21(x1: torch.Tensor, x2: torch.Tensor, weight=None) -> torch.Tensor:
    """Eight-point fundamental matrix with the rank-2 projection, optionally
    0/1-weighted (src/Initializer.cc:374-421); x2^T F x1 = 0."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)
    if weight is not None:
        A = A * weight[..., None].to(A.dtype)
    F = _smallest_right_singular(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vh = linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vh


def _homogeneous(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def score_homography(H21, xy1, xy2, valid, sigma: float = 1.0):
    """Symmetric transfer error score (CheckHomography,
    src/Initializer.cc:424-533) of H21 [..., 3, 3] -> (score [...],
    inlier mask [..., N])."""
    inv_sigma2 = 1.0 / (sigma * sigma)
    H12 = torch.linalg.inv_ex(H21)[0]

    def transfer(H, a, b):
        p = _homogeneous(a) @ H.transpose(-1, -2)
        d = p[..., :2] / _safe(p[..., 2], 1e-12)[..., None] - b
        return torch.sum(d * d, dim=-1)

    chi2_12 = transfer(H12, xy2, xy1) * inv_sigma2
    chi2_21 = transfer(H21, xy1, xy2) * inv_sigma2
    in1 = chi2_12 <= CHI2_H
    in2 = chi2_21 <= CHI2_H
    zero = torch.zeros_like(chi2_12)
    score = torch.sum(torch.where(valid & in1, CHI2_H - chi2_12, zero)
                      + torch.where(valid & in2, CHI2_H - chi2_21, zero), dim=-1)
    return score, valid & in1 & in2


def score_fundamental(F21, xy1, xy2, valid, sigma: float = 1.0):
    """Epipolar distance score (CheckFundamental, src/Initializer.cc:536-636)
    of F21 [..., 3, 3] -> (score [...], inlier mask [..., N])."""
    inv_sigma2 = 1.0 / (sigma * sigma)

    def line_dist_sq(F, a, b):
        # The line in image b: l = F [a; 1].
        line = _homogeneous(a) @ F.transpose(-1, -2)
        num = torch.sum(line[..., :2] * b, dim=-1) + line[..., 2]
        den = torch.clamp_min(line[..., 0] ** 2 + line[..., 1] ** 2, 1e-12)
        return num * num / den

    chi2_1 = line_dist_sq(F21, xy1, xy2) * inv_sigma2
    chi2_2 = line_dist_sq(F21.transpose(-1, -2), xy2, xy1) * inv_sigma2
    in1 = chi2_1 <= CHI2_F
    in2 = chi2_2 <= CHI2_F
    zero = torch.zeros_like(chi2_1)
    score = torch.sum(torch.where(valid & in1, TH_SCORE - chi2_1, zero)
                      + torch.where(valid & in2, TH_SCORE - chi2_2, zero), dim=-1)
    return score, valid & in1 & in2


class TwoViewModels(NamedTuple):
    H21: torch.Tensor
    F21: torch.Tensor
    score_h: torch.Tensor
    score_f: torch.Tensor
    inliers_h: torch.Tensor
    inliers_f: torch.Tensor


@full_float32
def find_models(samples, xy1, xy2, valid, sigma: float = 1.0) -> TwoViewModels:
    """Every RANSAC round of H and F as one batch, the best of each, then
    one weighted refit on its consensus set, kept if it scores at least as
    well (FindHomography / FindFundamental, src/Initializer.cc:170-294).
    samples: [n_iters, 8] int64 indices into the N correspondences."""
    xn1, T1 = normalize_points(xy1, valid)
    xn2, T2 = normalize_points(xy2, valid)
    T2inv = torch.linalg.inv(T2)
    idx = samples.long()
    s1, s2 = xn1[idx], xn2[idx]                         # [n_iters, 8, 2]
    Hs = T2inv @ compute_h21(s1, s2) @ T1
    Fs = T2.T @ compute_f21(s1, s2) @ T1
    shs, _ = score_homography(Hs, xy1, xy2, valid, sigma)
    sfs, _ = score_fundamental(Fs, xy1, xy2, valid, sigma)
    bh, bf = first_argmax(shs), first_argmax(sfs)
    H_best, F_best = Hs[bh], Fs[bf]
    _, inl_h0 = score_homography(H_best, xy1, xy2, valid, sigma)
    _, inl_f0 = score_fundamental(F_best, xy1, xy2, valid, sigma)

    H_refit = T2inv @ compute_h21(xn1, xn2, weight=inl_h0) @ T1
    F_refit = T2.T @ compute_f21(xn1, xn2, weight=inl_f0) @ T1
    sh_refit, _ = score_homography(H_refit, xy1, xy2, valid, sigma)
    sf_refit, _ = score_fundamental(F_refit, xy1, xy2, valid, sigma)
    H21 = torch.where(sh_refit >= shs[bh], H_refit, H_best)
    F21 = torch.where(sf_refit >= sfs[bf], F_refit, F_best)
    h22 = H21[2, 2]
    H21 = H21 / torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))
    score_h, inl_h = score_homography(H21, xy1, xy2, valid, sigma)
    score_f, inl_f = score_fundamental(F21, xy1, xy2, valid, sigma)
    return TwoViewModels(H21, F21, score_h, score_f, inl_h, inl_f)


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------


def decompose_e(E: torch.Tensor):
    """E -> (R1, R2, t) with |t| = 1 (DecomposeE,
    src/Initializer.cc:1317-1345)."""
    U, _, Vh = linalg.svd(E)
    t = U[:, 2]
    t = t / torch.clamp_min(torch.linalg.norm(t), 1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vh
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def check_rt(R, t, xy1, xy2, valid, K, sigma2: float = 1.0):
    """Triangulate under each hypothesis R [H, 3, 3], t [H, 3] and count the
    points that pass the cheirality, parallax and reprojection gates
    (CheckRT, src/Initializer.cc:1134-1303) -> (n_good [H], parallax_deg
    [H], points [H, N, 3], good [H, N])."""
    th2 = 4.0 * sigma2
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    zero = torch.zeros(3, dtype=R.dtype, device=R.device)
    P2 = K @ torch.cat([R, t[..., :, None]], dim=-1)
    P1 = tri.projection_matrix(K, eye, zero).expand(P2.shape)
    pts = tri.triangulate_dlt(xy1, xy2, P1, P2)           # [H, N, 3]

    finite = torch.all(torch.isfinite(pts), dim=-1)
    c2 = -torch.einsum("hji,hj->hi", R, t)
    r1 = pts
    r2 = pts - c2[:, None, :]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp_min(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), 1e-12)
    z1 = pts[..., 2]
    z2 = torch.einsum("hnj,hj->hn", pts, R[:, 2, :]) + t[:, 2, None]
    e1 = tri.reprojection_error_sq(pts, xy1, P1)
    e2 = tri.reprojection_error_sq(pts, xy2, P2)
    good = (valid & finite & (cosp < 0.99998) & (z1 > 0) & (z2 > 0)
            & (e1 < th2) & (e2 < th2))
    n_good = torch.sum(good, dim=-1)

    # The reference sorts the good cosines ascending and takes index
    # min(50, n_good - 1): the 51st-largest parallax (:1284-1295).
    sorted_asc = torch.sort(torch.where(good, cosp, torch.full_like(cosp, 2.0)),
                            dim=-1).values
    take = torch.clamp_min(torch.clamp_max(n_good, 50) - 1, 0)
    cos_sel = torch.gather(sorted_asc, -1, take[:, None])[:, 0]
    cos_sel = torch.where(n_good > 0, cos_sel, torch.ones_like(cos_sel))
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cos_sel, -1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, torch.zeros_like(parallax))
    return n_good, parallax, pts, good


def reconstruct_f(F21, xy1, xy2, inliers, K, sigma: float = 1.0,
                  min_parallax: float = 1.0, min_triangulated: int = 50):
    """F -> E -> the best of 4 (R, t) hypotheses (ReconstructF,
    src/Initializer.cc:648-763) -> (ok, R, t, points, good)."""
    E = K.T @ F21 @ K
    R1, R2, tu = decompose_e(E)
    hyps_R = torch.stack([R1, R1, R2, R2])
    hyps_t = torch.stack([tu, -tu, tu, -tu])
    n_good, parallax, pts, good = check_rt(hyps_R, hyps_t, xy1, xy2, inliers, K,
                                           sigma * sigma)
    n_max = torch.max(n_good)
    n_min_good = torch.clamp_min((0.9 * torch.sum(inliers)).to(torch.int32),
                                 min_triangulated)
    n_similar = torch.sum(n_good > 0.7 * n_max)
    best = first_argmax(n_good)
    ok = (n_max >= n_min_good) & (n_similar == 1) & (parallax[best] > min_parallax)
    return ok, hyps_R[best], hyps_t[best], pts[best], good[best]


def _faugeras_hypotheses(A: torch.Tensor):
    """The 8 (R, t) hypotheses of the normalized homography A = K^-1 H K
    (ReconstructH, src/Initializer.cc:776-983, Faugeras-Lustman) ->
    (R [8, 3, 3], t [8, 3], degenerate)."""
    U, d, Vh = linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    degenerate = ((d1 / torch.clamp_min(d2, 1e-12) < 1.00001)
                  | (d2 / torch.clamp_min(d3, 1e-12) < 1.00001))
    aux1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    aux3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    x1_signs = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=A.dtype, device=A.device)
    x3_signs = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=A.dtype, device=A.device)
    x1, x3 = aux1 * x1_signs, aux3 * x3_signs
    root = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)

    # d' = +d2.
    ctheta = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2)).expand_as(x1)
    stheta = root / ((d1 + d3) * d2) * x1_signs * x3_signs
    Rp_pos = torch.stack([
        torch.stack([ctheta, zero, -stheta], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([stheta, zero, ctheta], -1)], -2)
    tp_pos = (d1 - d3) * torch.stack([x1, zero, -x3], -1)

    # d' = -d2.
    den = torch.where(torch.abs(d1 - d3) > 1e-12, (d1 - d3) * d2,
                      torch.full_like(d1, 1e-12))
    cphi = ((d1 * d3 - d2 * d2) / den).expand_as(x1)
    sphi = root / den * x1_signs * x3_signs
    Rp_neg = torch.stack([
        torch.stack([cphi, zero, sphi], -1),
        torch.stack([zero, -one, zero], -1),
        torch.stack([sphi, zero, -cphi], -1)], -2)
    tp_neg = (d1 + d3) * torch.stack([x1, zero, x3], -1)

    Rs = s * U @ torch.cat([Rp_pos, Rp_neg]) @ Vh
    ts = torch.cat([tp_pos, tp_neg]) @ U.T
    ts = ts / torch.clamp_min(torch.linalg.norm(ts, dim=-1, keepdim=True), 1e-12)
    return Rs, ts, degenerate


def reconstruct_h(H21, xy1, xy2, inliers, K, sigma: float = 1.0,
                  min_parallax: float = 1.0, min_triangulated: int = 50):
    """H -> the best of Faugeras' 8 hypotheses (ReconstructH,
    src/Initializer.cc:776-983) -> (ok, R, t, points, good)."""
    A = torch.linalg.inv(K) @ H21 @ K
    hyps_R, hyps_t, degenerate = _faugeras_hypotheses(A)
    n_good, parallax, pts, good = check_rt(hyps_R, hyps_t, xy1, xy2, inliers, K,
                                           sigma * sigma)
    # A stable descending sort: ties keep the lower hypothesis first.
    order = torch.sort(n_good, descending=True, stable=True)
    best, best_good, second_good = order.indices[0], order.values[0], order.values[1]
    ok = (~degenerate & (second_good < 0.75 * best_good)
          & (parallax[best] >= min_parallax) & (best_good > min_triangulated)
          & (best_good > 0.9 * torch.sum(inliers)))
    return ok, hyps_R[best], hyps_t[best], pts[best], good[best]


class TwoViewResult(NamedTuple):
    ok: torch.Tensor             # bool scalar
    used_homography: torch.Tensor
    R21: torch.Tensor            # [3, 3] camera-2-from-camera-1 rotation
    t21: torch.Tensor            # [3] unit-norm translation
    points: torch.Tensor         # [N, 3] triangulated, camera-1 frame
    good: torch.Tensor           # [N] bool triangulation mask


@full_float32
def initialize_two_view(
    samples: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    sigma: float = 1.0,
    min_parallax: float = 1.0,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """The two-view bootstrap (Initializer::Initialize,
    src/Initializer.cc:58-167) on the sample sets `samples` [n_iters, 8].
    RH > 0.40 chooses H; where H wins only marginally (RH <= 0.45) and
    fails to reconstruct, a passing F solution is taken instead (the JAX
    package's marginal-H fallback, beyond the reference)."""
    models = find_models(samples, xy1, xy2, valid, sigma)
    rh = models.score_h / torch.clamp_min(models.score_h + models.score_f, 1e-9)
    use_h = rh > 0.40
    ok_h, R_h, t_h, pts_h, good_h = reconstruct_h(
        models.H21, xy1, xy2, models.inliers_h, K, sigma, min_parallax, min_triangulated)
    ok_f, R_f, t_f, pts_f, good_f = reconstruct_f(
        models.F21, xy1, xy2, models.inliers_f, K, sigma, min_parallax, min_triangulated)
    sel_h = use_h & (ok_h | (rh > 0.45))
    return TwoViewResult(
        ok=torch.where(sel_h, ok_h, ok_f),
        used_homography=sel_h,
        R21=torch.where(sel_h, R_h, R_f),
        t21=torch.where(sel_h, t_h, t_f),
        points=torch.where(sel_h, pts_h, pts_f),
        good=torch.where(sel_h, good_h, good_f),
    )
