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

The bootstrap runs in five stages around its library calls, which read
their status on the host: the sample sets' eigensolves and F's SVD, the
refits' eigensolves and SVD, the SVDs of the normalized H and of E, and
the triangulations' eigensolves. `initialize_two_view_jit` is the
single-dispatch form (the JAX package's jitted namesake, the same
arguments): on CUDA tensors each stage is one replay of a CUDA graph
(utils/cuda_graph.py) with those calls between them, on CPU tensors the
same stages run eagerly; `initialize_two_view` runs them eagerly on any
device (cuda_graph.eager). The tracker's monocular initialization calls
the form.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.geometry import triangulation as tri
from orb_slam2_commit_tpu_torch.geometry.ransac import first_argmax
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

N_RANSAC = 200
SAMPLE_SIZE = 8
CHI2_H = 5.991   # chi2(2 dof, 0.05): homography transfer error
CHI2_F = 3.841   # chi2(1 dof, 0.05): epipolar distance
TH_SCORE = 5.991

# DecomposeE's W, and Faugeras' signs of x1 and x3 (rows), cached on each
# device: a capture cannot copy a host tensor to the card.
_W = device_table(lambda: np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]))
_SIGNS = device_table(lambda: np.array([[1.0, 1.0, -1.0, -1.0], [1.0, -1.0, 1.0, -1.0]]))


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


def _null_vectors(V: torch.Tensor) -> torch.Tensor:
    """The eigenvectors of smallest eigenvalue of A^T A (ascending
    eigenvectors V [..., d, d]), reshaped to 3x3 (a view): the null
    vector of A up to sign."""
    x = V[..., :, 0]
    return x.reshape(x.shape[:-1] + (3, 3))


def _h21_normal(x1: torch.Tensor, x2: torch.Tensor, weight=None) -> torch.Tensor:
    """compute_h21's A^T A [..., 9, 9] before its eigensolve."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    rows_a = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    rows_b = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    if weight is not None:
        A = A * torch.cat([weight, weight], dim=-1)[..., None].to(A.dtype)
    return A.transpose(-1, -2) @ A


def compute_h21(x1: torch.Tensor, x2: torch.Tensor, weight=None) -> torch.Tensor:
    """DLT homography x1 -> x2 from >= 4 normalized correspondences
    [..., n, 2], optionally 0/1-weighted [..., n] (src/Initializer.cc:315-360)
    -> [..., 3, 3]: the eigenvector of A^T A with the smallest eigenvalue."""
    _, V = linalg.eigh(_h21_normal(x1, x2, weight))
    return _null_vectors(V)


def _f21_normal(x1: torch.Tensor, x2: torch.Tensor, weight=None) -> torch.Tensor:
    """compute_f21's A^T A [..., 9, 9] before its eigensolve."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)
    if weight is not None:
        A = A * weight[..., None].to(A.dtype)
    return A.transpose(-1, -2) @ A


def _rank2(U: torch.Tensor, S: torch.Tensor, Vh: torch.Tensor) -> torch.Tensor:
    """F from its SVD with the smallest singular value zeroed."""
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vh


def compute_f21(x1: torch.Tensor, x2: torch.Tensor, weight=None) -> torch.Tensor:
    """Eight-point fundamental matrix with the rank-2 projection, optionally
    0/1-weighted (src/Initializer.cc:374-421); x2^T F x1 = 0."""
    _, V = linalg.eigh(_f21_normal(x1, x2, weight))
    return _rank2(*linalg.svd(_null_vectors(V)))


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


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor i, read on the device (indexing with a
    0-d tensor reads it on the host)."""
    return x[i[None]][0]


# The stages. Each is fn(*tensors, key), key = (sigma, min_parallax,
# min_triangulated); the library calls run between them (_two_view).

def _models_start(samples, xy1, xy2, valid, key):
    """find_models up to the sample sets' eigensolves -> (normalized
    points and their transforms, the H and F sets' A^T A [n_iters, 9, 9])."""
    xn1, T1 = normalize_points(xy1, valid)
    xn2, T2 = normalize_points(xy2, valid)
    idx = samples.long()
    s1, s2 = xn1[idx], xn2[idx]                         # [n_iters, 8, 2]
    return xn1, T1, xn2, T2, _h21_normal(s1, s2), _f21_normal(s1, s2)


def _models_best(xy1, xy2, valid, xn1, T1, xn2, T2, Vh, Uf, Sf, Vhf, key):
    """Every round's H and F scored, the best of each and its consensus
    set -> (T2^-1, the best H and F and their scores, the refits' A^T A)."""
    sigma = key[0]
    T2inv = torch.linalg.inv_ex(T2)[0]
    Hs = T2inv @ _null_vectors(Vh) @ T1
    Fs = T2.T @ _rank2(Uf, Sf, Vhf) @ T1
    shs, _ = score_homography(Hs, xy1, xy2, valid, sigma)
    sfs, _ = score_fundamental(Fs, xy1, xy2, valid, sigma)
    bh, bf = first_argmax(shs), first_argmax(sfs)
    H_best, F_best = _at(Hs, bh), _at(Fs, bf)
    _, inl_h0 = score_homography(H_best, xy1, xy2, valid, sigma)
    _, inl_f0 = score_fundamental(F_best, xy1, xy2, valid, sigma)
    return (T2inv, H_best, F_best, _at(shs, bh), _at(sfs, bf),
            _h21_normal(xn1, xn2, weight=inl_h0), _f21_normal(xn1, xn2, weight=inl_f0))


def _models_finish(xy1, xy2, valid, T1, T2, T2inv, H_best, F_best, sh_best, sf_best,
                   Vh, Uf, Sf, Vhf, sigma) -> TwoViewModels:
    """The refits kept where they score at least as well, H normalized to
    H[2, 2] = 1, and both models' final scores and inliers."""
    H_refit = T2inv @ _null_vectors(Vh) @ T1
    F_refit = T2.T @ _rank2(Uf, Sf, Vhf) @ T1
    sh_refit, _ = score_homography(H_refit, xy1, xy2, valid, sigma)
    sf_refit, _ = score_fundamental(F_refit, xy1, xy2, valid, sigma)
    H21 = torch.where(sh_refit >= sh_best, H_refit, H_best)
    F21 = torch.where(sf_refit >= sf_best, F_refit, F_best)
    h22 = H21[2, 2]
    H21 = H21 / torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))
    score_h, inl_h = score_homography(H21, xy1, xy2, valid, sigma)
    score_f, inl_f = score_fundamental(F21, xy1, xy2, valid, sigma)
    return TwoViewModels(H21, F21, score_h, score_f, inl_h, inl_f)


def _find_models(samples, xy1, xy2, valid, key):
    """find_models' first two stages through utils/cuda_graph.call, with
    the eigensolves and SVDs after each -> (_models_finish's inputs after
    xy1, xy2, valid, the refits' eigenvectors and SVD)."""
    xn1, T1, xn2, T2, normal_h, normal_f = cuda_graph.call(
        _models_start, (samples, xy1, xy2, valid), key)
    _, Vh = linalg.eigh(normal_h)
    _, Vf = linalg.eigh(normal_f)
    best = cuda_graph.call(_models_best, (xy1, xy2, valid, xn1, T1, xn2, T2, Vh)
                           + tuple(linalg.svd(_null_vectors(Vf))), key)
    T2inv, H_best, F_best, sh_best, sf_best, normal_h, normal_f = best
    _, Vh = linalg.eigh(normal_h)
    _, Vf = linalg.eigh(normal_f)
    return (T1, T2, T2inv, H_best, F_best, sh_best, sf_best, Vh) \
        + tuple(linalg.svd(_null_vectors(Vf)))


@full_float32
def find_models(samples, xy1, xy2, valid, sigma: float = 1.0) -> TwoViewModels:
    """Every RANSAC round of H and F as one batch, the best of each, then
    one weighted refit on its consensus set, kept if it scores at least as
    well (FindHomography / FindFundamental, src/Initializer.cc:170-294).
    samples: [n_iters, 8] int64 indices into the N correspondences."""
    with cuda_graph.eager():
        parts = _find_models(samples, xy1, xy2, valid, (sigma,))
    return _models_finish(xy1, xy2, valid, *parts, sigma)


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------


def _decompose_svd(U: torch.Tensor, Vh: torch.Tensor):
    """DecomposeE from E's SVD -> (R1, R2, t)."""
    t = U[:, 2]
    t = t / torch.clamp_min(torch.linalg.norm(t), 1e-12)
    W = _W(U.device).to(U.dtype)
    R1 = U @ W @ Vh
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vh
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def decompose_e(E: torch.Tensor):
    """E -> (R1, R2, t) with |t| = 1 (DecomposeE,
    src/Initializer.cc:1317-1345)."""
    U, _, Vh = linalg.svd(E)
    return _decompose_svd(U, Vh)


def _check_rt_normals(R, t, xy1, xy2, K):
    """check_rt's triangulation before its eigensolve -> the DLT's A^T A
    [H, N, 4, 4] under each hypothesis."""
    P1, P2 = _projections(R, t, K)
    return tri.dlt_normal_matrices(xy1, xy2, P1, P2)


def _projections(R, t, K):
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    zero = torch.zeros(3, dtype=R.dtype, device=R.device)
    P2 = K @ torch.cat([R, t[..., :, None]], dim=-1)
    P1 = tri.projection_matrix(K, eye, zero).expand(P2.shape)
    return P1, P2


def _check_rt_gates(R, t, xy1, xy2, valid, K, V, sigma2: float):
    """check_rt from the DLT's eigenvectors V [H, N, 4, 4]."""
    th2 = 4.0 * sigma2
    P1, P2 = _projections(R, t, K)
    pts = tri.dlt_points(V)                               # [H, N, 3]

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


def check_rt(R, t, xy1, xy2, valid, K, sigma2: float = 1.0):
    """Triangulate under each hypothesis R [H, 3, 3], t [H, 3] and count the
    points that pass the cheirality, parallax and reprojection gates
    (CheckRT, src/Initializer.cc:1134-1303) -> (n_good [H], parallax_deg
    [H], points [H, N, 3], good [H, N])."""
    _, V = linalg.eigh(_check_rt_normals(R, t, xy1, xy2, K))
    return _check_rt_gates(R, t, xy1, xy2, valid, K, V, sigma2)


def _hypotheses_f(U, Vh):
    """ReconstructF's 4 (R, t) hypotheses from E's SVD."""
    R1, R2, tu = _decompose_svd(U, Vh)
    return torch.stack([R1, R1, R2, R2]), torch.stack([tu, -tu, tu, -tu])


def _select_f(hyps_R, hyps_t, checked, inliers, min_parallax, min_triangulated):
    """ReconstructF's choice among its checked hypotheses -> (ok, R, t,
    points, good)."""
    n_good, parallax, pts, good = checked
    n_max = torch.max(n_good)
    n_min_good = torch.clamp_min((0.9 * torch.sum(inliers)).to(torch.int32),
                                 min_triangulated)
    n_similar = torch.sum(n_good > 0.7 * n_max)
    best = first_argmax(n_good)
    ok = (n_max >= n_min_good) & (n_similar == 1) & (_at(parallax, best) > min_parallax)
    return ok, _at(hyps_R, best), _at(hyps_t, best), _at(pts, best), _at(good, best)


def reconstruct_f(F21, xy1, xy2, inliers, K, sigma: float = 1.0,
                  min_parallax: float = 1.0, min_triangulated: int = 50):
    """F -> E -> the best of 4 (R, t) hypotheses (ReconstructF,
    src/Initializer.cc:648-763) -> (ok, R, t, points, good)."""
    U, _, Vh = linalg.svd(K.T @ F21 @ K)
    hyps_R, hyps_t = _hypotheses_f(U, Vh)
    checked = check_rt(hyps_R, hyps_t, xy1, xy2, inliers, K, sigma * sigma)
    return _select_f(hyps_R, hyps_t, checked, inliers, min_parallax, min_triangulated)


def _faugeras_svd(U: torch.Tensor, d: torch.Tensor, Vh: torch.Tensor):
    """Faugeras' 8 hypotheses from the SVD of the normalized homography ->
    (R [8, 3, 3], t [8, 3], degenerate)."""
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    degenerate = ((d1 / torch.clamp_min(d2, 1e-12) < 1.00001)
                  | (d2 / torch.clamp_min(d3, 1e-12) < 1.00001))
    aux1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    aux3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    x1_signs, x3_signs = _SIGNS(U.device).to(U.dtype).unbind(0)
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


def _faugeras_hypotheses(A: torch.Tensor):
    """The 8 (R, t) hypotheses of the normalized homography A = K^-1 H K
    (ReconstructH, src/Initializer.cc:776-983, Faugeras-Lustman) ->
    (R [8, 3, 3], t [8, 3], degenerate)."""
    return _faugeras_svd(*linalg.svd(A))


def _select_h(hyps_R, hyps_t, degenerate, checked, inliers, min_parallax,
              min_triangulated):
    """ReconstructH's choice among its checked hypotheses -> (ok, R, t,
    points, good)."""
    n_good, parallax, pts, good = checked
    # A stable descending sort: ties keep the lower hypothesis first.
    order = torch.sort(n_good, descending=True, stable=True)
    best, best_good, second_good = order.indices[0], order.values[0], order.values[1]
    ok = (~degenerate & (second_good < 0.75 * best_good)
          & (_at(parallax, best) >= min_parallax) & (best_good > min_triangulated)
          & (best_good > 0.9 * torch.sum(inliers)))
    return ok, _at(hyps_R, best), _at(hyps_t, best), _at(pts, best), _at(good, best)


def reconstruct_h(H21, xy1, xy2, inliers, K, sigma: float = 1.0,
                  min_parallax: float = 1.0, min_triangulated: int = 50):
    """H -> the best of Faugeras' 8 hypotheses (ReconstructH,
    src/Initializer.cc:776-983) -> (ok, R, t, points, good)."""
    hyps_R, hyps_t, degenerate = _faugeras_hypotheses(
        torch.linalg.inv_ex(K)[0] @ H21 @ K)
    checked = check_rt(hyps_R, hyps_t, xy1, xy2, inliers, K, sigma * sigma)
    return _select_h(hyps_R, hyps_t, degenerate, checked, inliers, min_parallax,
                     min_triangulated)


class TwoViewResult(NamedTuple):
    ok: torch.Tensor             # bool scalar
    used_homography: torch.Tensor
    R21: torch.Tensor            # [3, 3] camera-2-from-camera-1 rotation
    t21: torch.Tensor            # [3] unit-norm translation
    points: torch.Tensor         # [N, 3] triangulated, camera-1 frame
    good: torch.Tensor           # [N] bool triangulation mask


def _models_reconstruct(xy1, xy2, valid, K, T1, T2, T2inv, H_best, F_best, sh_best,
                        sf_best, Vh, Uf, Sf, Vhf, key):
    """Stage 3: the models (_models_finish), then the normalized H and E
    -> (the models, K^-1 H K, K^T F K)."""
    m = _models_finish(xy1, xy2, valid, T1, T2, T2inv, H_best, F_best, sh_best, sf_best,
                       Vh, Uf, Sf, Vhf, key[0])
    return m, torch.linalg.inv_ex(K)[0] @ m.H21 @ K, K.T @ m.F21 @ K


def _hypotheses(xy1, xy2, inliers_h, inliers_f, K, UA, dA, VhA, UE, VhE, key):
    """Stage 4: both models' hypotheses and their triangulations' A^T A."""
    hyps_h = _faugeras_svd(UA, dA, VhA)
    hyps_f = _hypotheses_f(UE, VhE)
    return (hyps_h, hyps_f, _check_rt_normals(*hyps_h[:2], xy1, xy2, K),
            _check_rt_normals(*hyps_f, xy1, xy2, K))


def _two_view_finish(xy1, xy2, K, models, hyps_h, hyps_f, V_h, V_f, key):
    """Stage 5: both reconstructions checked and chosen, then the model
    (Initializer::Initialize's choice) -> TwoViewResult."""
    sigma, min_parallax, min_triangulated = key
    inl_h, inl_f = models.inliers_h, models.inliers_f
    ok_h, R_h, t_h, pts_h, good_h = _select_h(
        *hyps_h, _check_rt_gates(*hyps_h[:2], xy1, xy2, inl_h, K, V_h, sigma * sigma),
        inl_h, min_parallax, min_triangulated)
    ok_f, R_f, t_f, pts_f, good_f = _select_f(
        *hyps_f, _check_rt_gates(*hyps_f, xy1, xy2, inl_f, K, V_f, sigma * sigma),
        inl_f, min_parallax, min_triangulated)
    rh = models.score_h / torch.clamp_min(models.score_h + models.score_f, 1e-9)
    use_h = rh > 0.40
    sel_h = use_h & (ok_h | (rh > 0.45))
    return TwoViewResult(
        ok=torch.where(sel_h, ok_h, ok_f),
        used_homography=sel_h,
        R21=torch.where(sel_h, R_h, R_f),
        t21=torch.where(sel_h, t_h, t_f),
        points=torch.where(sel_h, pts_h, pts_f),
        good=torch.where(sel_h, good_h, good_f),
    )


def _two_view(samples, xy1, xy2, valid, K, key) -> TwoViewResult:
    """The bootstrap's five stages through utils/cuda_graph.call, with the
    eigensolves and SVDs between them."""
    parts = _find_models(samples, xy1, xy2, valid, key)
    models, A, E = cuda_graph.call(_models_reconstruct, (xy1, xy2, valid, K) + parts, key)
    UE, _, VhE = linalg.svd(E)
    hyps_h, hyps_f, normal_h, normal_f = cuda_graph.call(
        _hypotheses, (xy1, xy2, models.inliers_h, models.inliers_f, K)
        + tuple(linalg.svd(A)) + (UE, VhE), key)
    _, V_h = linalg.eigh(normal_h)
    _, V_f = linalg.eigh(normal_f)
    return cuda_graph.call(_two_view_finish,
                           (xy1, xy2, K, models, hyps_h, hyps_f, V_h, V_f), key)


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
    package's marginal-H fallback, beyond the reference). The stages of
    initialize_two_view_jit, run eagerly on any device."""
    with cuda_graph.eager():
        return _two_view(samples, xy1, xy2, valid, K, (sigma, min_parallax, min_triangulated))


@full_float32
def initialize_two_view_jit(
    samples: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    sigma: float = 1.0,
    min_parallax: float = 1.0,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """initialize_two_view with each stage through utils/cuda_graph.call:
    on the card five replays around six eigensolves and four SVDs,
    eagerly on the CPU."""
    return _two_view(samples, xy1, xy2, valid, K, (sigma, min_parallax, min_triangulated))


# The functions initialize_two_view_jit captures (cuda_graph.release's owners).
GRAPHED = (_models_start, _models_best, _models_reconstruct, _hypotheses, _two_view_finish)
