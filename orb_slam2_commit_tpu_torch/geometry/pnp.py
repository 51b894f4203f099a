"""EPnP + RANSAC: absolute pose from 3D-2D correspondences (PyTorch port of
geometry/pnp.py; reference: src/PnPsolver.cc), used by relocalization
(src/Tracking.cc:1653-1884).

Every round of every candidate runs as one batch. EPnP per sample
(Lepetit et al. 2009):
  1. control points = centroid + principal axes      (:420-460)
  2. barycentric coordinates of each point            (:462-490)
  3. M [2n, 12]; the 4 smallest eigenvectors of M^T M (:492-533)
  4. betas from L beta = rho, three cases, each refined by Gauss-Newton
     (:746-837, :919-937)
  5. R, t by Horn alignment of the control points     (:640-702)
and the case with the least reprojection error wins. The sample sets are
an input ([..., n_iters, 4] indices), drawn on the host by
`geometry/ransac.py`. Plain PyTorch; leading dimensions broadcast.

The solve runs in four stages around its library calls, which read their
status on the host: the control points' eigensolve, M^T M's eigensolve
and the three beta cases' Horn SVDs (one batched call). `epnp_ransac_many_jit` is the
single-dispatch form (the JAX package's jitted namesake, the same
arguments): on CUDA tensors each stage is one replay of a CUDA graph
(utils/cuda_graph.py) with those calls between them, on CPU tensors the
same stages run eagerly; `epnp_ransac_many` runs them eagerly on any
device (cuda_graph.eager). The relocalization of the tracker calls the
form.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.geometry.ransac import first_argmax
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.device_cache import device_table
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

# The columns of L each beta case solves for, cached on each device: a
# list index would be copied from the host at each call, which a capture
# refuses.
_columns = device_table(lambda cols: np.asarray(cols, np.int64))


def _finite(A: torch.Tensor):
    """(A with each non-finite [..., r, c] matrix replaced by the identity
    pattern, the [...] mask of matrices that were finite). PyTorch's
    eigensolver and SVD raise on a non-finite input where jnp's return
    NaNs: the caller gives those problems a NaN pose instead."""
    ok = torch.all(torch.isfinite(A.flatten(-2)), dim=-1)
    eye = torch.eye(A.shape[-2], A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None, None], A, eye), ok


def _spread(X: torch.Tensor) -> torch.Tensor:
    """X [..., n, 3] -> its [..., 3, 3] covariance, whose eigenvectors are
    the control points' axes."""
    n = X.shape[-2]
    Xc = X - torch.mean(X, dim=-2)[..., None, :]
    return Xc.transpose(-1, -2) @ Xc / n


def _control_points(X: torch.Tensor, w: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """X [..., n, 3] and the eigenpairs (w ascending, V) of _spread(X) ->
    [..., 4, 3] control points: the centroid and the principal axes
    scaled by the square roots of their eigenvalues, largest first
    (choose_control_points, src/PnPsolver.cc:420-460)."""
    c0 = torch.mean(X, dim=-2)
    k = torch.sqrt(torch.clamp_min(w, 1e-12))
    return torch.stack([c0, c0 + k[..., 2, None] * V[..., :, 2],
                        c0 + k[..., 1, None] * V[..., :, 1],
                        c0 + k[..., 0, None] * V[..., :, 0]], dim=-2)


def _barycentric(X: torch.Tensor, cws: torch.Tensor) -> torch.Tensor:
    """[..., n, 4] barycentric coordinates of X against the control points
    (compute_barycentric_coordinates, src/PnPsolver.cc:462-490)."""
    CC = (cws[..., 1:, :] - cws[..., :1, :]).transpose(-1, -2)
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    CC_inv = torch.linalg.inv_ex(CC + 1e-12 * eye)[0]
    a = (X - cws[..., :1, :]) @ CC_inv.transpose(-1, -2)
    return torch.cat([1.0 - torch.sum(a, dim=-1, keepdim=True), a], dim=-1)


def _build_M(alphas, uv, fx, fy, cx, cy) -> torch.Tensor:
    """[..., 2n, 12] (fill_M, src/PnPsolver.cc:492-507): for control point j
    the unknowns are its 3 camera coordinates; per observation the rows
    (a fx, 0, a (cx - u)) and (0, a fy, a (cy - v))."""
    u, v = uv[..., 0, None], uv[..., 1, None]
    zero = torch.zeros_like(alphas)
    Mu = torch.stack([alphas * fx, zero, alphas * (cx - u)], dim=-1)
    Mv = torch.stack([zero, alphas * fy, alphas * (cy - v)], dim=-1)
    lead = alphas.shape[:-1]
    return torch.cat([Mu.reshape(lead + (12,)), Mv.reshape(lead + (12,))], dim=-2)


def _rho(cws: torch.Tensor) -> torch.Tensor:
    """[..., 6] squared distances between the world control points."""
    return torch.stack([torch.sum((cws[..., a, :] - cws[..., b, :]) ** 2, dim=-1)
                        for a, b in _PAIRS], dim=-1)


def _L6x10(V: torch.Tensor) -> torch.Tensor:
    """[..., 6, 10] distance-constraint matrix of the 4 null vectors V
    [..., 4, 4, 3] (V[k, j]: control point j in eigenvector k; compute_L_6x10,
    src/PnPsolver.cc:839-879). Beta order: b11 b12 b22 b13 b23 b33 b14 b24
    b34 b44."""
    rows = []
    for a, b in _PAIRS:
        d = V[..., :, a, :] - V[..., :, b, :]                 # [..., 4, 3]

        def dot(i, j):
            return torch.sum(d[..., i, :] * d[..., j, :], dim=-1)

        rows.append(torch.stack([
            dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2),
            dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)], dim=-1))
    return torch.stack(rows, dim=-2)


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Small least squares by the normal equations."""
    At = A.transpose(-1, -2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(At @ A + 1e-9 * eye, (At @ b[..., None]))[0][..., 0]


def _nonzero(x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, x, torch.full_like(x, 1e-12))


def _betas_case1(L, rho):
    """Columns b11 b12 b13 b14 -> betas."""
    x = _lstsq(L[..., _columns(L.device, (0, 1, 3, 6))], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    d = _nonzero(b1, torch.abs(b1) > 1e-12)
    return torch.stack([b1, x[..., 1] / d, x[..., 2] / d, x[..., 3] / d], dim=-1)


def _signed_b2(x):
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    b2 = torch.sqrt(torch.abs(x[..., 2])) * torch.where(x[..., 1] < 0, -1.0, 1.0)
    return b1, torch.where(x[..., 0] < 0, -b2, b2)


def _betas_case2(L, rho):
    """Columns b11 b12 b22 -> betas (b3 = b4 = 0)."""
    b1, b2 = _signed_b2(_lstsq(L[..., _columns(L.device, (0, 1, 2))], rho))
    zero = torch.zeros_like(b1)
    return torch.stack([b1, b2, zero, zero], dim=-1)


def _betas_case3(L, rho):
    """Columns b11 b12 b22 b13 b23 -> betas (b4 = 0)."""
    x = _lstsq(L[..., _columns(L.device, (0, 1, 2, 3, 4))], rho)
    b1, b2 = _signed_b2(x)
    b3 = x[..., 3] / _nonzero(b1, b1 > 1e-12)
    return torch.stack([b1, b2, b3, torch.zeros_like(b1)], dim=-1)


def _b10(b: torch.Tensor) -> torch.Tensor:
    b1, b2, b3, b4 = b.unbind(-1)
    return torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3,
                        b1 * b4, b2 * b4, b3 * b4, b4 * b4], dim=-1)


def _b10_jacobian(b: torch.Tensor) -> torch.Tensor:
    """d b10 / d b, [..., 10, 4]."""
    b1, b2, b3, b4 = b.unbind(-1)
    z = torch.zeros_like(b1)
    return torch.stack([
        torch.stack([2 * b1, z, z, z], -1), torch.stack([b2, b1, z, z], -1),
        torch.stack([z, 2 * b2, z, z], -1), torch.stack([b3, z, b1, z], -1),
        torch.stack([z, b3, b2, z], -1), torch.stack([z, z, 2 * b3, z], -1),
        torch.stack([b4, z, z, b1], -1), torch.stack([z, b4, z, b2], -1),
        torch.stack([z, z, b4, b3], -1), torch.stack([z, z, z, 2 * b4], -1),
    ], dim=-2)


def _gauss_newton_betas(L, rho, betas, iters: int = 5):
    """Refine the betas on ||L b10(beta) - rho||^2 (gauss_newton,
    src/PnPsolver.cc:919-937)."""
    eye = torch.eye(4, dtype=betas.dtype, device=betas.device)
    for _ in range(iters):
        r = (L @ _b10(betas)[..., None])[..., 0] - rho
        J = L @ _b10_jacobian(betas)
        Jt = J.transpose(-1, -2)
        step = torch.linalg.solve_ex(Jt @ J + 1e-9 * eye, Jt @ r[..., None])[0][..., 0]
        betas = betas - step
    return betas


def _horn_cov(pw: torch.Tensor, pc: torch.Tensor):
    """Rigid alignment camera <- world from paired points [..., n, 3]
    (estimate_R_and_t, src/PnPsolver.cc:640-702), before its SVD -> (the
    [..., 3, 3] cross-covariance, made finite, and the [...] mask of
    finite ones)."""
    cw = torch.mean(pw, dim=-2)
    cc = torch.mean(pc, dim=-2)
    return _finite((pc - cc[..., None, :]).transpose(-1, -2) @ (pw - cw[..., None, :]))


def _horn_finish(pw: torch.Tensor, pc: torch.Tensor, U: torch.Tensor, Vh: torch.Tensor):
    """The alignment from the SVD U, Vh of _horn_cov(pw, pc) -> (R, t)."""
    cw = torch.mean(pw, dim=-2)
    cc = torch.mean(pc, dim=-2)
    d = torch.linalg.det(U @ Vh)
    D = torch.ones(d.shape + (3,), dtype=U.dtype, device=U.device)
    D = torch.cat([D[..., :2], d[..., None]], dim=-1)
    R = (U * D[..., None, :]) @ Vh
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _project(X, R, t, fx, fy, cx, cy):
    """X [..., n, 3] under (R, t) [..., 3, 3], [..., 3] -> (camera z
    [..., n], u, v), z clamped to 1e-9 in magnitude for the division."""
    pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    return z, fx * pc[..., 0] / zs + cx, fy * pc[..., 1] / zs + cy


def _solve_null(X, uv, w, V, key):
    """EPnP's stage 2, after the control points' eigensolve -> (control
    points, barycentric coordinates, M^T M made finite, the finite mask).
    key starts with fx, fy, cx, cy."""
    fx, fy, cx, cy = key[:4]
    cws = _control_points(X, w, V)
    alphas = _barycentric(X, cws)
    M = _build_M(alphas, uv, fx, fy, cx, cy)
    MtM, finite = _finite(M.transpose(-1, -2) @ M)
    return cws, alphas, MtM, finite


def _solve_cases(X, cws, alphas, V, key=None):
    """EPnP's stage 3, after M^T M's eigensolve: the betas of the three
    cases, each refined by Gauss-Newton, and their camera points -> (the
    three cases' camera points [..., n, 3], Horn's cross-covariances
    [..., 3, 3] made finite, their finite masks [...]), a tuple each."""
    n = X.shape[-2]
    # The 4 smallest eigenvectors, each as 4 control-point 3-vectors.
    Vk = V[..., :, :4].transpose(-1, -2).reshape(V.shape[:-2] + (4, 4, 3))
    L = _L6x10(Vk)
    rho = _rho(cws)
    pcs, covs, oks = [], [], []
    for case in (_betas_case1, _betas_case2, _betas_case3):
        betas = _gauss_newton_betas(L, rho, case(L, rho))
        ccs = torch.einsum("...k,...kjd->...jd", betas, Vk)   # camera control points
        pc = alphas @ ccs
        # Positive depth (the eigenvectors' scale has no sign).
        flip = torch.sum(pc[..., 2] < 0, dim=-1) > n // 2
        pc = torch.where(flip[..., None, None], -pc, pc)
        cov, ok = _horn_cov(X, pc)
        pcs.append(pc)
        covs.append(cov)
        oks.append(ok)
    return tuple(pcs), tuple(covs), tuple(oks)


def _solve_pick(X, uv, finite, pcs, oks, svds, cam):
    """EPnP's stage 4, after the Horn SVDs ((U, Vh) per case): each case's
    pose and mean reprojection error, the least error's pose -> (R, t),
    NaN where not finite."""
    fx, fy, cx, cy = cam
    Rs, ts, errs = [], [], []
    for pc, ok, (U, Vh) in zip(pcs, oks, svds):
        R, t = _horn_finish(X, pc, U, Vh)
        finite = finite & ok
        _, u, v = _project(X, R, t, fx, fy, cx, cy)
        Rs.append(R)
        ts.append(t)
        errs.append(torch.mean((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2, dim=-1))
    best = first_argmax(-torch.stack(errs, dim=-1))
    R = torch.gather(torch.stack(Rs, dim=-3), -3,
                     best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(torch.stack(ts, dim=-2), -2,
                     best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    nan = torch.full_like(t, float("nan"))
    return (torch.where(finite[..., None, None], R, nan[..., None]),
            torch.where(finite[..., None], t, nan))


def _horn_svds(covs):
    """The three cases' Horn SVDs in one batched library call -> ((U,
    Vh), ...) per case. Each matrix's SVD has the same bits as in a call
    of its own (LAPACK solves each matrix alone; cuSOLVER's batched
    Jacobi SVD of the RANSAC's 3x3 matrices on an H100, checked by
    chip_smoke.py's phase_staged_graphs)."""
    U, _, Vh = linalg.svd(torch.stack(covs))
    return tuple(zip(U.unbind(0), Vh.unbind(0)))


@full_float32
def epnp_solve(X: torch.Tensor, uv: torch.Tensor, fx, fy, cx, cy
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EPnP on n >= 4 correspondences X [..., n, 3], uv [..., n, 2] -> the
    (R, t) of the beta case with the least mean reprojection error; NaN
    where the problem is degenerate enough to leave the finite numbers
    (where the JAX package's solve gives NaNs too)."""
    cam = (fx, fy, cx, cy)
    w, V = linalg.eigh(_spread(X))                       # ascending
    cws, alphas, MtM, finite = _solve_null(X, uv, w, V, cam)
    _, V = linalg.eigh(MtM)
    pcs, covs, oks = _solve_cases(X, cws, alphas, V)
    return _solve_pick(X, uv, finite, pcs, oks, _horn_svds(covs), cam)


class PnPResult(NamedTuple):
    ok: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor      # [..., n] bool
    n_inliers: torch.Tensor


def _count_inliers(X, uv, valid, sigma2, R, t, fx, fy, cx, cy, chi2_th):
    z, u, v = _project(X, R, t, fx, fy, cx, cy)
    err2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    return valid & (z > 0) & (err2 < chi2_th * sigma2)


def _ransac_gather(samples, X, uv, key):
    """Stage 1: each round's minimal sample -> (Xs [C, I, k, 3], uvs [C,
    I, k, 2], their covariances)."""
    idx = samples.long()                                        # [C, I, k]
    c = torch.arange(X.shape[0], device=X.device)
    Xs, uvs = X[c[:, None, None], idx], uv[idx]
    return Xs, uvs, _spread(Xs)


def _ransac_score(X, uv, valid, sigma2, Xs, uvs, finite, pcs, oks, svds, key):
    """Stage 4: each round's pose, its inliers, the round with the most
    (first on ties) -> PnPResult."""
    fx, fy, cx, cy, min_inliers, chi2_th = key
    R, t = _solve_pick(Xs, uvs, finite, pcs, oks, svds, key[:4])   # [C, I, ...]
    inl = _count_inliers(X[:, None], uv, valid[:, None], sigma2, R, t,
                         fx, fy, cx, cy, chi2_th)               # [C, I, n]
    best = first_argmax(torch.sum(inl, dim=-1))                # [C]
    c = torch.arange(X.shape[0], device=X.device)
    R_best, t_best = R[c, best], t[c, best]
    inliers = _count_inliers(X, uv, valid, sigma2, R_best, t_best, fx, fy, cx, cy,
                             chi2_th)
    n_in = torch.sum(inliers, dim=-1)
    return PnPResult(ok=n_in >= min_inliers, R=R_best, t=t_best, inliers=inliers,
                     n_inliers=n_in)


def _ransac(samples, X, uv, valid, sigma2, key) -> PnPResult:
    """The RANSAC's four stages, each through utils/cuda_graph.call, with
    the eigensolves and the SVD between them."""
    Xs, uvs, spread = cuda_graph.call(_ransac_gather, (samples, X, uv), key)
    w, V = linalg.eigh(spread)                                  # ascending
    cws, alphas, MtM, finite = cuda_graph.call(_solve_null, (Xs, uvs, w, V), key)
    _, V = linalg.eigh(MtM)
    pcs, covs, oks = cuda_graph.call(_solve_cases, (Xs, cws, alphas, V), key)
    return cuda_graph.call(_ransac_score, (X, uv, valid, sigma2, Xs, uvs, finite, pcs, oks,
                                           _horn_svds(covs)), key)


@full_float32
def epnp_ransac_many(
    samples: torch.Tensor,     # [C, n_iters, k] indices into the n correspondences
    X: torch.Tensor,           # [C, n, 3] per-candidate world points
    uv: torch.Tensor,          # [n, 2] the frame's pixels, shared
    valid: torch.Tensor,       # [C, n] per-candidate 2D-3D match mask
    sigma2: torch.Tensor,      # [n] per-point sigma^2 (octave-scaled)
    fx: float, fy: float, cx: float, cy: float,
    min_inliers: int = 10,
    chi2_th: float = 5.991,
) -> PnPResult:
    """EPnP RANSAC over relocalization candidates in one batch (PnPsolver::
    iterate + CheckInliers, src/PnPsolver.cc:188-301, :352-384: a point is
    an inlier when its squared reprojection error is below chi2 * sigma2;
    the round with the most inliers wins, first on ties). Leaves of the
    result carry the leading [C] axis. The stages of epnp_ransac_many_jit,
    run eagerly on any device."""
    with cuda_graph.eager():
        return _ransac(samples, X, uv, valid, sigma2, (fx, fy, cx, cy, min_inliers, chi2_th))


@full_float32
def epnp_ransac_many_jit(
    samples: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    sigma2: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    min_inliers: int = 10,
    chi2_th: float = 5.991,
) -> PnPResult:
    """epnp_ransac_many with each stage through utils/cuda_graph.call: on
    the card four replays around two eigensolves and one batched SVD,
    eagerly on the CPU."""
    return _ransac(samples, X, uv, valid, sigma2, (fx, fy, cx, cy, min_inliers, chi2_th))


# The functions epnp_ransac_many_jit captures (cuda_graph.release's owners).
GRAPHED = (_ransac_gather, _solve_null, _solve_cases, _ransac_score)
