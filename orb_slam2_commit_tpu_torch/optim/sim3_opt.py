"""Sim3 refinement: one 7-dof vertex, LM over paired projection edges
(PyTorch port of optim/sim3_opt.py; reference: Optimizer::OptimizeSim3,
src/Optimizer.cc:1220-1456).

Refines the loop's relative transform S12 by the forward (KF2's points
into image 1 through S12) and inverse (KF1's points into image 2 through
S12^-1) reprojection errors, two stages with the chi2 > 10 outliers
dropped between them (:1381-1419). The Jacobian is forward-mode autodiff
over the 7-dim tangent, as in the JAX package. Every LM step runs on the
device with no host round trip: the accept test is a select, as in the
JAX package's fori_loop. `optimize_sim3_jit` is the single-dispatch form
(the JAX package's jitted namesake, the same arguments): on CUDA tensors
both stages, their 15 iterations unrolled, are one replay of a CUDA graph
(utils/cuda_graph.py); on CPU tensors the same function runs eagerly.
The loop closer calls it on the RANSAC's pairs (padded on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

CHI2_SIM3 = 9.995  # the reference's th2 = 10 (src/Optimizer.cc:1386)


class Sim3OptResult(NamedTuple):
    s12: torch.Tensor
    R12: torch.Tensor
    t12: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _residuals(s, R, t, x1, x2, uv1, uv2, fx, fy, cx, cy):
    """Forward and backward reprojection residuals [..., n, 4] of S12 =
    (s [...], R [..., 3, 3], t [..., 3])."""

    def project(x):
        z = torch.where(torch.abs(x[..., 2]) > 1e-9, x[..., 2], torch.full_like(x[..., 2], 1e-9))
        return torch.stack([fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy], dim=-1)

    x2_in_1 = torch.einsum("...ij,...nj->...ni", R, s[..., None, None] * x2) + t[..., None, :]
    x1_in_2 = torch.einsum("...ji,...nj->...ni", R, (1.0 / s)[..., None, None]
                           * (x1 - t[..., None, :]))
    return torch.cat([uv1 - project(x2_in_1), uv2 - project(x1_in_2)], dim=-1)


def _retract(delta, s, R, t):
    """exp(delta) * (s, R, t), delta [..., 7]."""
    ds, dR, dt = lie.sim3_exp(delta)
    return (ds * s, dR @ R,
            ds[..., None] * torch.einsum("...ij,...j->...i", dR, t) + dt)


@full_float32
def optimize_sim3(
    s0: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
    x1: torch.Tensor, x2: torch.Tensor,
    uv1: torch.Tensor, uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    fix_scale: bool = False,
    n_iters: int = 10,
) -> Sim3OptResult:
    """n_iters // 2 LM iterations on every valid pair, the chi2 gate, then
    n_iters on the pairs it kept. fix_scale freezes the sigma component."""
    return _optimize(s0, R0, t0, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                     (fx, fy, cx, cy, fix_scale, n_iters))


def _optimize(s0, R0, t0, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, key):
    """optimize_sim3 on its tensors, the other arguments in key."""
    fx, fy, cx, cy, fix_scale, n_iters = key
    dtype = x1.dtype
    eye7 = torch.eye(7, dtype=dtype, device=x1.device)
    free = torch.arange(7, device=x1.device) < 6      # all but the scale

    def chi2_of(s_, R_, t_):
        e = _residuals(s_, R_, t_, x1, x2, uv1, uv2, fx, fy, cx, cy)
        return (inv_sigma2_1 * torch.sum(e[..., :2] ** 2, dim=-1),
                inv_sigma2_2 * torch.sum(e[..., 2:] ** 2, dim=-1))

    def cost_of(s_, R_, t_, active):
        c1, c2 = chi2_of(s_, R_, t_)
        return torch.sum(torch.where(active, c1 + c2, 0.0), dim=-1)

    def run_stage(s, R, t, active, iters):
        w1 = torch.sqrt(inv_sigma2_1 * active)
        w2 = torch.sqrt(inv_sigma2_2 * active)

        def weighted(delta):
            # delta [1, 7]: a batch of one keeps every value at least 1-d
            # under forward-mode autodiff.
            e = _residuals(*_retract(delta, s[None], R[None], t[None]),
                           x1, x2, uv1, uv2, fx, fy, cx, cy)[0]
            return torch.cat([e[:, :2] * w1[:, None], e[:, 2:] * w2[:, None]], 1).reshape(-1)

        # A fill, not a torch.tensor literal (a copy from the host).
        lam = torch.full((), 1e-3, dtype=dtype, device=x1.device)
        cost = cost_of(s, R, t, active > 0)
        for _ in range(iters):
            zero = torch.zeros((1, 7), dtype=dtype, device=x1.device)
            r0 = weighted(zero)
            J = torch.func.jacfwd(weighted)(zero).reshape(-1, 7)     # [4n, 7]
            H = J.T @ J
            g = J.T @ r0
            if fix_scale:
                # The scale's row and column of H those of the identity,
                # its gradient 0: selects, where an indexed store would
                # copy its value from the host.
                H = torch.where(free[:, None] & free[None, :], H, eye7)
                g = torch.where(free, g, 0.0)
            H_lm = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye7
            delta = -linalg.chol_solve_spd(H_lm, g)
            s_n, R_n, t_n = _retract(delta, s, R, t)
            new_cost = cost_of(s_n, R_n, t_n, active > 0)
            accept = new_cost < cost
            s = torch.where(accept, s_n, s)
            R = torch.where(accept, R_n, R)
            t = torch.where(accept, t_n, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, new_cost, cost)
        c1, c2 = chi2_of(s, R, t)
        return s, R, t, valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)

    s, R, t, inl = run_stage(s0, R0, t0, valid.to(dtype), n_iters // 2)
    s, R, t, inl = run_stage(s, R, t, inl.to(dtype), n_iters)
    return Sim3OptResult(s12=s, R12=R, t12=t, inliers=inl, n_inliers=torch.sum(inl))


@full_float32
def optimize_sim3_jit(
    s0: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
    x1: torch.Tensor, x2: torch.Tensor,
    uv1: torch.Tensor, uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    fix_scale: bool = False,
    n_iters: int = 10,
) -> Sim3OptResult:
    """optimize_sim3: one replay on the card, eagerly on the CPU."""
    return cuda_graph.call(_optimize, (s0, R0, t0, x1, x2, uv1, uv2, inv_sigma2_1,
                                       inv_sigma2_2, valid), (fx, fy, cx, cy, fix_scale, n_iters))


# The function optimize_sim3_jit captures (cuda_graph.release's owner).
GRAPHED = (_optimize,)
