"""Pose-only bundle adjustment (PyTorch port of optim/pose_opt.py).

`pose_optimization` launches the one-kernel LM (K8, kernels/pose_lm.py)
on CUDA tensors and runs `pose_optimization_plain`, the masked PyTorch LM
below, on CPU tensors. The plain version is K8's oracle.

Replaces Optimizer::PoseOptimization (src/Optimizer.cc:287-528): unary
reprojection edges, Huber kernels, 4 rounds x 10 Levenberg-Marquardt
iterations with chi2 inlier reclassification between rounds (5.991 mono /
7.815 stereo) and the robust kernel off for the final round.

Control flow without host synchronisation: the JAX package's early-exit
while loop and its round skip become loops of fixed length whose every
update is masked. An iteration runs its arithmetic always and keeps the
result only while the loop would still be running
(`~converged & lam < 1e8`), so a state that has stopped stays exactly as
the early-exit loop leaves it; a skipped round keeps its input state.
On CPU tensors, where a host read costs nothing, the loop stops and the
round is skipped as soon as every later update would be masked out: the
same results, without the work.

`pose_optimization_jit` is the single-dispatch form (the JAX package's
jitted namesake, the same arguments): on CUDA tensors one replay of a
CUDA graph holding the K8 launch (utils/cuda_graph.py; the camera
constants and the loop counts are part of its key), on CPU tensors
`pose_optimization` run eagerly. The staged tracker calls it; the fused
tracker's graphs call `pose_optimization` inside their own captures.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.optim import residuals as res
from orb_slam2_commit_tpu_torch.optim.residuals import (
    BAObservations, CHI2_MONO, CHI2_STEREO,
)
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor   # [N] bool — the final chi2 classification
    n_inliers: torch.Tensor


def _robust_cost(chi2, delta2, active, use_robust: bool):
    """Huber-composed total cost used for LM accept/reject."""
    if use_robust:
        sqrt_c = torch.sqrt(torch.clamp_min(chi2, 1e-12))
        delta = torch.sqrt(delta2)
        rho = torch.where(chi2 <= delta2, chi2, 2.0 * delta * sqrt_c - delta2)
    else:
        rho = chi2
    return torch.sum(torch.where(active, rho, torch.zeros_like(rho)))


def _eval(R, t, points, obs, cam_params, use_robust, active):
    fx, fy, cx, cy, bf = cam_params
    n = points.shape[0]
    pred, J_pose, _, z = res.project_with_jacobians(
        R.expand(n, 3, 3), t.expand(n, 3), points, fx, fy, cx, cy, bf
    )
    e, w, chi2 = res.residuals_and_weights(
        pred, z, obs._replace(valid=active), use_robust)
    return e, w, chi2, J_pose, z


def stops_early(t: torch.Tensor) -> bool:
    """Whether the loops read their stop conditions on the host: on CPU
    tensors (no device to wait for)."""
    return t.device.type == "cpu"


def _lm_rounds(R0, t0, points, obs, cam_params, active, use_robust, n_iters):
    """n_iters of Levenberg-Marquardt on the 6-dof pose -> (R, t, settled)."""
    delta2 = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(points.dtype)
    # Convergence threshold on |delta|^2, dtype-aware: float32 LM stalls
    # around |delta| ~ 1e-6, so 1e-16 is reachable only in float64.
    step_eps = 1e-16 if R0.dtype == torch.float64 else 1e-10
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)

    def full_eval(R, t):
        e, w, chi2, J, z = _eval(R, t, points, obs, cam_params, use_robust, active)
        cost = _robust_cost(chi2, delta2, active & (z > 0), use_robust)
        return e, w, J, cost

    R, t = R0, t0
    lam = torch.full((), 1e-3, dtype=R0.dtype, device=R0.device)
    e, w, J, cost = full_eval(R, t)
    converged = torch.zeros((), dtype=torch.bool, device=R0.device)
    early = stops_early(R0)
    for _ in range(n_iters):
        running = ~converged & (lam < 1e8)
        if early and not bool(running):
            break
        # H = sum J^T diag(w) J; b = sum J^T diag(w) e.
        Jw = J * w[..., None]                        # [O, 3, 6]
        H = torch.einsum("ora,orb->ab", Jw, J)
        b = torch.einsum("ora,or->a", Jw, e)
        H_lm = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
        delta = -linalg.chol_solve_spd(H_lm, b)
        dR, dt = lie.se3_exp(delta)
        R_new = dR @ R
        t_new = dR @ t + dt
        e_new, w_new, J_new, new_cost = full_eval(R_new, t_new)
        # A failed factor gives a NaN step, whose projections fail every
        # depth gate and so cost nothing: reject it explicitly.
        accept = (new_cost < cost) & torch.isfinite(delta).all()
        keep = running & accept
        R = torch.where(keep, R_new, R)
        t = torch.where(keep, t_new, t)
        lam = torch.where(running, torch.where(accept, lam * 0.5, lam * 4.0), lam)
        cost = torch.where(keep, new_cost, cost)
        e = torch.where(keep, e_new, e)
        w = torch.where(keep, w_new, w)
        J = torch.where(keep, J_new, J)
        converged = torch.where(
            running, accept & (torch.sum(delta * delta) < step_eps), converged)
    # "Settled" = stopped on convergence or a fully stalled damping ladder,
    # as opposed to running out of the iteration budget.
    settled = converged | (lam >= 1e8)
    return R, t, settled


def pose_optimization(
    R0: torch.Tensor,
    t0: torch.Tensor,
    points: torch.Tensor,
    obs: BAObservations,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float,
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """Optimize Tcw = (R0, t0) against world points [N, 3]: K8 on the
    card, the plain version on the CPU (kernels/pose_lm.pose_lm)."""
    from orb_slam2_commit_tpu_torch.kernels import pose_lm

    return pose_lm.pose_lm(R0.contiguous(), t0.contiguous(), points.contiguous(),
                           obs, fx, fy, cx, cy, bf, n_rounds, iters_per_round)


def _pose(R0, t0, points, obs, key) -> PoseOptResult:
    return pose_optimization(R0, t0, points, obs, *key)


@full_float32
def pose_optimization_jit(
    R0: torch.Tensor,
    t0: torch.Tensor,
    points: torch.Tensor,
    obs: BAObservations,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float,
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """pose_optimization through utils/cuda_graph.call: one replay (one K8
    launch) on the card, eagerly on the CPU."""
    return cuda_graph.call(_pose, (R0, t0, points, obs),
                           (fx, fy, cx, cy, bf, n_rounds, iters_per_round))


# The functions pose_optimization_jit captures (cuda_graph.release's owners).
GRAPHED = (_pose,)


@full_float32
def pose_optimization_plain(
    R0: torch.Tensor,
    t0: torch.Tensor,
    points: torch.Tensor,
    obs: BAObservations,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float,
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """Optimize Tcw = (R0, t0) against world points [N, 3].

    obs.cam_idx/pt_idx are ignored (unary edges, one camera); obs.valid is
    the match mask. Each round refits on the current inlier set, then
    reclassifies all observations (outliers can return)."""
    cam_params = (fx, fy, cx, cy, bf)
    delta2 = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(points.dtype)

    def run_round(rnd, R, t, active):
        use_robust = rnd < n_rounds - 1
        R, t, settled = _lm_rounds(
            R, t, points, obs, cam_params, active, use_robust, iters_per_round
        )
        _, _, chi2, _, z = _eval(
            R, t, points, obs, cam_params, use_robust, obs.valid
        )
        inl = obs.valid & (chi2 <= delta2) & (z > 0)
        return R, t, inl, settled

    R, t, inliers, settled = run_round(0, R0, t0, obs.valid)
    prev_active = obs.valid
    for rnd in range(1, n_rounds):
        # A round whose active set equals the previous round's and whose
        # starting pose already settled changes nothing: keep its input.
        active = inliers
        skip = settled & torch.all(active == prev_active)
        if stops_early(R0) and bool(skip):
            continue
        R_n, t_n, inl_n, settled_n = run_round(rnd, R, t, active)
        R = torch.where(skip, R, R_n)
        t = torch.where(skip, t, t_n)
        inliers = torch.where(skip, active, inl_n)
        settled = skip | settled_n
        prev_active = active

    return PoseOptResult(R=R, t=t, inliers=inliers, n_inliers=torch.sum(inliers))
