"""Bundle adjustment with Schur-complement marginalization of points
(PyTorch port of optim/ba.py; replaces g2o's BlockSolver + LM as used by
Optimizer::LocalBundleAdjustment / BundleAdjustment, src/Optimizer.cc:530-885,
:41-284).

The problem is dense fixed-shape tensors on one device:

  Hcc [K, 6, 6]   camera diagonal blocks   (segment sums over observations)
  Hpp [P, 3, 3]   point diagonal blocks    (segment sums)
  Hcp [O, 6, 3]   camera-point block of each observation
  S = Hcc - sum_p W_p Hpp^-1 W_p^T         (dense [6K, 6K], point chunks)
  S dc = -(g_c - W Hpp^-1 g_p)             (dense solve)
  dp = -Hpp^-1 (g_p + W^T dc)              (back-substitution)

or, from 64 cameras on ("auto"), the implicit-Schur preconditioned CG
(`_schur_pcg`) that never forms S. Levenberg-Marquardt accept/reject as in
the JAX package, and a non-finite step rejected; its early exit reads the
convergence flag on the host once per iteration. Fixed poses get zeroed
Jacobians.

With a `group` (a torch.distributed process group; the JAX package's
`axis_name`), each rank holds a block of the observations
(parallel/distributed_ba.py) and its partial sums are all-reduced over the
group wherever the JAX package calls `psum`, so every rank takes the same
step. With `point_sharded=True` each rank also owns a block of the points
and every observation of them: the point-side sums stay local and only
camera-shaped sums cross ranks. `_Sums` names, once per solve, which sums
cross ranks. Every flag the host reads (the LM's accept and exit tests,
the CG's residual test) comes from reduced or replicated values, so all
ranks take the same branch. With no group nothing is reduced.

The segment sums over observations (per camera, per point, and per
(camera, point) slot of the Schur chunks' W, where a keyframe that binds
one point to several features puts several observations) add in an order
fixed by the problem (optim/segment.py: the maps sorted once per solve,
rows with `obs.valid` False left out, since their weights are 0), so a
solve gives the same bits on every run on the card.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.optim import residuals as res
from orb_slam2_commit_tpu_torch.optim.segment import Segments, segment_sum, segments
from orb_slam2_commit_tpu_torch.optim.residuals import (
    BAObservations, CHI2_MONO, CHI2_STEREO,
)
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. K poses, P points, O observations."""

    R: torch.Tensor          # [K, 3, 3] Tcw rotations
    t: torch.Tensor          # [K, 3]
    fixed: torch.Tensor      # [K] bool — poses held constant
    points: torch.Tensor     # [P, 3]
    point_valid: torch.Tensor  # [P] bool
    obs: BAObservations


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor       # [O] final per-observation chi2
    inlier: torch.Tensor     # [O] chi2 <= threshold & positive depth
    cost: torch.Tensor


def _evaluate(problem: BAProblem, cam_params, use_robust, active):
    fx, fy, cx, cy, bf = cam_params
    obs = problem.obs
    cam = obs.cam_idx.long()
    pt = obs.pt_idx.long()
    pred, J_pose, J_point, z = res.project_with_jacobians(
        problem.R[cam], problem.t[cam], problem.points[pt], fx, fy, cx, cy, bf)
    e, w, chi2 = res.residuals_and_weights(
        pred, z, obs._replace(valid=active), use_robust)
    zero = torch.zeros((), dtype=J_pose.dtype, device=J_pose.device)
    J_pose = torch.where(problem.fixed[cam][:, None, None], zero, J_pose)
    J_point = torch.where(problem.point_valid[pt][:, None, None], J_point, zero)
    return e, w, chi2, J_pose, J_point, z


def _robust_total_cost(chi2, delta2, active, use_robust: bool):
    if use_robust:
        sqrt_c = torch.sqrt(torch.clamp_min(chi2, 1e-12))
        delta = torch.sqrt(delta2)
        rho = torch.where(chi2 <= delta2, chi2, 2.0 * delta * sqrt_c - delta2)
    else:
        rho = chi2
    return torch.sum(torch.where(active, rho, torch.zeros_like(rho)))


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group's ranks (JAX's psum); x itself with no group."""
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


class _Sums(NamedTuple):
    """Where a sharded solve's partial sums meet (the JAX package's psum
    sites), each the identity with no group:
    cam: camera-shaped sums and the cost, over the group;
    pt: point-shaped sums, over the group unless each rank owns its points
        (then every observation of a point is on its rank);
    own: a sum over the points each rank owns (the point step's norm), over
        the group only then (replicated points would count n times)."""

    cam: Callable[[torch.Tensor], torch.Tensor]
    pt: Callable[[torch.Tensor], torch.Tensor]
    own: Callable[[torch.Tensor], torch.Tensor]


def _sums(group, point_sharded: bool) -> _Sums:
    pts = None if point_sharded else group
    own = group if point_sharded else None
    return _Sums(partial(_psum, group=group), partial(_psum, group=pts),
                 partial(_psum, group=own))


_LOCAL = _sums(None, False)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    adj = torch.stack([
        torch.stack([A, B, C], dim=-1),
        torch.stack([D, E, F], dim=-1),
        torch.stack([G, H, I], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


class ObsSegments(NamedTuple):
    """The observations of each camera, of each point and, per chunk of
    point_chunk points, of each (camera, point) slot of the chunk
    (optim/segment.py); no chunks for the PCG solver."""

    cam: Segments
    pt: Segments
    chunks: Tuple[Segments, ...]


def obs_segments(problem: BAProblem, point_chunk: int, solver: str) -> ObsSegments:
    obs = problem.obs
    K, P = problem.R.shape[0], problem.points.shape[0]
    cam, pt = obs.cam_idx.long(), obs.pt_idx.long()
    chunks = []
    if solver == "dense":
        for lo in range(0, P, point_chunk):
            hi = min(lo + point_chunk, P)
            slot = cam * (hi - lo) + torch.clamp(pt - lo, 0, hi - lo - 1)
            chunks.append(segments(slot, K * (hi - lo), obs.valid & (pt >= lo) & (pt < hi)))
    return ObsSegments(segments(cam, K, obs.valid), segments(pt, P, obs.valid), tuple(chunks))


def _schur_pcg(Hcc_d, Hpp_inv, Hcp_o, cam, pt, segs: ObsSegments, b, fixed,
               n_iters: int = 64, tol: float = 1e-8, sums: _Sums = _LOCAL):
    """Solve S dc = b with S = Hcc_d - W Hpp^-1 W^T without forming S or W:
    the matvec streams over observations (two segment sums, two batched
    small products), block-Jacobi preconditioned by Hcc_d^-1 ("Bundle
    Adjustment in the Large", implicit Schur)."""
    def S_mv(x):                      # x [K, 6]
        y = torch.einsum("kab,kb->ka", Hcc_d, x)
        u = sums.pt(segment_sum(torch.einsum("oab,oa->ob", Hcp_o, x[cam]), segs.pt))
        v = torch.einsum("pab,pb->pa", Hpp_inv, u)
        y2 = sums.cam(segment_sum(torch.einsum("oab,ob->oa", Hcp_o, v[pt]), segs.cam))
        return y - y2

    M_inv = torch.linalg.inv(Hcc_d)

    def precond(r):
        return torch.einsum("kab,kb->ka", M_inv, r)

    def safe(den):
        return torch.where(torch.abs(den) > 1e-30, den, torch.full_like(den, 1e-30))

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    b_norm2 = torch.clamp_min(torch.sum(b * b), 1e-30)
    for _ in range(n_iters):
        if not bool(torch.sum(r * r) > tol * b_norm2):
            break
        Sp = S_mv(p)
        alpha = rz / safe(torch.sum(p * Sp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / safe(rz)) * p
        rz = rz_new
    return torch.where(fixed[:, None], torch.zeros_like(x), x)


def _solve_step(problem: BAProblem, segs: ObsSegments, cam_params, use_robust, active, lam,
                point_chunk: int, solver: str = "dense", sums: _Sums = _LOCAL):
    """One damped Gauss-Newton step -> (delta_c [K, 6], delta_p [P, 3])."""
    K = problem.R.shape[0]
    P = problem.points.shape[0]
    cam = problem.obs.cam_idx.long()
    pt = problem.obs.pt_idx.long()
    dtype, dev = problem.points.dtype, problem.points.device

    e, w, chi2, Jc, Jp, z = _evaluate(problem, cam_params, use_robust, active)
    Jc_w = Jc * w[..., None]
    Jp_w = Jp * w[..., None]
    Hcc = segment_sum(torch.einsum("ora,orb->oab", Jc_w, Jc), segs.cam)
    Hpp = segment_sum(torch.einsum("ora,orb->oab", Jp_w, Jp), segs.pt)
    g_c = segment_sum(torch.einsum("ora,or->oa", Jc_w, e), segs.cam)
    g_p = segment_sum(torch.einsum("ora,or->oa", Jp_w, e), segs.pt)
    Hcc, g_c, Hpp, g_p = sums.cam(Hcc), sums.cam(g_c), sums.pt(Hpp), sums.pt(g_p)

    # LM damping (diagonal scaling) + tiny Tikhonov for rank safety.
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    # Cameras with no active observation get an identity block; their
    # gradient is zero, so their update is exactly zero.
    cam_unused = torch.abs(Hcc).sum(dim=(1, 2)) == 0
    Hcc_d = torch.where(cam_unused[:, None, None], eye6, Hcc_d)
    Hpp_inv = _inv3x3(Hpp_d)
    Hcp_o = torch.einsum("ora,orb->oab", Jc_w, Jp)          # [O, 6, 3]
    zero = torch.zeros((), dtype=dtype, device=dev)

    if solver == "pcg":
        v = torch.einsum("pab,pb->pa", Hpp_inv, g_p)
        b_corr = sums.cam(segment_sum(torch.einsum("oab,ob->oa", Hcp_o, v[pt]), segs.cam))
        delta_c = _schur_pcg(Hcc_d, Hpp_inv, Hcp_o, cam, pt, segs, -(g_c - b_corr),
                             problem.fixed, sums=sums)
    else:
        # Schur reduction over point chunks: W [K, chunk, 6, 3] per chunk.
        S_corr = torch.zeros((K, 6, K, 6), dtype=dtype, device=dev)
        b_corr = torch.zeros((K, 6), dtype=dtype, device=dev)
        for lo, chunk in zip(range(0, P, point_chunk), segs.chunks):
            hi = min(lo + point_chunk, P)
            W = sums.pt(segment_sum(Hcp_o, chunk)).reshape(K, hi - lo, 6, 3)
            Y = torch.einsum("kpab,pbc->kpac", W, Hpp_inv[lo:hi])
            S_corr = S_corr + torch.einsum("kpac,lpdc->kald", Y, W)
            b_corr = b_corr + torch.einsum("kpac,pc->ka", Y, g_p[lo:hi])
        S = -S_corr
        ar = torch.arange(K, device=dev)
        S[ar, :, ar, :] += Hcc_d
        # solve_ex reports a singular system instead of raising (the card
        # raises where the CPU returns inf); its step is then NaN, which
        # bundle_adjust rejects.
        sol, info = torch.linalg.solve_ex(S.reshape(K * 6, K * 6),
                                          (g_c - b_corr).reshape(K * 6))
        delta_c = -torch.where(info == 0, sol, torch.nan).reshape(K, 6)
        delta_c = torch.where(problem.fixed[:, None], zero, delta_c)

    Hpc_dc = sums.pt(segment_sum(torch.einsum("oab,oa->ob", Hcp_o, delta_c[cam]), segs.pt))
    delta_p = -torch.einsum("pab,pb->pa", Hpp_inv, g_p + Hpc_dc)
    delta_p = torch.where(problem.point_valid[:, None], delta_p, zero)
    return delta_c, delta_p


def _apply_step(problem: BAProblem, delta_c, delta_p) -> BAProblem:
    dR, dt = lie.se3_exp(delta_c)
    return problem._replace(
        R=dR @ problem.R,
        t=torch.einsum("kij,kj->ki", dR, problem.t) + dt,
        points=problem.points + delta_p,
    )


@full_float32
def bundle_adjust(
    problem: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    n_iters: int = 10,
    use_robust: bool = True,
    point_chunk: int = 1024,
    lam0: float = 1e-4,
    solver: str = "auto",
    group: Optional[dist.ProcessGroup] = None,
    point_sharded: bool = False,
) -> Tuple[BAProblem, BAResult]:
    """Run up to n_iters of LM -> (updated problem, diagnostics).

    solver: "dense" forms the Schur complement and solves it (exact, for
    local-BA-sized problems), "pcg" runs implicit Schur + preconditioned
    CG, "auto" takes pcg from 64 cameras on. The loop stops early on a
    converged step (|delta|^2 under 1e-10 in float32, 1e-16 in float64)
    or when the damping passes 1e8, as g2o does.

    group: this rank's block of a problem sharded over a process group
    (see the module docstring); point_sharded=True (the points' block too)
    takes pcg, since the dense route would build a replicated [6K, 6K].
    chi2 and inlier are this rank's observations'."""
    if point_sharded:
        solver = "pcg"
    elif solver == "auto":
        solver = "pcg" if problem.R.shape[0] >= 64 else "dense"
    cam_params = (fx, fy, cx, cy, bf)
    sums = _sums(group, point_sharded)
    obs = problem.obs
    dtype = problem.points.dtype
    delta2 = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(dtype)
    active = obs.valid
    point_chunk = min(point_chunk, problem.points.shape[0])
    step_eps = 1e-16 if dtype == torch.float64 else 1e-10

    def cost_of(p: BAProblem):
        _, _, chi2, _, _, z = _evaluate(p, cam_params, use_robust, active)
        return sums.cam(_robust_total_cost(chi2, delta2, active & (z > 0), use_robust))

    segs = obs_segments(problem, point_chunk, solver)
    lam = 1.0 * lam0
    cost = cost_of(problem)
    for _ in range(n_iters):
        if lam >= 1e8:
            break
        delta_c, delta_p = _solve_step(
            problem, segs, cam_params, use_robust, active,
            torch.tensor(lam, dtype=dtype, device=problem.points.device),
            point_chunk, solver, sums)
        p_new = _apply_step(problem, delta_c, delta_p)
        new_cost = cost_of(p_new)
        step_sq = torch.sum(delta_c * delta_c) + sums.own(torch.sum(delta_p * delta_p))
        # A failed solve (a singular Schur system in float32) gives a
        # non-finite step; its projections then fail every depth gate, so
        # its cost reads 0. Such a step is rejected, never accepted.
        accept, small = (bool(v) for v in torch.stack(
            [(new_cost < cost) & torch.isfinite(step_sq), step_sq < step_eps]).cpu())
        if accept:
            problem, cost = p_new, new_cost
            lam = lam * 0.5
            if small:
                break
        else:
            lam = lam * 4.0

    _, _, chi2, _, _, z = _evaluate(problem, cam_params, use_robust, active)
    inlier = active & (chi2 <= delta2) & (z > 0)
    return problem, BAResult(R=problem.R, t=problem.t, points=problem.points,
                             chi2=chi2, inlier=inlier, cost=cost)


def local_bundle_adjust(
    problem: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    first_iters: int = 5,
    second_iters: int = 10,
    point_chunk: int = 1024,
) -> Tuple[BAProblem, BAResult]:
    """The reference's two-stage local BA (src/Optimizer.cc:737-782): 5
    robust iterations, drop chi2 outliers and negative depths, 10 more
    without the robust kernel. The host erases the observations flagged
    not inlier (:838-861)."""
    problem, r1 = bundle_adjust(problem, fx, fy, cx, cy, bf, n_iters=first_iters,
                                use_robust=True, point_chunk=point_chunk)
    problem = problem._replace(obs=problem.obs._replace(valid=r1.inlier))
    return bundle_adjust(problem, fx, fy, cx, cy, bf, n_iters=second_iters,
                         use_robust=False, point_chunk=point_chunk)
