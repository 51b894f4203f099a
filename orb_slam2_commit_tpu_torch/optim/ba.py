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
the JAX package, and a non-finite step rejected. Fixed poses get zeroed
Jacobians.

The LM and the CG are the JAX package's two while_loops, written as
bodies that change nothing once their exit test has failed (selects on
it). Two forms run them: `bundle_adjust` reads the exit tests on the host
and stops (the CPU's form); `bundle_adjust_loop` runs every iteration
with nothing read on the host, on the card as CUDA graph replays
(utils/cuda_graph.py), a sharded solve's all-reduces inside them. They
give the same bits.
`bundle_adjust_jit`, the JAX package's single-dispatch form, takes the
second on the card and the first on CPU tensors.

With a `group` (a torch.distributed process group; the JAX package's
`axis_name`), each rank holds a block of the observations
(parallel/distributed_ba.py) and its partial sums are all-reduced over the
group wherever the JAX package calls `psum`, so every rank takes the same
step. With `point_sharded=True` each rank also owns a block of the points
and every observation of them: the point-side sums stay local and only
camera-shaped sums cross ranks. `_Sums` names, once per solve, which sums
cross ranks. Every flag the host reads (the LM's exit test, the CG's
residual test) comes from reduced or replicated values, so all ranks take
the same branch. With no group nothing is reduced.

The segment sums over observations (per camera, per point, and per
(camera, point) slot of the Schur chunks' W, where a keyframe that binds
one point to several features puts several observations) add in an order
fixed by the problem (optim/segment.py: the maps sorted once per solve,
rows with `obs.valid` False left out, since their weights are 0), so a
solve gives the same bits on every run on the card.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.optim import residuals as res
from orb_slam2_commit_tpu_torch.optim.segment import Segments, segment_sum, segments
from orb_slam2_commit_tpu_torch.optim.residuals import (
    BAObservations, CHI2_MONO, CHI2_STEREO,
)
from orb_slam2_commit_tpu_torch.utils import cuda_graph
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


@lru_cache(maxsize=None)
def _sums(group, point_sharded: bool) -> _Sums:
    """One _Sums per (group, point_sharded), so that a solve's graph key
    (which holds it) finds the graphs of the solves before it."""
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


def obs_segments(problem: BAProblem, point_chunk: int = 1024,
                 solver: str = "auto") -> ObsSegments:
    """The tables of the active observations (obs.valid), for a solve
    with this point_chunk and solver (as bundle_adjust takes them). On the
    card this reads the longest segments' lengths on the host, once: a
    caller that solves the same observations again passes them on."""
    obs = problem.obs
    K, P = problem.R.shape[0], problem.points.shape[0]
    point_chunk, solver = min(point_chunk, P), _resolve(problem, solver)
    cam, pt = obs.cam_idx.long(), obs.pt_idx.long()
    chunks = []
    if solver == "dense":
        for lo in range(0, P, point_chunk):
            hi = min(lo + point_chunk, P)
            slot = cam * (hi - lo) + torch.clamp(pt - lo, 0, hi - lo - 1)
            chunks.append(segments(slot, K * (hi - lo), obs.valid & (pt >= lo) & (pt < hi)))
    return ObsSegments(segments(cam, K, obs.valid), segments(pt, P, obs.valid), tuple(chunks))


def _schur_pcg(Hcc_d, Hpp_inv, Hcp_o, cam, pt, segs: ObsSegments, b, fixed,
               n_iters: int = 64, tol: float = 1e-8, sums: _Sums = _LOCAL,
               early: bool = True):
    """Solve S dc = b with S = Hcc_d - W Hpp^-1 W^T without forming S or W:
    the matvec streams over observations (two segment sums, two batched
    small products), block-Jacobi preconditioned by Hcc_d^-1 ("Bundle
    Adjustment in the Large", implicit Schur).

    The JAX package's while_loop stops at n_iters iterations or once
    |r|^2 <= tol |b|^2. Here each iteration tests that and keeps the
    iterate where it fails (a select), so the loop runs n_iters times on
    the device with nothing read on the host; early=True also stops it
    there, on the host (the same bits, fewer iterations)."""
    def S_mv(x):                      # x [K, 6]
        y = torch.einsum("kab,kb->ka", Hcc_d, x)
        u = sums.pt(segment_sum(torch.einsum("oab,oa->ob", Hcp_o, x[cam]), segs.pt))
        v = torch.einsum("pab,pb->pa", Hpp_inv, u)
        y2 = sums.cam(segment_sum(torch.einsum("oab,ob->oa", Hcp_o, v[pt]), segs.cam))
        return y - y2

    # inv_ex reports a singular block instead of raising (inv raises, and
    # its check reads the device); the NaN step is rejected by the LM's
    # cost test, as the JAX package's non-finite inverse is.
    M_inv, info = torch.linalg.inv_ex(Hcc_d)
    M_inv = torch.where((info == 0)[:, None, None], M_inv, torch.nan)

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
        go = torch.sum(r * r) > tol * b_norm2
        if early and not bool(go):
            break
        Sp = S_mv(p)
        alpha = rz / safe(torch.sum(p * Sp))
        x_n = x + alpha * p
        r_n = r - alpha * Sp
        z_n = precond(r_n)
        rz_n = torch.sum(r_n * z_n)
        p_n = z_n + (rz_n / safe(rz)) * p
        x, r, z, p, rz = (torch.where(go, new, old) for new, old in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
    return torch.where(fixed[:, None], torch.zeros_like(x), x)


def _solve_step(problem: BAProblem, segs: ObsSegments, cam_params, use_robust, active, lam,
                point_chunk: int, solver: str = "dense", sums: _Sums = _LOCAL,
                early: bool = True):
    """One damped Gauss-Newton step -> (delta_c [K, 6], delta_p [P, 3]);
    lam a 0-d tensor, early: the PCG may stop on the host (_schur_pcg)."""
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
                             problem.fixed, sums=sums, early=early)
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


class _Solve(NamedTuple):
    """What a solve reads besides its tensors (the static arguments of the
    JAX package's bundle_adjust_jit): part of its CUDA graphs' keys."""

    cam_params: Tuple[float, float, float, float, float]
    use_robust: bool
    point_chunk: int
    lam0: float
    solver: str
    early: bool           # the loops may stop on the host
    sums: _Sums


class _LMState(NamedTuple):
    """The LM's carry (the JAX package's while_loop state): the current
    poses and points, the damping, the cost, each observation's chi2 and
    depth at the current problem, and whether a converged step was taken."""

    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    chi2: torch.Tensor
    z: torch.Tensor
    converged: torch.Tensor


def _resolve(problem: BAProblem, solver: str, point_sharded: bool = False) -> str:
    if point_sharded:
        return "pcg"
    if solver == "auto":
        return "pcg" if problem.R.shape[0] >= 64 else "dense"
    return solver


def _solve_config(problem: BAProblem, fx, fy, cx, cy, bf, use_robust, point_chunk, lam0,
                  solver, point_sharded=False, early=True, sums=_LOCAL) -> _Solve:
    return _Solve((fx, fy, cx, cy, bf), bool(use_robust),
                  min(point_chunk, problem.points.shape[0]), float(lam0),
                  _resolve(problem, solver, point_sharded), early, sums)


def _cost(problem: BAProblem, cfg: _Solve):
    """(chi2 [O], z [O], the robust cost over the active rows in front)."""
    obs = problem.obs
    delta2 = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(problem.points.dtype)
    _, _, chi2, _, _, z = _evaluate(problem, cfg.cam_params, cfg.use_robust, obs.valid)
    cost = _robust_total_cost(chi2, delta2, obs.valid & (z > 0), cfg.use_robust)
    return chi2, z, cfg.sums.cam(cost)


def _lm_init(problem: BAProblem, segs: ObsSegments, cfg: _Solve) -> _LMState:
    chi2, z, cost = _cost(problem, cfg)
    return _LMState(problem.R, problem.t, problem.points,
                    problem.points.new_full((), cfg.lam0), cost, chi2, z,
                    torch.zeros((), dtype=torch.bool, device=problem.points.device))


def _lm_go(s: _LMState) -> torch.Tensor:
    """The JAX package's exit test, less its count: no converged step yet
    and the damping under 1e8."""
    return ~s.converged & (s.lam < 1e8)


def _lm_iteration(s: _LMState, problem: BAProblem, segs: ObsSegments, cfg: _Solve) -> _LMState:
    """One LM iteration (the JAX package's while_loop body). Where the
    exit test has failed it changes nothing: every new value is a select
    on it, so an iteration past the exit leaves the bits as they were."""
    go = _lm_go(s)
    p = problem._replace(R=s.R, t=s.t, points=s.points)
    delta_c, delta_p = _solve_step(p, segs, cfg.cam_params, cfg.use_robust, problem.obs.valid,
                                   s.lam, cfg.point_chunk, cfg.solver, cfg.sums, cfg.early)
    p_new = _apply_step(p, delta_c, delta_p)
    chi2, z, new_cost = _cost(p_new, cfg)
    step_sq = torch.sum(delta_c * delta_c) + cfg.sums.own(torch.sum(delta_p * delta_p))
    step_eps = 1e-16 if problem.points.dtype == torch.float64 else 1e-10
    # A failed solve (a singular Schur system in float32) gives a
    # non-finite step; its projections then fail every depth gate, so
    # its cost reads 0. Such a step is rejected, never accepted.
    accept = go & (new_cost < s.cost) & torch.isfinite(step_sq)

    def pick(new, old):
        return torch.where(accept, new, old)

    return _LMState(pick(p_new.R, s.R), pick(p_new.t, s.t), pick(p_new.points, s.points),
                    torch.where(go, torch.where(accept, s.lam * 0.5, s.lam * 4.0), s.lam),
                    pick(new_cost, s.cost), pick(chi2, s.chi2), pick(z, s.z),
                    s.converged | (accept & (step_sq < step_eps)))


def _result(s: _LMState, problem: BAProblem) -> Tuple[BAProblem, BAResult]:
    obs = problem.obs
    delta2 = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(problem.points.dtype)
    inlier = obs.valid & (s.chi2 <= delta2) & (s.z > 0)
    return (problem._replace(R=s.R, t=s.t, points=s.points),
            BAResult(R=s.R, t=s.t, points=s.points, chi2=s.chi2, inlier=inlier, cost=s.cost))


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
    *,
    segs: Optional[ObsSegments] = None,
) -> Tuple[BAProblem, BAResult]:
    """Run up to n_iters of LM -> (updated problem, diagnostics); the
    early-exit form, which reads the exit test on the host once an
    iteration (and the PCG's once a CG iteration).

    solver: "dense" forms the Schur complement and solves it (exact, for
    local-BA-sized problems), "pcg" runs implicit Schur + preconditioned
    CG, "auto" takes pcg from 64 cameras on. The loop stops early on a
    converged step (|delta|^2 under 1e-10 in float32, 1e-16 in float64)
    or when the damping passes 1e8, as g2o does.

    group: this rank's block of a problem sharded over a process group
    (see the module docstring); point_sharded=True (the points' block too)
    takes pcg, since the dense route would build a replicated [6K, 6K].
    chi2 and inlier are this rank's observations'. segs: the observation
    tables (obs_segments of these observations, point_chunk and solver),
    when the caller made them already."""
    cfg = _solve_config(problem, fx, fy, cx, cy, bf, use_robust, point_chunk, lam0, solver,
                        point_sharded, True, _sums(group, point_sharded))
    if segs is None:
        segs = obs_segments(problem, cfg.point_chunk, cfg.solver)
    s = _lm_init(problem, segs, cfg)
    for _ in range(n_iters):
        if not bool(_lm_go(s)):
            break
        s = _lm_iteration(s, problem, segs, cfg)
    return _result(s, problem)


@full_float32
def bundle_adjust_loop(
    problem: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    n_iters: int = 10,
    use_robust: bool = True,
    point_chunk: int = 1024,
    lam0: float = 1e-4,
    solver: str = "auto",
    group: Optional[dist.ProcessGroup] = None,
    point_sharded: bool = False,
    *,
    segs: Optional[ObsSegments] = None,
) -> Tuple[BAProblem, BAResult]:
    """The device-loop form of bundle_adjust (the JAX package's two
    while_loops): n_iters LM iterations, each past the exit test a no-op,
    with the PCG's 64 iterations masked the same way, so nothing is read
    on the host. On the card the initial cost is one CUDA graph replay and
    the iterations n replays of another (utils/cuda_graph.py), its carry
    in the graph's buffers; on CPU tensors (or in cuda_graph.eager()) they
    run eagerly. The same bits as bundle_adjust on the same tables.

    group, point_sharded: a sharded solve, as bundle_adjust takes them.
    Its all-reduces (NCCL on the card) are captured inside the graphs and
    run at each replay; the first call's eager warm-up (cuda_graph)
    runs them once before the capture, which sets the communicator up.
    Under gloo (CPU tensors) they run eagerly."""
    cfg = _solve_config(problem, fx, fy, cx, cy, bf, use_robust, point_chunk, lam0, solver,
                        point_sharded, False, _sums(group, point_sharded))
    if segs is None:
        segs = obs_segments(problem, cfg.point_chunk, cfg.solver)
    s = cuda_graph.call(_lm_init, (problem, segs), cfg)
    s = cuda_graph.loop(_lm_iteration, s, (problem, segs), cfg, n_iters)
    return _result(s, problem)


# The functions bundle_adjust_loop captures (cuda_graph.release's owners).
GRAPHED = (_lm_init, _lm_iteration)


def bundle_adjust_jit(
    problem: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    n_iters: int = 10,
    use_robust: bool = True,
    point_chunk: int = 1024,
    lam0: float = 1e-4,
    axis_name: Optional[dist.ProcessGroup] = None,
    solver: str = "auto",
    point_sharded: bool = False,
    *,
    segs: Optional[ObsSegments] = None,
) -> Tuple[BAProblem, BAResult]:
    """The JAX package's bundle_adjust_jit, its parameters in its order:
    on the card bundle_adjust_loop's CUDA graphs, on CPU tensors
    bundle_adjust. axis_name: the process group of a sharded solve (the
    port's counterpart of JAX's mesh axis); on the card its all-reduces
    are captured in the loop's graphs. segs (the port's own): the
    observation tables, when the caller made them already (local BA's two
    stages, a global BA's segments)."""
    if not problem.points.is_cuda:
        return bundle_adjust(problem, fx, fy, cx, cy, bf, n_iters, use_robust, point_chunk,
                             lam0, solver, axis_name, point_sharded, segs=segs)
    return bundle_adjust_loop(problem, fx, fy, cx, cy, bf, n_iters, use_robust, point_chunk,
                              lam0, _resolve(problem, solver, point_sharded), axis_name,
                              point_sharded, segs=segs)


def local_bundle_adjust(
    problem: BAProblem,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    first_iters: int = 5,
    second_iters: int = 10,
    point_chunk: int = 1024,
) -> Tuple[BAProblem, BAResult]:
    """The reference's two-stage local BA (src/Optimizer.cc:737-782): 5
    robust iterations, drop chi2 outliers and negative depths, 10 more
    without the robust kernel, each stage through bundle_adjust_jit. The
    host erases the observations flagged not inlier (:838-861). Both
    stages sum over the first stage's tables: a row the first stage drops
    keeps its place with weight 0, so nothing is read between them."""
    segs = obs_segments(problem, point_chunk)
    problem, r1 = bundle_adjust_jit(problem, fx, fy, cx, cy, bf, n_iters=first_iters,
                                    use_robust=True, point_chunk=point_chunk, segs=segs)
    problem = problem._replace(obs=problem.obs._replace(valid=r1.inlier))
    return bundle_adjust_jit(problem, fx, fy, cx, cy, bf, n_iters=second_iters,
                             use_robust=False, point_chunk=point_chunk, segs=segs)
