"""Sim3 pose-graph optimization, the essential graph (PyTorch port of
optim/pose_graph.py; reference: Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:888-1218).

Vertices are per-keyframe similarities (world -> keyframe), edges relative
Sim3 measurements (the loop, the spanning tree, strong covisibility, past
loop edges); 20 LM iterations. The edge residual is g2o's EdgeSim3,
    e = log_sim3(S_meas^-1 S_i S_j^-1)  in R^7,
with left-multiplicative updates S <- exp(delta) S. The per-edge 7 x 14
Jacobians are forward-mode autodiff, as the JAX package's vmapped jacfwd:
one jvp per tangent direction over every edge at once. As there, an edge
whose residual rotation is the identity to rounding (its current relative
pose equals its measurement) gets a NaN Jacobian, since so3_log's arccos
has an infinite derivative at 1; the step is then NaN and rejected.

Two solvers, chosen by size as in the JAX package: "dense" scatters the
blocks into a [7K, 7K] system (K <= 256 vertices under "auto"), "pcg"
never forms it: block-Jacobi preconditioned CG with a matvec over the
edge list. Every LM step and CG iteration runs on the device with no host
round trip: accept tests and the CG stop are selects. The sums over edges
(into the vertices' gradients and diagonal blocks, the dense system's
off-diagonal blocks, the CG matvec) add in an order fixed by the edge list
(optim/segment.py, its tables made once per solve), so a solve gives the
same bits on every run on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.optim.segment import Segments, segment_sum, segments
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


class Sim3Graph(NamedTuple):
    """K vertices, E edges (padded, masked)."""

    s: torch.Tensor           # [K]
    R: torch.Tensor           # [K, 3, 3]
    t: torch.Tensor           # [K, 3]
    fixed: torch.Tensor       # [K] bool
    edge_i: torch.Tensor      # [E] int64
    edge_j: torch.Tensor      # [E] int64
    meas_s: torch.Tensor      # [E]
    meas_R: torch.Tensor      # [E, 3, 3]
    meas_t: torch.Tensor      # [E, 3]
    edge_valid: torch.Tensor  # [E] bool


def _edge_residual(si, Ri, ti, sj, Rj, tj, sm, Rm, tm, di, dj):
    """Residual [..., 7] of each edge with tangent perturbations di, dj
    [..., 7] applied to its two vertices."""
    si_n, Ri_n, ti_n = lie.sim3_compose(*lie.sim3_exp(di), si, Ri, ti)
    sj_n, Rj_n, tj_n = lie.sim3_compose(*lie.sim3_exp(dj), sj, Rj, tj)
    s_ij, R_ij, t_ij = lie.sim3_compose(si_n, Ri_n, ti_n, *lie.sim3_inverse(sj_n, Rj_n, tj_n))
    s_e, R_e, t_e = lie.sim3_compose(*lie.sim3_inverse(sm, Rm, tm), s_ij, R_ij, t_ij)
    return lie.sim3_log(s_e, R_e, t_e)


def _edge_terms(g: Sim3Graph):
    """Residuals r [E, 7] and Jacobians Ji, Jj [E, 7, 7] at delta = 0."""
    i, j = g.edge_i, g.edge_j
    args = (g.s[i], g.R[i], g.t[i], g.s[j], g.R[j], g.t[j], g.meas_s, g.meas_R, g.meas_t)
    E = i.shape[0]
    zero = torch.zeros((E, 14), dtype=g.t.dtype, device=g.t.device)

    def f(d):
        return _edge_residual(*args, d[:, :7], d[:, 7:])

    # Direction k perturbs tangent component k of every edge at once (the
    # edges are independent); the leading [E] axis keeps every value at
    # least 1-d under forward-mode autodiff.
    basis = torch.eye(14, dtype=zero.dtype, device=zero.device)[:, None, :].expand(14, E, 14)
    r, J = torch.func.vmap(lambda v: torch.func.jvp(f, (zero,), (v,)), out_dims=(None, 0))(basis)
    J = J.permute(1, 2, 0)                      # [E, 7, 14]
    return r, J[:, :, :7], J[:, :, 7:]


def _cost(g: Sim3Graph) -> torch.Tensor:
    zero = torch.zeros((g.edge_i.shape[0], 7), dtype=g.t.dtype, device=g.t.device)
    i, j = g.edge_i, g.edge_j
    r = _edge_residual(g.s[i], g.R[i], g.t[i], g.s[j], g.R[j], g.t[j],
                       g.meas_s, g.meas_R, g.meas_t, zero, zero)
    return torch.sum(torch.where(g.edge_valid[:, None], r * r, 0.0))


def _pcg_solve(D, dscalar, Aij, edge_i, edge_j, ends: Segments, b, lam, n_cg: int,
               tol: float = 1e-16):
    """Solve (H + lam diag(H) + 1e-9 I) x = b without forming H.

    D [K, 7, 7] vertex diagonal blocks (identity rows for unused or fixed
    vertices already added), dscalar [K, 7] their diagonals, Aij [E, 7, 7]
    the i -> j off-diagonal blocks (Ji^T Jj; j -> i is its transpose), b
    [K, 7], ends the segments of cat(edge_i, edge_j). Block-Jacobi
    preconditioned CG.

    The JAX package's while_loop stops at n_cg iterations or once
    |r|^2 <= tol |b|^2. In float32 a relative tol of 1e-16 is never met
    (the residual's rounding floor is ~1e-14 relative), so the iteration
    count decides, as it does there; the test stays, as a select that
    freezes the iterate, so that a zero residual stops it as in JAX."""
    damp = lam * dscalar + 1e-9

    def H_mv(x):
        y = torch.einsum("kab,kb->ka", D, x) + damp * x
        return y + segment_sum(torch.cat([torch.einsum("eab,eb->ea", Aij, x[edge_j]),
                                          torch.einsum("eab,ea->eb", Aij, x[edge_i])]), ends)

    eye7 = torch.eye(7, dtype=b.dtype, device=b.device)
    # inv_ex reports a singular block instead of raising (the card raises);
    # its NaN step is rejected by the LM's cost test.
    M_inv, info = torch.linalg.inv_ex(D + eye7 * damp[:, :, None])
    M_inv = torch.where((info == 0)[:, None, None], M_inv, torch.nan)

    def precond(r):
        return torch.einsum("kab,kb->ka", M_inv, r)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    b_norm2 = torch.clamp_min(torch.sum(b * b), 1e-30)
    tiny = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    for _ in range(n_cg):
        go = torch.sum(r * r) > tol * b_norm2
        Hp = H_mv(p)
        denom = torch.sum(p * Hp)
        alpha = rz / torch.where(torch.abs(denom) > 1e-30, denom, tiny)
        x_n = x + alpha * p
        r_n = r - alpha * Hp
        z_n = precond(r_n)
        rz_n = torch.sum(r_n * z_n)
        beta = rz_n / torch.where(torch.abs(rz) > 1e-30, rz, tiny)
        p_n = z_n + beta * p
        x, r, z, p, rz = (torch.where(go, new, old) for new, old in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
    return x


@full_float32
def optimize_sim3_graph(
    graph: Sim3Graph,
    n_iters: int = 20,
    fix_scale: bool = False,
    solver: str = "auto",
) -> Sim3Graph:
    """LM over every vertex. fix_scale freezes every sigma component
    (the stereo / RGB-D essential graph, bFixScale :897). solver: "dense",
    "pcg" or "auto" (pcg above 256 vertices)."""
    K = graph.s.shape[0]
    use_pcg = solver == "pcg" or (solver == "auto" and K > 256)
    dtype, dev = graph.t.dtype, graph.t.device
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    ei, ej = graph.edge_i, graph.edge_j
    w = graph.edge_valid.to(dtype)
    drop_i = graph.fixed[ei][:, None, None]
    drop_j = graph.fixed[ej][:, None, None]
    # Each edge's terms go to both its vertices; the dense system's
    # off-diagonal blocks (i, j) and (j, i) sit at i * K + j and j * K + i.
    ends = segments(torch.cat([ei, ej]), K)
    blocks = None if use_pcg else segments(torch.cat([ei * K + ej, ej * K + ei]), K * K)

    g = graph
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    cost = _cost(g)
    for _ in range(n_iters):
        r, Ji, Jj = _edge_terms(g)
        Ji = torch.where(drop_i, 0.0, Ji * w[:, None, None])
        Jj = torch.where(drop_j, 0.0, Jj * w[:, None, None])
        rw = r * w[:, None]
        b = segment_sum(torch.cat([torch.einsum("era,er->ea", Ji, rw),
                                   torch.einsum("era,er->ea", Jj, rw)]), ends)
        Aij = torch.einsum("era,erb->eab", Ji, Jj)
        D = segment_sum(torch.cat([torch.einsum("era,erb->eab", Ji, Ji),
                                   torch.einsum("era,erb->eab", Jj, Jj)]), ends)
        # Fixed and unconstrained vertices get identity rows.
        unused = (torch.abs(D).sum(dim=(1, 2)) == 0) | graph.fixed
        D = D + torch.where(unused[:, None, None], eye7, 0.0)
        if use_pcg:
            # CG moves information one edge a iteration: the cap covers
            # the graph's diameter (a loop's cycle is ~K long) and more.
            delta = -_pcg_solve(D, torch.diagonal(D, dim1=1, dim2=2), Aij, ei, ej, ends, b,
                                lam, n_cg=4 * K + 128)
        else:
            H = segment_sum(torch.cat([Aij, Aij.transpose(1, 2)]), blocks).reshape(K, K, 7, 7)
            H[torch.arange(K, device=dev), torch.arange(K, device=dev)] += D
            Hm = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
            Hm = Hm + lam * torch.diag(torch.diagonal(Hm)) + 1e-9 * torch.eye(
                K * 7, dtype=dtype, device=dev)
            # A singular system gives a NaN step (solve_ex does not raise,
            # as the card's solve would), which the cost test rejects.
            sol, info = torch.linalg.solve_ex(Hm, b.reshape(K * 7))
            delta = -torch.where(info == 0, sol, torch.nan).reshape(K, 7)
        delta = torch.where(graph.fixed[:, None], 0.0, delta)
        if fix_scale:
            delta = torch.cat([delta[:, :6], torch.zeros_like(delta[:, 6:])], dim=1)
        s_n, R_n, t_n = lie.sim3_compose(*lie.sim3_exp(delta), g.s, g.R, g.t)
        g_new = g._replace(s=s_n, R=R_n, t=t_n)
        new_cost = _cost(g_new)
        accept = new_cost < cost
        g = g._replace(s=torch.where(accept, g_new.s, g.s), R=torch.where(accept, g_new.R, g.R),
                       t=torch.where(accept, g_new.t, g.t))
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return g
