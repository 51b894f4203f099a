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
round trip: accept tests and the CG stop are selects. Two forms run the
same stage functions: `optimize_sim3_graph` eagerly, and
`optimize_sim3_graph_blocks` as CUDA graph replays on the card (the CG in
blocks of CG_BLOCK iterations, a carried count masking those past the
cap); `optimize_sim3_graph_jit`, the JAX package's single-dispatch form,
takes the second on the card and the first on CPU tensors. The sums over edges
(into the vertices' gradients and diagonal blocks, the dense system's
off-diagonal blocks, the CG matvec) add in an order fixed by the edge list
(optim/segment.py, its tables made once per solve), so a solve gives the
same bits on every run on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.optim.segment import Segments, segment_sum, segments
from orb_slam2_commit_tpu_torch.utils import cuda_graph
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


class _Step(NamedTuple):
    """The LM's carry (the JAX package's fori_loop state): the vertices,
    the damping and the cost."""

    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor


class _CG(NamedTuple):
    """The PCG's carry (the JAX package's while_loop state) and its
    iteration count."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    i: torch.Tensor


class _System(NamedTuple):
    """One LM step's damped system for the PCG: D [K, 7, 7] the vertex
    diagonal blocks (identity rows for unused or fixed vertices), damp
    [K, 7] = lam diag(D) + 1e-9, Aij [E, 7, 7] the i -> j off-diagonal
    blocks (Ji^T Jj; j -> i is its transpose), M_inv the block-Jacobi
    preconditioner, b_norm2 = |b|^2."""

    D: torch.Tensor
    damp: torch.Tensor
    Aij: torch.Tensor
    M_inv: torch.Tensor
    b_norm2: torch.Tensor


class _Solve(NamedTuple):
    """What a solve reads besides its tensors: part of its CUDA graphs'
    keys. n_cg: the PCG's cap (the JAX package's 4K + 128); block: the CG
    iterations a call of _cg_block runs."""

    fix_scale: bool
    use_pcg: bool
    n_cg: int
    block: int


# CG iterations a replay of the block-replay form's CG graph.
CG_BLOCK = 64
# The JAX package's relative stop of the PCG. In float32 it is never met
# (the residual's rounding floor is ~1e-14 relative), so the iteration
# count decides, as it does there; the test stays, so that a zero residual
# stops it as in JAX.
CG_TOL = 1e-16


def _init(graph: Sim3Graph, cfg: _Solve) -> _Step:
    return _Step(graph.s, graph.R, graph.t, graph.t.new_full((), 1e-4), _cost(graph))


def _linearize(st: _Step, graph: Sim3Graph, ends: Segments):
    """The weighted edge Jacobians at the carry's vertices -> (b [K, 7],
    D [K, 7, 7] with identity rows for unused or fixed vertices, Aij
    [E, 7, 7])."""
    g = graph._replace(s=st.s, R=st.R, t=st.t)
    w = graph.edge_valid.to(graph.t.dtype)
    r, Ji, Jj = _edge_terms(g)
    Ji = torch.where(graph.fixed[graph.edge_i][:, None, None], 0.0, Ji * w[:, None, None])
    Jj = torch.where(graph.fixed[graph.edge_j][:, None, None], 0.0, Jj * w[:, None, None])
    rw = r * w[:, None]
    b = segment_sum(torch.cat([torch.einsum("era,er->ea", Ji, rw),
                               torch.einsum("era,er->ea", Jj, rw)]), ends)
    Aij = torch.einsum("era,erb->eab", Ji, Jj)
    D = segment_sum(torch.cat([torch.einsum("era,erb->eab", Ji, Ji),
                               torch.einsum("era,erb->eab", Jj, Jj)]), ends)
    # Fixed and unconstrained vertices get identity rows.
    eye7 = torch.eye(7, dtype=D.dtype, device=D.device)
    unused = (torch.abs(D).sum(dim=(1, 2)) == 0) | graph.fixed
    return b, D + torch.where(unused[:, None, None], eye7, 0.0), Aij


def _accept(st: _Step, delta: torch.Tensor, graph: Sim3Graph, cfg: _Solve) -> _Step:
    """The step delta [K, 7] applied to the free vertices (exp(delta) S),
    kept where the cost falls (the damping halved) and dropped where not
    (the damping quadrupled)."""
    delta = torch.where(graph.fixed[:, None], 0.0, delta)
    if cfg.fix_scale:
        delta = torch.cat([delta[:, :6], torch.zeros_like(delta[:, 6:])], dim=1)
    s_n, R_n, t_n = lie.sim3_compose(*lie.sim3_exp(delta), st.s, st.R, st.t)
    new_cost = _cost(graph._replace(s=s_n, R=R_n, t=t_n))
    accept = new_cost < st.cost
    return _Step(torch.where(accept, s_n, st.s), torch.where(accept, R_n, st.R),
                 torch.where(accept, t_n, st.t), torch.where(accept, st.lam * 0.5, st.lam * 4.0),
                 torch.where(accept, new_cost, st.cost))


def _dense_step(st: _Step, graph: Sim3Graph, ends: Segments, blocks: Segments,
                cfg: _Solve) -> _Step:
    """One LM step on the dense [7K, 7K] system."""
    K = graph.s.shape[0]
    dev = graph.t.device
    b, D, Aij = _linearize(st, graph, ends)
    H = segment_sum(torch.cat([Aij, Aij.transpose(1, 2)]), blocks).reshape(K, K, 7, 7)
    H[torch.arange(K, device=dev), torch.arange(K, device=dev)] += D
    Hm = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
    Hm = Hm + st.lam * torch.diag(torch.diagonal(Hm)) + 1e-9 * torch.eye(
        K * 7, dtype=Hm.dtype, device=dev)
    # A singular system gives a NaN step (solve_ex does not raise, as the
    # card's solve would), which the cost test rejects.
    sol, info = torch.linalg.solve_ex(Hm, b.reshape(K * 7))
    delta = -torch.where(info == 0, sol, torch.nan).reshape(K, 7)
    return _accept(st, delta, graph, cfg)


def _cg_start(st: _Step, graph: Sim3Graph, ends: Segments, cfg: _Solve):
    """One LM step's system and the PCG's first carry (x = 0) -> (_System,
    _CG)."""
    b, D, Aij = _linearize(st, graph, ends)
    damp = st.lam * torch.diagonal(D, dim1=1, dim2=2) + 1e-9
    eye7 = torch.eye(7, dtype=b.dtype, device=b.device)
    # inv_ex reports a singular block instead of raising (the card raises);
    # its NaN step is rejected by the LM's cost test.
    M_inv, info = torch.linalg.inv_ex(D + eye7 * damp[:, :, None])
    M_inv = torch.where((info == 0)[:, None, None], M_inv, torch.nan)
    z = torch.einsum("kab,kb->ka", M_inv, b)
    system = _System(D, damp, Aij, M_inv, torch.clamp_min(torch.sum(b * b), 1e-30))
    return system, _CG(torch.zeros_like(b), b, z, z, torch.sum(b * z),
                       torch.zeros((), dtype=torch.int64, device=b.device))


def _cg_block(cg: _CG, system: _System, graph: Sim3Graph, ends: Segments, cfg: _Solve) -> _CG:
    """cfg.block PCG iterations on (H + lam diag(H) + 1e-9 I) x = b,
    without forming H (the matvec over the edge list). An iteration past
    cfg.n_cg or past the stop (|r|^2 <= CG_TOL |b|^2) keeps the carry as
    it was (selects), so blocks can run past the cap with the same bits."""
    D, damp, Aij, M_inv, b_norm2 = system
    edge_i, edge_j = graph.edge_i, graph.edge_j

    def H_mv(x):
        y = torch.einsum("kab,kb->ka", D, x) + damp * x
        return y + segment_sum(torch.cat([torch.einsum("eab,eb->ea", Aij, x[edge_j]),
                                          torch.einsum("eab,ea->eb", Aij, x[edge_i])]), ends)

    x, r, z, p, rz, i = cg
    for _ in range(cfg.block):
        go = (i < cfg.n_cg) & (torch.sum(r * r) > CG_TOL * b_norm2)
        Hp = H_mv(p)
        denom = torch.sum(p * Hp)
        alpha = rz / torch.where(torch.abs(denom) > 1e-30, denom, torch.full_like(denom, 1e-30))
        x_n = x + alpha * p
        r_n = r - alpha * Hp
        z_n = torch.einsum("kab,kb->ka", M_inv, r_n)
        rz_n = torch.sum(r_n * z_n)
        beta = rz_n / torch.where(torch.abs(rz) > 1e-30, rz, torch.full_like(rz, 1e-30))
        p_n = z_n + beta * p
        x, r, z, p, rz = (torch.where(go, new, old) for new, old in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
        i = i + 1
    return _CG(x, r, z, p, rz, i)


def _cg_finish(st: _Step, x: torch.Tensor, graph: Sim3Graph, cfg: _Solve) -> _Step:
    return _accept(st, -x, graph, cfg)


def _setup(graph: Sim3Graph, fix_scale: bool, solver: str, block: Optional[int]):
    """(the solve's _Solve, the edge ends' segments, the dense system's
    block segments or None). block None: the whole CG in one block."""
    K = graph.s.shape[0]
    use_pcg = solver == "pcg" or (solver == "auto" and K > 256)
    # CG moves information one edge an iteration: the cap covers the
    # graph's diameter (a loop's cycle is ~K long) and more.
    n_cg = 4 * K + 128
    cfg = _Solve(bool(fix_scale), use_pcg, n_cg, n_cg if block is None else block)
    ei, ej = graph.edge_i, graph.edge_j
    # Each edge's terms go to both its vertices; the dense system's
    # off-diagonal blocks (i, j) and (j, i) sit at i * K + j and j * K + i.
    ends = segments(torch.cat([ei, ej]), K)
    blocks = None if use_pcg else segments(torch.cat([ei * K + ej, ej * K + ei]), K * K)
    return cfg, ends, blocks


@full_float32
def optimize_sim3_graph(
    graph: Sim3Graph,
    n_iters: int = 20,
    fix_scale: bool = False,
    solver: str = "auto",
) -> Sim3Graph:
    """LM over every vertex. fix_scale freezes every sigma component
    (the stereo / RGB-D essential graph, bFixScale :897). solver: "dense",
    "pcg" or "auto" (pcg above 256 vertices). Eager: the whole PCG in one
    loop of its cap's length."""
    cfg, ends, blocks = _setup(graph, fix_scale, solver, None)
    st = _init(graph, cfg)
    for _ in range(n_iters):
        if cfg.use_pcg:
            system, cg = _cg_start(st, graph, ends, cfg)
            st = _cg_finish(st, _cg_block(cg, system, graph, ends, cfg).x, graph, cfg)
        else:
            st = _dense_step(st, graph, ends, blocks, cfg)
    return graph._replace(s=st.s, R=st.R, t=st.t)


@full_float32
def optimize_sim3_graph_blocks(
    graph: Sim3Graph,
    n_iters: int = 20,
    fix_scale: bool = False,
    solver: str = "auto",
) -> Sim3Graph:
    """The block-replay form of optimize_sim3_graph, with nothing read on
    the host: on the card each dense LM step is one CUDA graph replay
    (utils/cuda_graph.py), n_iters in a row; a PCG step is one replay
    that forms the system, ceil(n_cg / CG_BLOCK) replays of CG_BLOCK CG
    iterations (those past the cap masked by the carried count) and one
    that applies the step. On CPU tensors (or in cuda_graph.eager()) the
    same functions run eagerly. The same bits as optimize_sim3_graph."""
    cfg, ends, blocks = _setup(graph, fix_scale, solver, CG_BLOCK)
    st = cuda_graph.call(_init, (graph,), cfg)
    if not cfg.use_pcg:
        st = cuda_graph.loop(_dense_step, st, (graph, ends, blocks), cfg, n_iters)
    for _ in range(n_iters if cfg.use_pcg else 0):
        system, cg = cuda_graph.call(_cg_start, (st, graph, ends), cfg)
        cg = cuda_graph.loop(_cg_block, cg, (system, graph, ends), cfg,
                             -(-cfg.n_cg // cfg.block))
        st = cuda_graph.call(_cg_finish, (st, cg.x, graph), cfg)
    return graph._replace(s=st.s, R=st.R, t=st.t)


# The functions optimize_sim3_graph_blocks captures (cuda_graph.release's
# owners).
GRAPHED = (_init, _dense_step, _cg_start, _cg_block, _cg_finish)


def optimize_sim3_graph_jit(
    graph: Sim3Graph,
    n_iters: int = 20,
    fix_scale: bool = False,
    solver: str = "auto",
) -> Sim3Graph:
    """The JAX package's optimize_sim3_graph_jit: on the card
    optimize_sim3_graph_blocks' CUDA graphs, on CPU tensors
    optimize_sim3_graph."""
    fn = optimize_sim3_graph_blocks if graph.t.is_cuda else optimize_sim3_graph
    return fn(graph, n_iters, fix_scale, solver)
