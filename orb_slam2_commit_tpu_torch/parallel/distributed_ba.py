"""Global bundle adjustment sharded over a torch.distributed process group
(PyTorch port of parallel/distributed_ba.py).

The JAX package runs one controller over a device mesh and puts a `psum`
where the devices meet. The port runs one process per rank, one device per
rank (SPMD): every rank calls the same entry point with the same problem,
takes its own block by its rank, and `optim/ba.py` all-reduces over the
group at each of the JAX package's `psum` sites. Two schemes:

1. distributed_bundle_adjust: the observations sharded, everything else
   replicated. Every rank returns the same poses and points.

2. partition_problem + distributed_bundle_adjust_points: points split into
   contiguous per-rank ranges, every observation moved to the rank that
   owns its point. The point blocks, their Hessian blocks and steps stay on
   their rank; cameras stay replicated, and the only traffic is the
   [K, 6]-shaped camera sums: one all-reduce a CG matvec and a few a LM
   iteration, whatever the number of points.

A group of one rank runs the same code; each all-reduce is then a copy.

Both solve through `ba.bundle_adjust_jit` (the JAX package jits each
sharded solve whole): on the card the LM and the PCG run as the device
loop's CUDA graph replays with the NCCL all-reduces captured inside them,
nothing read on the host; on the CPU (gloo) the early-exit form runs, the
same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations

def backend_for(device) -> str:
    """The collective backend for tensors on `device`: NCCL on the card,
    gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_and_size(group) -> Tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def shard_observations(obs: BAObservations, n_devices: int) -> BAObservations:
    """Pad the observation table to a multiple of n_devices (the padded
    rows invalid)."""
    O = obs.valid.shape[0]
    O_pad = -(-O // n_devices) * n_devices
    return BAObservations(*(_pad_rows(leaf, O_pad) for leaf in obs))


def _rows(obs: BAObservations, lo: int, hi: int) -> BAObservations:
    return BAObservations(*(leaf[lo:hi] for leaf in obs))


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Each rank's x [n, ...] concatenated in rank order."""
    cast = x.dtype == torch.bool
    y = (x.to(torch.uint8) if cast else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts)
    return out.bool() if cast else out


def distributed_bundle_adjust(
    problem: ba.BAProblem,
    group,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    n_iters: int = 10,
    use_robust: bool = True,
    point_chunk: int = 1024,
) -> Tuple[ba.BAProblem, ba.BAResult]:
    """Observation-sharded BA: rank r solves with the rows
    [r O/n, (r+1) O/n) of problem.obs (O a multiple of the group's size:
    shard_observations). Every rank returns the same R, t and points, and
    chi2 / inlier for every row, in row order."""
    rank, n = _rank_and_size(group)
    O = problem.obs.valid.shape[0]
    assert O % n == 0, "pad observations first"
    blk = O // n
    local = problem._replace(obs=_rows(problem.obs, rank * blk, (rank + 1) * blk))
    out, res = ba.bundle_adjust_jit(local, fx, fy, cx, cy, bf, n_iters=n_iters,
                                    use_robust=use_robust, point_chunk=point_chunk,
                                    axis_name=group)
    chi2, inlier = _all_gather_rows(res.chi2, group), _all_gather_rows(res.inlier, group)
    return out._replace(obs=problem.obs), res._replace(chi2=chi2, inlier=inlier)


# ----------------------------------------------------------------------
# Point-sharded scheme (the scaling path)
# ----------------------------------------------------------------------


class PartitionPlan(NamedTuple):
    """Host-side bookkeeping for a point-partitioned problem layout."""

    perm: np.ndarray    # [n_dev * o_blk] original obs row per slot, -1 pad
    p_blk: int          # points per rank (padded)
    o_blk: int          # observation slots per rank (padded)
    n_points: int       # original P (points[:n_points] are real)
    n_obs: int          # original O
    n_devices: int

    def scatter_obs(self, sharded: np.ndarray, fill=0) -> np.ndarray:
        """A per-slot array (chi2 / inlier of the sharded solve) back in
        original observation order."""
        out = np.full((self.n_obs,) + np.shape(sharded)[1:], fill,
                      dtype=np.asarray(sharded).dtype)
        ok = self.perm >= 0
        out[self.perm[ok]] = np.asarray(sharded)[ok]
        return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pad_np(x: np.ndarray, n: int) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


def partition_problem(
    problem: ba.BAProblem, n_devices: int, align: int = 8
) -> Tuple[ba.BAProblem, PartitionPlan]:
    """Lay out a BA problem for the point-sharded solve (host numpy, the
    JAX package's layout): the points split into n_devices contiguous
    ranges, each observation moved to the block of the rank that owns its
    point, its pt_idx rewritten rank-local, and each block padded to o_blk
    slots (a multiple of `align`). SLAM map points have near-even
    observation counts, so equal ranges balance the observation load."""
    dev = problem.points.device if isinstance(problem.points, torch.Tensor) else "cpu"
    pts = _np(problem.points)
    pvalid = _np(problem.point_valid)
    P_orig = pts.shape[0]
    p_blk = -(-P_orig // n_devices)
    P_pad = p_blk * n_devices
    pts = _pad_np(pts, P_pad)
    pvalid = _pad_np(pvalid, P_pad)

    leaves = {name: _np(leaf) for name, leaf in zip(BAObservations._fields, problem.obs)}
    pt_idx = leaves["pt_idx"]
    O = pt_idx.shape[0]
    owner = np.clip(pt_idx // p_blk, 0, n_devices - 1)
    counts = np.bincount(owner, minlength=n_devices)
    o_blk = -(-int(counts.max()) // align) * align

    n_slots = n_devices * o_blk
    perm = np.full(n_slots, -1, np.int64)
    new = {name: np.zeros((n_slots,) + a.shape[1:], a.dtype) for name, a in leaves.items()}
    for d in range(n_devices):
        rows = np.where(owner == d)[0]
        s = d * o_blk
        e = s + rows.size
        perm[s:e] = rows
        for name, a in leaves.items():
            new[name][s:e] = a[rows]
        new["pt_idx"][s:e] -= d * p_blk   # rank-local

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    part = problem._replace(points=t(pts), point_valid=t(pvalid),
                            obs=BAObservations(**{k: t(v) for k, v in new.items()}))
    plan = PartitionPlan(perm=perm, p_blk=p_blk, o_blk=o_blk,
                         n_points=P_orig, n_obs=O, n_devices=n_devices)
    return part, plan


def point_block(part: ba.BAProblem, rank: int, p_blk: int, o_blk: int,
                dev: torch.device) -> ba.BAProblem:
    """Rank `rank`'s block of a partitioned problem on `dev`: its points
    and their observations, the camera leaves whole."""
    p0, o0 = rank * p_blk, rank * o_blk
    return ba.BAProblem(
        R=part.R.to(dev), t=part.t.to(dev), fixed=part.fixed.to(dev),
        points=part.points[p0:p0 + p_blk].to(dev),
        point_valid=part.point_valid[p0:p0 + p_blk].to(dev),
        obs=BAObservations(*(leaf[o0:o0 + o_blk].to(dev) for leaf in part.obs)))


def distributed_bundle_adjust_points(
    problem: ba.BAProblem,
    group,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    n_iters: int = 10,
    use_robust: bool = True,
) -> Tuple[ba.BAProblem, ba.BAResult]:
    """Point-sharded BA on a problem from partition_problem with
    n_devices the group's size. Rank r solves its p_blk points and o_blk
    slots; returns (problem, result) with the points gathered in global
    order and chi2 / inlier in PARTITIONED slot order (PartitionPlan.
    scatter_obs recovers the original order), the same on every rank."""
    rank, n = _rank_and_size(group)
    P, O = problem.points.shape[0], problem.obs.valid.shape[0]
    assert P % n == 0 and O % n == 0, "partition_problem first"
    local = point_block(problem, rank, P // n, O // n, problem.points.device)
    out, res = ba.bundle_adjust_jit(local, fx, fy, cx, cy, bf, n_iters=n_iters,
                                    use_robust=use_robust, axis_name=group,
                                    point_sharded=True)
    points = _all_gather_rows(out.points, group)
    res = res._replace(points=points, chi2=_all_gather_rows(res.chi2, group),
                       inlier=_all_gather_rows(res.inlier, group))
    return problem._replace(R=out.R, t=out.t, points=points), res
