"""Multi-process entry for the point-sharded global BA (PyTorch port of
parallel/multihost.py).

The reference runs its threads around one map in one process (its
GlobalBA thread, src/LoopClosing.cc:801). The JAX package's pod-scale
replacement is a jax.distributed process group over a global mesh; the
port's is a torch.distributed process group, one process per card:

- `initialize` joins the group from its arguments or from the usual
  environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, as
  `torchrun` sets them), with NCCL for the card and gloo for the CPU,
  never one for the other. With no cluster in sight it starts a world of
  one on an in-process store, so the same driver runs on one card.
- Every process holds the map once, and the partition plan is a cheap
  deterministic numpy pass over it (distributed_ba.partition_problem), so
  each rank lays out the same plan and uploads only its own block
  (`distribute_problem`); the camera leaves are replicated.
- The solve's traffic is the [K, 6]-shaped camera sums only, and each
  rank writes back the points it owns (`local_point_shards`).
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba

# A rank that waits longer than this in a collective raises instead of
# hanging (ranks that took different branches, or a lost peer).
DEFAULT_TIMEOUT_S = 300.0
_CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join the torch.distributed process group (idempotent).

    With coordinator_address ("host:port"), num_processes and process_id,
    or with the cluster variables in the environment, this joins that
    group and raises if joining fails. With neither it starts a world of
    one on an in-process store. The backend follows `device`: NCCL for the
    card (each rank on the card of its LOCAL_RANK, else rank modulo the
    cards), gloo for the CPU."""
    if dist.is_initialized():
        return
    backend = dba.backend_for(device)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    asked = coordinator_address is not None or num_processes is not None
    if asked or all(k in os.environ for k in _CLUSTER_ENV):
        world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
        rank = process_id if process_id is not None else os.environ.get("RANK")
        if world is None or rank is None:
            raise ValueError("joining a cluster needs num_processes and process_id "
                             "(or WORLD_SIZE and RANK)")
        world, rank = int(world), int(rank)
        init = (f"tcp://{coordinator_address}" if coordinator_address is not None
                else "env://")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                     rank % torch.cuda.device_count())))
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=timeout)
    else:
        if backend == "nccl":
            dev = torch.device(device)
            if dev.index is not None:
                torch.cuda.set_device(dev.index)
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=timeout)
    atexit.register(_leave)


def _leave() -> None:
    """Leave the group at exit, if it is still joined (NCCL frees its
    communicators)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_group() -> dist.ProcessGroup:
    """The group over every rank of every process (the single scaling
    axis: cameras are replicated, so one dimension is the topology). Ranks
    are processes started at the size the run needs, so the sharded
    solves always span the whole world."""
    return dist.group.WORLD


def rank_device(group) -> torch.device:
    """This rank's device: its current card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def distribute_problem(
    part: ba.BAProblem, plan: dba.PartitionPlan, group
) -> ba.BAProblem:
    """This rank's block of a partitioned problem (from
    dba.partition_problem, e.g. on the host) on this rank's device: its
    points and observation slots, the camera leaves replicated. Each rank
    uploads only its own block."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    assert part.points.shape[0] == plan.p_blk * n
    assert part.obs.valid.shape[0] == plan.o_blk * n
    return dba.point_block(part, rank, plan.p_blk, plan.o_blk, rank_device(group))


def bundle_adjust_multihost(
    problem: ba.BAProblem,
    plan: dba.PartitionPlan,
    group,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    n_iters: int = 10,
    use_robust: bool = True,
):
    """The point-sharded solve on this rank's block (from
    distribute_problem): the same LM as dba.distributed_bundle_adjust_points,
    without its final gather. R and t come back the same on every rank;
    points, chi2 and inlier are this rank's block and slots."""
    assert problem.points.shape[0] == plan.p_blk
    return ba.bundle_adjust_jit(problem, fx, fy, cx, cy, bf, n_iters=n_iters,
                                use_robust=use_robust, axis_name=group, point_sharded=True)


def local_point_shards(out: ba.BAProblem) -> np.ndarray:
    """This rank's refined point block, never gathered: each rank writes
    back only the map region it owns."""
    return out.points.detach().cpu().numpy()
