"""A gloo world of processes for the port's sharded-BA tests on the CPU.

`spawn_world(cases, world, inputs, workdir)` writes `inputs` (a dict of
numpy problems) to workdir, starts `world` processes of this file (one a
rank, one thread each, joined over a file store in workdir, every
collective under COLLECTIVE_TIMEOUT_S) and returns each rank's results, or
raises with the ranks' output if any rank fails or the world outlasts
JOIN_TIMEOUT_S. The ranks import torch and the port, never JAX; the test
module computes the JAX side meanwhile.

    python tests/torch_dist_ranks.py CASES RANK WORLD WORKDIR
"""

import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 120.0


def spawn_world(cases, world, inputs, workdir, timeout=JOIN_TIMEOUT_S):
    """-> [rank 0's results, rank 1's, ...] (dicts of numpy)."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), cases, str(r), str(world), workdir],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {world}-rank world outlasted {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, logs[r] if r < len(logs) else "")
              for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(f"rank {r} exited {rc}:\n{log[-3000:]}"
                                 for r, rc, log in failed)
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ----------------------------------------------------------------------
# The ranks
# ----------------------------------------------------------------------


def _numpy(x):
    return x.detach().cpu().numpy()


def _problem(d):
    from orb_slam2_commit_tpu_torch import interop

    return interop.ba_problem_from_numpy(d, device="cpu")


def _solved(problem, res):
    return {"R": _numpy(problem.R), "t": _numpy(problem.t), "points": _numpy(problem.points),
            "chi2": _numpy(res.chi2), "inlier": _numpy(res.inlier), "cost": float(res.cost)}


def dba_cases(inputs, group, cam):
    """tests/test_distributed_ba.py's cases at the group's size."""
    import torch.distributed as dist

    from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba

    n = dist.get_world_size(group)
    out = {}
    for name, kw in (("obs_match", dict(n_iters=8, point_chunk=64)),
                     ("obs_converge", dict(n_iters=12, point_chunk=64))):
        p = _problem(inputs[name])
        p = p._replace(obs=dba.shard_observations(p.obs, n))
        out[name] = _solved(*dba.distributed_bundle_adjust(p, group, *cam, **kw))
    for name, iters in (("points_match", 8), ("points_converge", 12), ("points_blocks", 4)):
        part, plan = dba.partition_problem(_problem(inputs[name]), n)
        out[name] = _solved(*dba.distributed_bundle_adjust_points(part, group, *cam,
                                                                  n_iters=iters))
        out[name]["perm"] = plan.perm
        local = dba.point_block(part, dist.get_rank(group), plan.p_blk, plan.o_blk,
                                part.points.device)
        out[name]["local_points"] = _numpy(local.points)
        out[name]["p_blk"] = plan.p_blk
    out.update(loop_form_cases(inputs, group, cam))
    return out


def loop_form_cases(inputs, group, cam):
    """The sharded solves' two forms on this rank's block: the device loop
    (optim/ba.bundle_adjust_loop, run eagerly here: every LM and PCG
    iteration, the all-reduces run each time) and the early-exit form
    (bundle_adjust), observation-sharded and point-sharded."""
    import torch.distributed as dist

    from orb_slam2_commit_tpu_torch.optim import ba
    from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    p = _problem(inputs["obs_match"])
    p = p._replace(obs=dba.shard_observations(p.obs, n))
    blk = p.obs.valid.shape[0] // n
    obs_local = p._replace(obs=dba._rows(p.obs, rank * blk, (rank + 1) * blk))
    part, plan = dba.partition_problem(_problem(inputs["points_match"]), n)
    pts_local = dba.point_block(part, rank, plan.p_blk, plan.o_blk, part.points.device)
    out = {}
    for name, local, kw in (("loop_obs", obs_local, dict(point_chunk=64)),
                            ("loop_points", pts_local, dict(point_sharded=True))):
        out[name] = {form: _solved(*fn(local, *cam, n_iters=8, group=group, **kw))
                     for form, fn in (("loop", ba.bundle_adjust_loop),
                                      ("early", ba.bundle_adjust))}
    return out


def multihost_cases(inputs, group, cam):
    """tests/test_multihost.py's cases, and the loop closer's sharded
    global BA, at the group's size."""
    import dataclasses

    import torch.distributed as dist

    from orb_slam2_commit_tpu_torch import interop
    from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba
    from orb_slam2_commit_tpu_torch.parallel import multihost as mh
    from orb_slam2_commit_tpu_torch.slam.loop_closing import LoopCloser
    from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

    n = dist.get_world_size(group)
    mh.initialize(device="cpu")            # already joined: a no-op
    assert mh.global_group() is dist.group.WORLD
    out = {}
    part, plan = dba.partition_problem(_problem(inputs["layout"]), n)
    g = mh.distribute_problem(part, plan, group)
    out["layout"] = {"part_R": _numpy(part.R), "part_points": _numpy(part.points),
                     "part_pt_idx": _numpy(part.obs.pt_idx), "p_blk": plan.p_blk,
                     "o_blk": plan.o_blk, "R": _numpy(g.R), "points": _numpy(g.points),
                     "pt_idx": _numpy(g.obs.pt_idx)}
    for name, iters in (("match", 8), ("shards", 4)):
        part, plan = dba.partition_problem(_problem(inputs[name]), n)
        ref = _solved(*dba.distributed_bundle_adjust_points(part, group, *cam, n_iters=iters))
        local, res = mh.bundle_adjust_multihost(mh.distribute_problem(part, plan, group),
                                                plan, group, *cam, n_iters=iters)
        out[name] = {"ref": ref, "local": _solved(local, res),
                     "shards": mh.local_point_shards(local), "p_blk": plan.p_blk}

    # The loop closer's global BA: sharded over the group, then (every
    # rank alike) plain.
    c = inputs["closer"]
    cfg = synthetic_config(width=c["width"], height=c["height"], n_features=c["n_features"])
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, fx=c["fx"],
                                                              fy=c["fy"]))
    for route in ("1", "0"):
        os.environ["ORB_DISTRIBUTED_GBA"] = route
        m = interop.map_state_from_numpy(c["map"])
        LoopCloser(cfg, m, None, device="cpu").run_global_ba(anchor_kf=0, n_iters=10)
        out[f"closer_{route}"] = {"kf_pose_R": m.kf_pose_R.copy(),
                                  "kf_pose_t": m.kf_pose_t.copy(), "pt_pos": m.pt_pos.copy()}
    return out


def main(argv):
    cases, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        cam = inputs["cam"]
        run = {"dba": dba_cases, "multihost": multihost_cases}[cases]
        out = run(inputs, dist.group.WORLD, cam)
        out["rank"] = dist.get_rank()
        with open(os.path.join(workdir, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(workdir, f"rank{rank}.pkl.tmp"),
                   os.path.join(workdir, f"rank{rank}.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
