"""The port's sharded bundle adjustment (parallel/distributed_ba.py) on the
CPU against the JAX package's: tests/test_distributed_ba.py's cases.

The problems are tests/test_optim.make_ba_problem's (6 cameras, 128-200
points, two fixed cameras, float64 on both sides: x64 is on in the suite).
The port's side runs once, at module scope, in a gloo world of 4 ranks,
one process and one thread a rank (tests/torch_dist_ranks.py; the world
and each collective under a timeout); the JAX side on a 4-device mesh
(`make_mesh(4)`) of the suite's 8 virtual devices.
- partition_problem(., 8) equal to JAX's in perm, p_blk, o_blk and every
  leaf; shard_observations pads as JAX pads;
- the observation-sharded and the point-sharded solves: every rank
  returns the same bits, and R and t within 1e-6 of JAX's, points within
  1e-5, and the inlier flags (scatter_obs for the point-sharded slots)
  equal;
- both converge to the ground truth (the JAX tests' gates);
- each rank holds p_blk points;
- on each rank's block, the device-loop form (ba.bundle_adjust_loop: the
  card's CUDA graph form, run eagerly on the CPU) gives the early-exit
  form's bits, observation-sharded and point-sharded.
Nothing launches a kernel here."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.parallel import distributed_ba as jdba
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba

sys.path.insert(0, str(Path(__file__).parent))
from test_optim import BF, CX, CY, FX, FY, make_ba_problem, rot_angle  # noqa: E402
from torch_dist_ranks import spawn_world  # noqa: E402

torch.set_num_threads(1)

WORLD = 4
POSE_TOL, POINT_TOL = 1e-6, 1e-5
CASES = {"obs_match": 7, "obs_converge": 8, "points_match": 11, "points_converge": 14,
         "points_blocks": 12}
N_PTS = {"obs_converge": 160, "points_converge": 160, "points_blocks": 200}


def _np_problem(p):
    """A JAX BAProblem's leaves as numpy (what the ranks are sent)."""
    return types.SimpleNamespace(
        R=np.asarray(p.R), t=np.asarray(p.t), fixed=np.asarray(p.fixed),
        points=np.asarray(p.points), point_valid=np.asarray(p.point_valid),
        obs=types.SimpleNamespace(**{f: np.asarray(getattr(p.obs, f))
                                     for f in p.obs._fields}))


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


@pytest.fixture(scope="module")
def problems():
    return {name: make_ba_problem(seed=seed, n_cams=6, n_pts=N_PTS.get(name, 128))
            for name, seed in CASES.items()}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """Every case solved once in a 4-rank gloo world -> each rank's results."""
    inputs = {"cam": (FX, FY, CX, CY, BF)}
    inputs.update({name: _np_problem(p[0]) for name, p in problems.items()})
    return spawn_world("dba", WORLD, inputs, tmp_path_factory.mktemp("dba_world"))


@pytest.fixture(scope="module")
def jax_runs(problems):
    mesh = jdba.make_mesh(WORLD)
    p = problems["obs_match"][0]
    obs_out = jdba.distributed_bundle_adjust(
        p._replace(obs=jdba.shard_observations(p.obs, WORLD)), mesh, FX, FY, CX, CY, BF,
        n_iters=8, point_chunk=64)
    part, plan = jdba.partition_problem(problems["points_match"][0], WORLD)
    pts_out = jdba.distributed_bundle_adjust_points(part, mesh, FX, FY, CX, CY, BF, n_iters=8)
    return obs_out, pts_out, plan


def _same_on_every_rank(ranks, case):
    for r in ranks[1:]:
        for k in ("R", "t", "points", "chi2", "inlier"):
            np.testing.assert_array_equal(r[case][k], ranks[0][case][k], err_msg=k)


@pytest.mark.parametrize("n", [8, 3])
def test_partition_equals_jax(problems, n):
    jp = problems["points_blocks"][0]
    jpart, jplan = jdba.partition_problem(jp, n)
    part, plan = dba.partition_problem(interop.ba_problem_from_numpy(
        _np_problem(jp), device="cpu"), n)
    np.testing.assert_array_equal(plan.perm, jplan.perm)
    assert (plan.p_blk, plan.o_blk, plan.n_points, plan.n_obs, plan.n_devices) == (
        jplan.p_blk, jplan.o_blk, jplan.n_points, jplan.n_obs, jplan.n_devices)
    for name in ("R", "t", "fixed", "points", "point_valid"):
        np.testing.assert_array_equal(getattr(part, name).numpy(),
                                      np.asarray(getattr(jpart, name)), err_msg=name)
    for name in part.obs._fields:
        got, want = getattr(part.obs, name).numpy(), np.asarray(getattr(jpart.obs, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # The plan crosses back from JAX's type unchanged.
    assert interop.partition_plan_from_numpy(jplan)._asdict().keys() == plan._asdict().keys()
    np.testing.assert_array_equal(interop.partition_plan_from_numpy(jplan).perm, plan.perm)
    payload = np.arange(plan.n_obs, dtype=np.int32)
    slots = np.zeros(plan.perm.shape[0], np.int32)
    slots[plan.perm >= 0] = payload[plan.perm[plan.perm >= 0]]
    np.testing.assert_array_equal(plan.scatter_obs(slots), payload)


def test_uneven_observation_padding():
    jp, *_ = make_ba_problem(seed=9, n_cams=4, n_pts=50)
    p = interop.ba_problem_from_numpy(_np_problem(jp), device="cpu")
    obs = dba.shard_observations(p.obs, 8)
    jobs = jdba.shard_observations(jp.obs, 8)
    assert obs.valid.shape[0] % 8 == 0
    assert int(obs.valid.sum()) == int(p.obs.valid.sum())
    for name in obs._fields:
        np.testing.assert_array_equal(getattr(obs, name).numpy(),
                                      np.asarray(getattr(jobs, name)), err_msg=name)


def test_observation_sharded_matches_jax(ranks, jax_runs):
    _same_on_every_rank(ranks, "obs_match")
    (jout, jres), _, _ = jax_runs
    got = ranks[0]["obs_match"]
    np.testing.assert_allclose(got["R"], np.asarray(jout.R), atol=POSE_TOL)
    np.testing.assert_allclose(got["t"], np.asarray(jout.t), atol=POSE_TOL)
    np.testing.assert_allclose(got["points"], np.asarray(jout.points), atol=POINT_TOL)
    np.testing.assert_array_equal(got["inlier"], np.asarray(jres.inlier))


def test_point_sharded_matches_jax(ranks, jax_runs):
    _same_on_every_rank(ranks, "points_match")
    _, (jout, jres), jplan = jax_runs
    got = ranks[0]["points_match"]
    np.testing.assert_array_equal(got["perm"], jplan.perm)
    np.testing.assert_allclose(got["R"], np.asarray(jout.R), atol=POSE_TOL)
    np.testing.assert_allclose(got["t"], np.asarray(jout.t), atol=POSE_TOL)
    n = jplan.n_points
    np.testing.assert_allclose(got["points"][:n], np.asarray(jout.points)[:n], atol=POINT_TOL)
    np.testing.assert_array_equal(jplan.scatter_obs(got["inlier"], fill=False),
                                  jplan.scatter_obs(np.asarray(jres.inlier), fill=False))


@pytest.mark.parametrize("case", ["obs_converge", "points_converge"])
def test_converges_to_ground_truth(ranks, problems, case):
    _same_on_every_rank(ranks, case)
    _, R_true, t_true, _, _ = problems[case]
    got = ranks[0][case]
    for k in range(2, 6):
        assert rot_angle(got["R"][k], R_true[k]) < 0.02
        np.testing.assert_allclose(got["t"][k], t_true[k], atol=2e-3)


def test_point_state_is_sharded(ranks):
    """Each rank holds 1/n of the points: p_blk of them."""
    assert ranks[0]["points_blocks"]["p_blk"] == -(-200 // WORLD)
    blocks = [r["points_blocks"]["local_points"] for r in ranks]
    for b in blocks:
        assert b.shape == (-(-200 // WORLD), 3)
    assert sorted(r["rank"] for r in ranks) == list(range(WORLD))


@pytest.mark.parametrize("case", ["loop_obs", "loop_points"])
def test_sharded_loop_form_equals_early_exit(ranks, case):
    """The sharded solve's device-loop form against its early-exit form on
    every rank, over gloo: every leaf bit for bit."""
    for r in ranks:
        loop, early = r[case]["loop"], r[case]["early"]
        for k in ("R", "t", "points", "chi2", "inlier"):
            np.testing.assert_array_equal(loop[k], early[k], err_msg=f"rank {r['rank']} {k}")
        assert loop["cost"] == early["cost"]
