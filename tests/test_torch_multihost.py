"""The port's multi-process entry (parallel/multihost.py) and the loop
closer's sharded global BA on the CPU: tests/test_multihost.py's cases.

- `initialize` with no cluster variables starts a world of one on an
  in-process store, and a second call is a no-op; in that world the
  observation-sharded solve equals the plain one bit for bit (each
  all-reduce is a copy), and the loop closer with ORB_DISTRIBUTED_GBA=1
  writes back the same bits as with 0.
- In a gloo world of 2 ranks (tests/torch_dist_ranks.py, spawned once at
  module scope, one thread a rank, under timeouts): `distribute_problem`
  gives each rank its own point and observation block and the whole camera
  leaves; `bundle_adjust_multihost` on that block equals
  `distributed_bundle_adjust_points` within 1e-12 (poses, and the rank's
  points against its slice of the gathered table); `local_point_shards`
  is the rank's block, and the blocks in rank order make the table.
- The loop closer's run_global_ba sharded over the 2 ranks
  (ORB_DISTRIBUTED_GBA=1) on tests/test_global_ba.py's noisy map (6
  keyframes, 100 landmarks): every rank writes the same map; it equals the
  port's plain solve within 1e-5; it is held against the JAX closer with
  ORB_DISTRIBUTED_GBA=1 (sharded over the suite's 8 virtual devices) within
  tests/test_torch_loop_closing.py's tolerances (0.1 deg, 0.01, 0.03), and
  meets the JAX global BA test's gate (reprojection RMSE below 0.2 x its
  start).
Nothing launches a kernel here."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orb_slam2_commit_tpu.slam import loop_closing as jloop
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba
from orb_slam2_commit_tpu_torch.parallel import multihost as mh
from orb_slam2_commit_tpu_torch.slam.loop_closing import LoopCloser, use_distributed_gba

sys.path.insert(0, str(Path(__file__).parent))
from test_global_ba import build_noisy_map, reproj_rmse  # noqa: E402
from test_optim import BF, CX, CY, FX, FY, make_ba_problem, rot_angle  # noqa: E402
from test_torch_distributed_ba import _np_problem  # noqa: E402
from test_torch_loop_closing import PT_TOL, ROT_DEG_TOL, T_TOL, _port_config  # noqa: E402
from torch_dist_ranks import spawn_world  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
SAME_TOL = 1e-12
ROUTE_TOL = 1e-5
CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


@pytest.fixture(scope="module")
def noisy_map():
    return build_noisy_map(np.random.default_rng(3))


@pytest.fixture(scope="module")
def problems():
    return {name: make_ba_problem(seed=seed, n_cams=n_cams, n_pts=n_pts)
            for name, seed, n_cams, n_pts in (("layout", 21, 6, 200), ("match", 22, 6, 128),
                                               ("shards", 23, 5, 96))}


@pytest.fixture(scope="module")
def ranks(problems, noisy_map, tmp_path_factory):
    jcfg, jm, *_ = noisy_map
    cam = jcfg.camera
    inputs = {"cam": (FX, FY, CX, CY, BF),
              "closer": {"map": interop.map_state_to_numpy(jm), "width": cam.width,
                         "height": cam.height, "n_features": jcfg.orb.n_features,
                         "fx": cam.fx, "fy": cam.fy}}
    inputs.update({name: _np_problem(p[0]) for name, p in problems.items()})
    return spawn_world("multihost", WORLD, inputs, tmp_path_factory.mktemp("mh_world"))


def test_initialize_is_a_world_of_one_without_cluster(monkeypatch, noisy_map):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    try:
        mh.initialize(device="cpu")
        mh.initialize(device="cpu")          # idempotent
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        group = mh.global_group()
        monkeypatch.delenv("ORB_DISTRIBUTED_GBA", raising=False)
        assert not use_distributed_gba()     # a world of one: the plain solve

        # One rank: the sharded solve is the plain one, bit for bit.
        jp, *_ = make_ba_problem(seed=24, n_cams=6, n_pts=96)
        p = interop.ba_problem_from_numpy(_np_problem(jp), device="cpu")
        want, want_res = ba.bundle_adjust(p, FX, FY, CX, CY, BF, n_iters=6, point_chunk=64)
        got, got_res = dba.distributed_bundle_adjust(
            p._replace(obs=dba.shard_observations(p.obs, 1)), group, FX, FY, CX, CY, BF,
            n_iters=6, point_chunk=64)
        for a, b in zip((got.R, got.t, got.points, got_res.chi2, got_res.inlier),
                        (want.R, want.t, want.points, want_res.chi2, want_res.inlier)):
            assert torch.equal(a, b)

        # And so is the loop closer's global BA.
        jcfg, jm, *_ = noisy_map
        maps = {}
        for route in ("1", "0"):
            monkeypatch.setenv("ORB_DISTRIBUTED_GBA", route)
            assert use_distributed_gba() == (route == "1")
            maps[route] = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
            LoopCloser(_port_config(jcfg), maps[route], None, device="cpu").run_global_ba(
                anchor_kf=0, n_iters=10)
        for k in ("kf_pose_R", "kf_pose_t", "pt_pos"):
            np.testing.assert_array_equal(getattr(maps["1"], k), getattr(maps["0"], k))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_raises_when_the_cluster_is_unreachable(monkeypatch):
    """A cluster asked for and not joined raises; nothing falls back."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError):
        mh.initialize(coordinator_address="127.0.0.1:1", device="cpu")   # no world size
    assert not dist.is_initialized()


def test_distribute_problem_layout(ranks):
    for r, out in enumerate(ranks):
        lay = out["layout"]
        p, o = lay["p_blk"], lay["o_blk"]
        assert lay["points"].shape[0] == p == -(-200 // WORLD)
        np.testing.assert_array_equal(lay["points"], lay["part_points"][r * p:(r + 1) * p])
        np.testing.assert_array_equal(lay["pt_idx"], lay["part_pt_idx"][r * o:(r + 1) * o])
        np.testing.assert_array_equal(lay["R"], lay["part_R"])     # replicated


def test_matches_point_sharded_path(ranks, problems):
    _, R_true, *_ = problems["match"]
    for r, out in enumerate(ranks):
        got, ref, p = out["match"]["local"], out["match"]["ref"], out["match"]["p_blk"]
        np.testing.assert_allclose(got["R"], ref["R"], atol=SAME_TOL)
        np.testing.assert_allclose(got["t"], ref["t"], atol=SAME_TOL)
        np.testing.assert_allclose(got["points"], ref["points"][r * p:(r + 1) * p],
                                   atol=SAME_TOL)
        np.testing.assert_array_equal(got["R"], ranks[0]["match"]["local"]["R"])
        for k in range(2, 6):
            assert rot_angle(got["R"][k], R_true[k]) < 0.02


def test_local_point_shards_cover_map(ranks):
    shards = [out["shards"]["shards"] for out in ranks]
    for out, s in zip(ranks, shards):
        assert s.shape[0] == out["shards"]["p_blk"]
        np.testing.assert_array_equal(s, out["shards"]["local"]["points"])
    np.testing.assert_array_equal(np.concatenate(shards), ranks[0]["shards"]["ref"]["points"])


def test_loop_closer_sharded_global_ba(ranks, noisy_map, monkeypatch):
    jcfg, jm, *_ = noisy_map
    keys = ("kf_pose_R", "kf_pose_t", "pt_pos")
    for out in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(out["closer_1"][k], ranks[0]["closer_1"][k])
    got, plain = ranks[0]["closer_1"], ranks[0]["closer_0"]
    for k in keys:
        np.testing.assert_allclose(got[k], plain[k], atol=ROUTE_TOL, err_msg=k)

    jmap = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
    before = reproj_rmse(jmap, jcfg)
    monkeypatch.setenv("ORB_DISTRIBUTED_GBA", "1")
    jloop.LoopCloser(jcfg, jm, None).run_global_ba(anchor_kf=0, n_iters=10)
    kfs = np.where(jm.kf_valid)[0]
    worst = max(rot_angle(got["kf_pose_R"][k], jm.kf_pose_R[k]) for k in kfs)
    assert worst < ROT_DEG_TOL, worst
    assert np.abs(got["kf_pose_t"][kfs] - jm.kf_pose_t[kfs]).max() < T_TOL
    pts = np.where(jm.pt_valid)[0]
    assert np.abs(got["pt_pos"][pts] - jm.pt_pos[pts]).max() < PT_TOL
    for k in keys:
        setattr(jmap, k, got[k])
    assert reproj_rmse(jmap, jcfg) < 0.2 * before
