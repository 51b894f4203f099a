"""The port's abortable background global BA (slam/global_ba.py) on the
CPU: tests/test_global_ba.py's cases, and its merge against the JAX
package's.

tests/test_global_ba.py's noisy map (6 keyframes on a line, 100
landmarks, exact observations, noisy poses and points) is built with the
JAX package and carried into the port (interop.map_state_from_numpy):
- a blocking solve cuts the reprojection error below 0.2 x its start, one
  merge and one map change (the JAX test's gates);
- a run whose generation is already stale aborts without touching the map;
- `_merge` of one solution (the snapshot moved by a known rigid G, a child
  keyframe and a point made during the "solve") equals the JAX runner's
  merge on the same map to 1e-10, and both equal G applied to the world;
- a threaded launch aborted at once counts one merge or one abort, and a
  relaunch merges and does not raise the error;
- an exception on the runner's thread is raised again by join;
- tests/test_loop_closing.py's drifted loop map closed by the port's
  LoopCloser with a background runner under a lock: the runner merges, and
  the ATE after is below 0.75 x before (the JAX test's gate).
Nothing launches a kernel here."""

import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models.map_state import INVALID
from orb_slam2_commit_tpu.slam.global_ba import GlobalBARunner as JRunner
from orb_slam2_commit_tpu.slam.tracking import build_ba_problem as j_build_ba_problem
from orb_slam2_commit_tpu.utils.trajectory import ate_rmse
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase
from orb_slam2_commit_tpu_torch.models.vocabulary import BinaryVocabulary
from orb_slam2_commit_tpu_torch.slam import global_ba
from orb_slam2_commit_tpu_torch.slam.global_ba import GlobalBARunner
from orb_slam2_commit_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam2_commit_tpu_torch.slam.tracking import build_ba_problem
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

sys.path.insert(0, str(Path(__file__).parent))
from test_global_ba import N_FEAT, build_noisy_map, reproj_rmse  # noqa: E402
from test_loop_closing import K_KF, build_drifted_loop_map  # noqa: E402
from test_torch_loop_closing import _centres, _port_config  # noqa: E402

torch.set_num_threads(1)

MERGE_TOL = 1e-10


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


def _port_map(seed):
    """The JAX test's noisy map (its JAX MapState and config) and the same
    map in the port."""
    jcfg, jm, *_ = build_noisy_map(np.random.default_rng(seed))
    return jcfg, jm, interop.map_state_from_numpy(interop.map_state_to_numpy(jm))


def _runner(jcfg, **kw):
    return GlobalBARunner(_port_config(jcfg), device="cpu", **kw)


def test_blocking_solve_reduces_error():
    jcfg, _, m = _port_map(0)
    before = reproj_rmse(m, jcfg)
    runner = _runner(jcfg)
    runner.launch(m, anchor_kf=0, n_iters=10, blocking=True)
    assert runner.n_merged == 1 and m.big_change_idx == 1
    assert reproj_rmse(m, jcfg) < 0.2 * before


def test_stale_generation_aborts_without_touching_map():
    jcfg, _, m = _port_map(1)
    pose_before, pts_before = m.kf_pose_t.copy(), m.pt_pos.copy()
    runner = _runner(jcfg)
    runner._run(m, anchor_kf=0, n_iters=4, gen=-1)
    assert runner.n_aborted == 1 and runner.n_merged == 0
    np.testing.assert_array_equal(m.kf_pose_t, pose_before)
    np.testing.assert_array_equal(m.pt_pos, pts_before)


def _grow_during_solve(m, snap_kf):
    """tests/test_global_ba.py's growth: a child of the last snapshot
    keyframe and a new point it observes -> (child, new point id)."""
    valid = np.where(m.kf_valid)[0]
    parent = int(valid[-1])
    R_child = m.kf_pose_R[parent].copy()
    t_child = m.kf_pose_t[parent] + np.array([0.1, 0.0, 0.02])
    new_pid = m.add_points(np.array([[0.3, 0.2, 5.0]]), first_kf=snap_kf)[0]
    binding = np.full(N_FEAT, INVALID, np.int32)
    binding[0] = new_pid
    child = m.add_keyframe(
        R_child, t_child, np.zeros((N_FEAT, 2)), np.zeros(N_FEAT, np.int32),
        np.zeros(N_FEAT, np.float32), np.zeros((N_FEAT, 8), np.uint32),
        np.ones(N_FEAT, bool), binding, frame_id=99, timestamp=99.0)
    m.kf_parent[child] = parent
    return child, new_pid


def test_merge_equals_jax_and_propagates():
    jcfg, jm, pm = _port_map(2)
    valid = np.where(jm.kf_valid)[0]
    j_asm = j_build_ba_problem(jm, free_kfs=valid[1:], fixed_kfs=valid[:1],
                               point_ids=np.where(jm.pt_valid)[0], orb_cfg=jcfg.orb)
    p_asm = build_ba_problem(pm, free_kfs=valid[1:], fixed_kfs=valid[:1],
                             point_ids=np.where(pm.pt_valid)[0], orb_cfg=jcfg.orb,
                             device="cpu")
    np.testing.assert_array_equal(p_asm.kf_ids, j_asm.kf_ids)
    np.testing.assert_array_equal(p_asm.point_ids, j_asm.point_ids)
    snap = (jm.next_kf, jm.next_pt)
    (child, new_pid), _ = (_grow_during_solve(jm, snap[0]), _grow_during_solve(pm, snap[0]))
    R_child, t_child = jm.kf_pose_R[child].copy(), jm.kf_pose_t[child].copy()
    p_old = jm.pt_pos[new_pid].copy()

    theta = 0.2
    Rg = np.array([[np.cos(theta), 0, np.sin(theta)], [0, 1, 0],
                   [-np.sin(theta), 0, np.cos(theta)]])
    tg = np.array([0.3, -0.1, 0.2])
    R_sol = np.asarray(j_asm.problem.R, np.float64).copy()
    t_sol = np.asarray(j_asm.problem.t, np.float64).copy()
    for ci in range(len(j_asm.kf_ids)):
        Rc, tc = R_sol[ci].copy(), t_sol[ci].copy()
        R_sol[ci] = Rc @ Rg.T
        t_sol[ci] = -Rc @ Rg.T @ tg + tc
    pts_sol = np.asarray(j_asm.problem.points, np.float64).copy()
    n_real = j_asm.point_ids.size
    pts_sol[:n_real] = pts_sol[:n_real] @ Rg.T + tg
    JRunner(jcfg)._merge(jm, j_asm, j_asm.problem._replace(R=R_sol, t=t_sol, points=pts_sol),
                         *snap)
    _runner(jcfg)._merge(pm, p_asm, types.SimpleNamespace(R=R_sol, t=t_sol, points=pts_sol),
                         *snap)

    for k in ("kf_pose_R", "kf_pose_t", "pt_pos"):
        np.testing.assert_allclose(getattr(pm, k), getattr(jm, k), rtol=0, atol=MERGE_TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(pm.pt_valid, jm.pt_valid)
    np.testing.assert_allclose(pm.kf_pose_R[child], R_child @ Rg.T, atol=MERGE_TOL)
    np.testing.assert_allclose(pm.kf_pose_t[child], -R_child @ Rg.T @ tg + t_child,
                               atol=MERGE_TOL)
    np.testing.assert_allclose(pm.pt_pos[new_pid], Rg @ p_old + tg, atol=MERGE_TOL)


def test_threaded_launch_and_abort():
    jcfg, _, m = _port_map(3)
    runner = _runner(jcfg, map_lock=threading.RLock())
    runner.launch(m, anchor_kf=0, n_iters=8)
    runner.request_abort()
    runner.join()
    assert runner.n_merged + runner.n_aborted == 1
    before = reproj_rmse(m, jcfg)
    runner.launch(m, anchor_kf=0, n_iters=10)
    runner.join()
    assert runner.n_merged >= 1 and not runner.running
    assert reproj_rmse(m, jcfg) <= before * 1.01


def test_runner_error_raised_on_join(monkeypatch):
    jcfg, _, m = _port_map(4)

    def failing(*args, **kwargs):
        raise ValueError("solve failed")

    monkeypatch.setattr(global_ba.ba, "bundle_adjust", failing)
    runner = _runner(jcfg, map_lock=threading.RLock())
    runner.launch(m, anchor_kf=0, n_iters=4)
    with pytest.raises(RuntimeError, match="global BA") as info:
        runner.join()
    assert isinstance(info.value.__cause__, ValueError)
    assert not runner.running and runner.n_merged == 0


def test_loop_closure_with_background_gba():
    rng = np.random.default_rng(0)
    jcfg, jm, R_true, t_true, _ = build_drifted_loop_map(rng)
    train = rng.integers(0, 2 ** 32, size=(2000, 8), dtype=np.uint32)
    m = interop.map_state_from_numpy(interop.map_state_to_numpy(jm))
    cfg = _port_config(jcfg)
    db = KeyFrameDatabase(BinaryVocabulary.train(train, k=8, levels=3, seed=2),
                          m.cfg.max_keyframes, device="cpu")
    closer = LoopCloser(cfg, m, db, essential_min_weight=30, device="cpu")
    lock = threading.RLock()
    closer.gba_runner = GlobalBARunner(cfg, map_lock=lock, device="cpu")
    pre_R, pre_t = m.kf_pose_R.copy(), m.kf_pose_t.copy()
    for k in range(K_KF):
        with lock:
            closer.process_keyframe(k)
    closer.gba_runner.join()
    assert closer.n_loops_closed >= 1 and closer.gba_runner.n_merged >= 1
    c_true = _centres(R_true[:K_KF], t_true[:K_KF])
    ate_pre = ate_rmse(_centres(pre_R[:K_KF], pre_t[:K_KF]), c_true, align_scale=True)
    ate_post = ate_rmse(_centres(m.kf_pose_R[:K_KF], m.kf_pose_t[:K_KF]), c_true,
                        align_scale=True)
    assert ate_post < 0.75 * ate_pre, (ate_pre, ate_post)
