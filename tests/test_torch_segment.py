"""The port's ordered segment sums (optim/segment.py) and its thread-safe
full-float32 guard (utils/precision.py), on the CPU.

The ordered sum (the card's route, asked for here with ordered=True) holds
index_add_ in float64 to 1e-12 on ids with repeats, empty segments, rows
left out and no segment at all; the CPU route is index_add_ itself, bit for
bit. The BA and the pose graph hold their results on the ordered route to
the index_add_ route. full_float32 restores a caller's "high" only when the
last of two overlapping threads has left, and the kernels' launch counter
counts every launch from several threads.
"""

import threading

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.optim import ba, pose_graph, segment
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

torch.set_num_threads(1)

SUM_TOL = 1e-12


def _case(kind, rng):
    """(ids [O], n, include [O] or None, vals [O, ...] float64)."""
    if kind == "repeats":
        idx = rng.integers(0, 7, 200)
        return idx, 7, None, rng.normal(size=(200, 6, 6))
    if kind == "empty_segments":
        idx = rng.choice([0, 3, 9], 150)
        return idx, 12, None, rng.normal(size=(150, 3))
    if kind == "include":
        idx = rng.integers(0, 5, 90)
        return idx, 5, rng.random(90) < 0.6, rng.normal(size=(90, 7))
    if kind == "one_segment":
        return np.zeros(300, int), 1, None, rng.normal(size=(300, 2))
    if kind == "no_rows":
        return np.zeros(0, int), 4, None, np.zeros((0, 3))
    if kind == "no_segments":
        return np.zeros(0, int), 0, None, np.zeros((0, 3))
    raise ValueError(kind)


CASES = ("repeats", "empty_segments", "include", "one_segment", "no_rows", "no_segments")


@pytest.mark.parametrize("kind", CASES)
def test_ordered_sum_equals_index_add(kind):
    rng = np.random.default_rng(CASES.index(kind))
    idx, n, include, vals = _case(kind, rng)
    idx_t, vals_t = torch.from_numpy(idx), torch.from_numpy(vals)
    inc_t = None if include is None else torch.from_numpy(include)
    keep = np.ones(idx.shape[0], bool) if include is None else include
    want = torch.zeros((n,) + vals.shape[1:], dtype=torch.float64).index_add_(
        0, idx_t[torch.from_numpy(keep)], vals_t[torch.from_numpy(keep)])
    seg = segment.segments(idx_t, n, inc_t, ordered=True)
    got = segment.segment_sum(vals_t, seg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=SUM_TOL)
    # Each segment's rows in ascending order, padded with the row count.
    g = seg.gather.numpy()
    for j in range(n):
        rows = g[j][g[j] < idx.shape[0]]
        np.testing.assert_array_equal(rows, np.where((idx == j) & keep)[0])
    # The CPU route is index_add_ itself.
    cpu = segment.segment_sum(vals_t, segment.segments(idx_t, n, inc_t))
    assert segment.segments(idx_t, n, inc_t).gather is None
    assert torch.equal(cpu, want)


def test_ordered_sum_repeats_its_bits():
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, 11, 5000))
    vals = torch.from_numpy(rng.normal(size=(5000, 6)).astype(np.float32))
    seg = segment.segments(idx, 11, ordered=True)
    first = segment.segment_sum(vals, seg)
    for _ in range(3):
        assert torch.equal(segment.segment_sum(vals, seg), first)


def _ba_problem(seed, repeats=False):
    """8 cameras (2 fixed) on a line, 512 points, ~70% seen by each camera,
    0.5 px noise; with repeats, camera 3 sees points 0-19 three times each
    (a keyframe that binds one point to several features), so the Schur
    chunks' (camera, point) slots sum several observations."""
    rng = np.random.default_rng(seed)
    K, P = 8, 512
    pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (P, 3))
    R = np.tile(np.eye(3), (K, 1, 1))
    t = np.stack([-np.array([0.2 * k, 0.0, 0.0]) for k in range(K)])
    cam_idx, pt_idx, uv = [], [], []
    for k in range(K):
        pc = pts @ R[k].T + t[k]
        proj = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240], -1)
        sel = np.where(rng.random(P) < 0.7)[0]
        cam_idx.append(np.full(sel.size, k))
        pt_idx.append(sel)
        uv.append(proj[sel] + rng.normal(0, 0.5, (sel.size, 2)))
    if repeats:
        pc = pts[:20] @ R[3].T + t[3]
        proj = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240], -1)
        for _ in range(2):
            cam_idx.append(np.full(20, 3))
            pt_idx.append(np.arange(20))
            uv.append(proj + rng.normal(0, 0.5, (20, 2)))
    cam_idx, pt_idx, uv = (np.concatenate(a) for a in (cam_idx, pt_idx, uv))
    O = 4096
    pad = O - cam_idx.size

    def padded(a, fill=0):
        return torch.from_numpy(np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]))

    obs = ba.BAObservations(
        cam_idx=padded(cam_idx.astype(np.int32)), pt_idx=padded(pt_idx.astype(np.int32)),
        uvr=padded(np.concatenate([uv, np.zeros((uv.shape[0], 1))], 1).astype(np.float32)),
        inv_sigma2=padded(np.ones(cam_idx.size, np.float32)),
        is_stereo=padded(np.zeros(cam_idx.size, bool)),
        valid=padded(np.ones(cam_idx.size, bool), False))
    noisy = pts + rng.normal(0, 0.05, pts.shape)
    t_noisy = t + np.concatenate([np.zeros((2, 3)), rng.normal(0, 0.02, (K - 2, 3))])
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    return ba.BAProblem(R=torch.from_numpy(R.astype(np.float32)),
                        t=torch.from_numpy(t_noisy.astype(np.float32)),
                        fixed=torch.from_numpy(fixed),
                        points=torch.from_numpy(noisy.astype(np.float32)),
                        point_valid=torch.ones(P, dtype=torch.bool), obs=obs)


@pytest.mark.parametrize("solver, repeats", [("dense", False), ("pcg", False),
                                             ("dense", True)])
def test_bundle_adjust_on_the_ordered_route(solver, repeats, monkeypatch):
    """The BA with the card's ordered sums on CPU tensors against the
    index_add_ route: the same solve to float32 rounding (1e-4 after 5 LM
    steps, the CG's own stop at 1e-8 of the residual included)."""
    problem = _ba_problem(3, repeats)
    want, wres = ba.bundle_adjust(problem, 500.0, 500.0, 320.0, 240.0, 0.0, n_iters=5,
                                  solver=solver)
    real = segment.segments
    monkeypatch.setattr(ba, "segments", lambda *a, **k: real(*a, **k, ordered=True))
    got, gres = ba.bundle_adjust(problem, 500.0, 500.0, 320.0, 240.0, 0.0, n_iters=5,
                                 solver=solver)
    np.testing.assert_allclose(got.points.numpy(), want.points.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=1e-4)
    assert float(gres.cost) < 0.5 * float(ba.bundle_adjust(
        problem, 500.0, 500.0, 320.0, 240.0, 0.0, n_iters=0)[1].cost)
    assert abs(float(gres.cost) - float(wres.cost)) <= 1e-4 * float(wres.cost)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_on_the_ordered_route(solver, monkeypatch):
    """A ring of 12 Sim3 vertices, its edges measured on the true poses
    and the vertices perturbed (no residual is the identity, where the
    Jacobian is NaN): the ordered sums against the index_add_ route."""
    from orb_slam2_commit_tpu_torch.ops import lie

    rng = np.random.default_rng(4)
    K = 12
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    R = torch.from_numpy(np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                             [-np.sin(a), 0, np.cos(a)]]) for a in ang]))
    t = torch.from_numpy(np.stack([[3 * np.cos(a), 0.1 * k, 3 * np.sin(a)]
                                   for k, a in enumerate(ang)]))
    s = torch.ones(K, dtype=torch.float64)
    ei = torch.tensor(list(range(K)), dtype=torch.int64)
    ej = torch.tensor([(k + 1) % K for k in range(K)], dtype=torch.int64)
    sm, Rm, tm = lie.sim3_compose(s[ei], R[ei], t[ei], *lie.sim3_inverse(s[ej], R[ej], t[ej]))
    w = torch.from_numpy(rng.normal(0, 0.03, (K, 3)))
    R = lie.so3_exp(w) @ R
    t = t + torch.from_numpy(rng.normal(0, 0.05, t.shape))
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    g = pose_graph.Sim3Graph(s=s.float(), R=R.float(), t=t.float(), fixed=fixed, edge_i=ei,
                             edge_j=ej, meas_s=sm.float(), meas_R=Rm.float(),
                             meas_t=tm.float(), edge_valid=torch.ones(K, dtype=torch.bool))
    want = pose_graph.optimize_sim3_graph(g, n_iters=5, solver=solver)
    real = segment.segments
    monkeypatch.setattr(pose_graph, "segments", lambda *a, **k: real(*a, **k, ordered=True))
    got = pose_graph.optimize_sim3_graph(g, n_iters=5, solver=solver)
    assert not torch.equal(want.t, g.t)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.s.numpy(), want.s.numpy(), atol=1e-5)


def test_full_float32_restores_only_after_the_last_thread():
    """Two threads in full_float32 functions at once, the caller's setting
    "high": it reads "highest" while either is inside, and "high" once
    both have left, whichever leaves first."""
    entered = [threading.Event(), threading.Event()]
    leave = [threading.Event(), threading.Event()]
    seen = {}

    @full_float32
    def hold(i):
        entered[i].set()
        leave[i].wait(timeout=30)
        seen[i] = torch.get_float32_matmul_precision()

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        threads = [threading.Thread(target=hold, args=(i,)) for i in range(2)]
        threads[0].start()
        entered[0].wait(timeout=30)
        threads[1].start()
        entered[1].wait(timeout=30)
        leave[0].set()
        threads[0].join(timeout=30)
        assert torch.get_float32_matmul_precision() == "highest"
        leave[1].set()
        threads[1].join(timeout=30)
        assert seen == {0: "highest", 1: "highest"}
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_launch_counter_counts_every_thread():
    before = _build.launches["pose_lm"]

    def count():
        for _ in range(2000):
            _build.count_launch("pose_lm")

    threads = [threading.Thread(target=count) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert _build.launches["pose_lm"] == before + 8000
    _build.launches["pose_lm"] = before
