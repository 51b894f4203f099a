"""The port's MapState and map-core counts on the CPU against the JAX
package's.

Each scenario of tests/test_map_state.py (insertion, covisibility, the
spanning tree, point removal and merging, stats refresh, keyframe culling
with re-parenting and frozen Tcp), and a longer seeded sequence that also
grows both capacities, runs on a JAX MapState and on the port's; every
table must come out equal (integer, boolean and float tables alike: the
host code is the same numpy). The port's numpy covisibility and
observation counts are held to the JAX package's native C++ core (or its
NumPy fallback where the core is not built) on the cases of
tests/test_native_core.py, with duplicate observations added. The
carry-across converters (interop.map_state_to_numpy / _from_numpy) round
trip a JAX map exactly.
"""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models import map_state as jms
from orb_slam2_commit_tpu.models import native_core as jnative
from orb_slam2_commit_tpu.utils.config import MapConfig as JMapConfig
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.models import map_state as pms
from orb_slam2_commit_tpu_torch.models import native_core
from orb_slam2_commit_tpu_torch.utils.config import MapConfig

torch.set_num_threads(1)

SIDES = {"jax": (jms.MapState, JMapConfig), "port": (pms.MapState, MapConfig)}


def small_map(side, n_feat=16, max_kf=8, max_pts=64):
    cls, cfg = SIDES[side]
    return cls.create(cfg(max_keyframes=max_kf, max_points=max_pts), n_feat)


def add_kf(m, point_idx, pose_t=None, rng=None):
    n = m.n_feat
    pi = np.full(n, -1, np.int32)
    pi[: len(point_idx)] = point_idx
    valid = np.zeros(n, bool)
    valid[: len(point_idx)] = True
    xy = np.zeros((n, 2)) if rng is None else rng.uniform(0, 400, (n, 2))
    octave = np.zeros(n, np.int32) if rng is None else rng.integers(0, 8, n).astype(np.int32)
    desc = (np.zeros((n, 8), np.uint32) if rng is None
            else rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32))
    return m.add_keyframe(
        np.eye(3), np.zeros(3) if pose_t is None else pose_t, xy, octave,
        np.zeros(n, np.float32), desc, valid, pi,
        frame_id=m.next_kf, timestamp=float(m.next_kf))


def sc_covisibility(side):
    m = small_map(side)
    ids = m.add_points(np.zeros((12, 3)), first_kf=0)
    add_kf(m, ids[:12])
    add_kf(m, ids[:3])
    add_kf(m, ids[:9])
    add_kf(m, ids[4:10])
    return m, list(m.covisible_keyframes(0)) + [int(p) for p in m.kf_parent]


def sc_points(side):
    m = small_map(side)
    ids = m.add_points(np.arange(15, dtype=float).reshape(5, 3), first_kf=0)
    add_kf(m, ids)
    add_kf(m, ids[:2])
    counts = m.observation_count()
    m.remove_points(ids[3:4])
    m.replace_point(int(ids[0]), int(ids[2]))
    m.replace_point(int(ids[1]), int(ids[4]))
    return m, list(counts[:5])


def sc_refresh(side):
    rng = np.random.default_rng(1)
    m = small_map(side, n_feat=24, max_pts=128)
    ids = m.add_points(rng.normal(0, 1, (30, 3)) + [0, 0, 5], first_kf=0)
    for k in range(4):
        add_kf(m, rng.choice(ids, 20, replace=False), pose_t=rng.normal(0, 0.2, 3), rng=rng)
    m.refresh_point_stats()
    m.refresh_point_stats(ids[:7])
    return m, []


def sc_reparent(side):
    m = small_map(side, n_feat=32, max_pts=128)
    ids = m.add_points(np.zeros((40, 3)), first_kf=0)
    k0 = add_kf(m, ids[:10])
    k1 = add_kf(m, ids[:10], pose_t=np.array([1.0, 0, 0]))
    k2 = add_kf(m, ids[:9])
    k3 = add_kf(m, ids[2:10])
    m.kf_parent[k2] = k1
    m.kf_parent[k3] = k1
    m.cov_weight[k3, k0] = m.cov_weight[k0, k3] = 1
    m.cov_weight[k3, k2] = m.cov_weight[k2, k3] = 7
    m.remove_keyframe(k1)
    m.kf_pose_t[k0] += 0.5
    m.remove_keyframe(k3)
    m.remove_keyframe(k2)
    return m, []


def sc_growth(side):
    """A seeded insert / remove / merge / cull sequence past both
    capacities (4 keyframes, 64 points at the start)."""
    rng = np.random.default_rng(7)
    m = small_map(side, n_feat=32, max_kf=4, max_pts=64)
    for k in range(9):
        new = m.add_points(rng.normal(0, 1, (12, 3)) + [0, 0, 4], first_kf=k)
        old = np.where(m.pt_valid)[0]
        seen = np.concatenate([new, rng.choice(old, min(old.size, 14), replace=False)])
        add_kf(m, seen[:32], pose_t=rng.normal(0, 0.3, 3), rng=rng)
        if k % 3 == 2:
            m.remove_points(rng.choice(np.where(m.pt_valid)[0], 3, replace=False))
            a, b = rng.choice(np.where(m.pt_valid)[0], 2, replace=False)
            m.replace_point(int(a), int(b))
        if k == 6:
            m.remove_keyframe(2)
        m.refresh_point_stats()
    return m, list(m.covisible_keyframes(int(m.next_kf - 1), 5, min_weight=2))


SCENARIOS = {f.__name__[3:]: f for f in (sc_covisibility, sc_points, sc_refresh,
                                         sc_reparent, sc_growth)}


def _assert_tables_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            assert got[k].dtype == w.dtype, k
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_tables_match_jax(name):
    jm, jout = SCENARIOS[name]("jax")
    pm, pout = SCENARIOS[name]("port")
    assert [int(v) for v in pout] == [int(v) for v in jout]
    _assert_tables_equal(interop.map_state_to_numpy(pm), interop.map_state_to_numpy(jm))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_carry_across_round_trip(name):
    jm, _ = SCENARIOS[name]("jax")
    d = interop.map_state_to_numpy(jm)
    pm = interop.map_state_from_numpy(d)
    _assert_tables_equal(interop.map_state_to_numpy(pm), d)
    # The copy is the port's own: changing it leaves the JAX map as it was.
    pm.kf_point_idx[:] = -1
    assert (jm.kf_point_idx == d["kf_point_idx"]).all()


def random_obs(rng, K=12, N=40, P=200, density=0.6, duplicates=0):
    kpi = np.full((K, N), -1, np.int32)
    for k in range(K):
        n_obs = int(density * N)
        kpi[k, :n_obs] = rng.choice(P, n_obs, replace=False)
        kpi[k, n_obs:n_obs + duplicates] = kpi[k, :duplicates]
    kv = np.ones(K, bool)
    kv[3] = False
    return kpi, kv


def _loop_covis_row(kpi, kv, k):
    """native/map_core.cpp's covis_row as a plain loop (the oracle where
    the C++ core is not built): keyframe j's observations of points that
    keyframe k observes."""
    out = np.zeros(kpi.shape[0], np.int32)
    mark = set(kpi[k][kpi[k] >= 0].tolist())
    for j in range(kpi.shape[0]):
        if j != k and kv[j] and kv[k]:
            out[j] = sum(int(p) in mark for p in kpi[j] if p >= 0)
    return out


@pytest.mark.parametrize("duplicates", [0, 3])
def test_native_core_counts_match_jax(duplicates):
    rng = np.random.default_rng(duplicates)
    kpi, kv = random_obs(rng, duplicates=duplicates)
    P = 200
    lib = jnative.get_lib()
    for k in (0, 3, 5, 11):
        got = native_core.covis_row(kpi, kv, P, k)
        want = (jnative.covis_row(kpi, kv, P, k) if lib is not None
                else _loop_covis_row(kpi, kv, k))
        np.testing.assert_array_equal(got, want)
    want = jnative.obs_counts(kpi, kv, P)
    if want is None:
        want = np.bincount(kpi[kv][kpi[kv] >= 0], minlength=P)
    np.testing.assert_array_equal(native_core.obs_counts(kpi, kv, P), want)
    M = native_core.covis_matrix(kpi, kv, P)
    if lib is not None:
        np.testing.assert_array_equal(M, jnative.covis_matrix(kpi, kv, P))
    np.testing.assert_array_equal(M, M.T)
    # Rows of the matrix are covisibility rows when no keyframe binds a
    # point twice (a duplicate counts once per pair in the matrix).
    for k in range(kpi.shape[0] if not duplicates else 0):
        row = native_core.covis_row(kpi, kv, P, k)
        np.testing.assert_array_equal(np.delete(M[k], k), np.delete(row, k))
