"""K8's route (optim/pose_opt.pose_optimization, whose CPU branch is the
plain masked LM) on the CPU against the JAX package's one-kernel LM
(pose_optimization_pallas, in interpret mode) and its XLA route, on the
clean, outlier and stereo problems of tests/test_pallas_pose_opt.py, with
masked rows, and with no valid observation: rotation < 0.05 deg,
|dt| < 2e-3, equal inlier counts; the same past 1024 rows against the XLA
route. Also the build flags: K8 alone is compiled with FMA contraction."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import lie as jlie
from orb_slam2_commit_tpu.optim import pose_opt as jpose_opt
from orb_slam2_commit_tpu.optim.pallas_pose_opt import pose_optimization_pallas
from orb_slam2_commit_tpu.optim.residuals import BAObservations as JObs
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.optim import linalg, pose_opt
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU every wrapper runs its plain version: nothing launches."""
    before = dict(_build.launches)
    yield
    assert _build.launches == before


FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def _problem(seed, n=160, n_outliers=0, stereo=False, n_valid=None):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], -1)
    R_true = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.1, 3))))
    t_true = rng.normal(0, 0.3, 3)
    pc = X @ R_true.T + t_true
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    bf = 40.0 if stereo else 0.0
    ur = uv[:, 0] - bf / pc[:, 2] if stereo else np.zeros(n)
    uvr = np.concatenate([uv, ur[:, None]], -1)
    out_idx = np.array([], int)
    if n_outliers:
        out_idx = rng.choice(n, n_outliers, replace=False)
        uvr[out_idx, :2] += rng.uniform(15, 60, (n_outliers, 2)) * rng.choice(
            [-1, 1], (n_outliers, 2))
    valid = np.ones(n, bool)
    if n_valid is not None:
        valid[n_valid:] = False
        uvr[n_valid:] = 1e6                   # masked rows must not count
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
    R0 = (dR @ R_true).astype(np.float32)
    t0 = (t_true + np.array([0.05, -0.04, 0.08])).astype(np.float32)
    return (X.astype(np.float32), uvr.astype(np.float32), valid, np.full(n, stereo),
            R0, t0, bf, R_true, t_true, out_idx)


CASES = {
    "clean": dict(seed=0),
    "outliers": dict(seed=3, n_outliers=25),
    "stereo": dict(seed=7, stereo=True),
    "masked": dict(seed=11, n_valid=100),
    "no_observation": dict(seed=13, n_valid=0),
}


def _jax_routes(X, uvr, valid, stereo, R0, t0, bf):
    n = X.shape[0]
    obs = JObs(jnp.zeros(n, jnp.int32), jnp.arange(n, dtype=jnp.int32),
               jnp.asarray(uvr), jnp.ones(n, jnp.float32),
               jnp.asarray(stereo), jnp.asarray(valid))
    args = (jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X), obs, FX, FY, CX, CY, bf)
    return (pose_optimization_pallas(*args), jpose_opt.pose_optimization_jit(*args))


def _port(X, uvr, valid, stereo, R0, t0, bf):
    n = X.shape[0]
    obs = BAObservations(torch.zeros(n, dtype=torch.int32),
                         torch.arange(n, dtype=torch.int32), torch.from_numpy(uvr),
                         torch.ones(n), torch.from_numpy(stereo), torch.from_numpy(valid))
    return pose_opt.pose_optimization(torch.from_numpy(R0), torch.from_numpy(t0),
                                      torch.from_numpy(X), obs, FX, FY, CX, CY, bf)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pose_lm_route_matches_jax_kernel_and_xla(case):
    X, uvr, valid, stereo, R0, t0, bf, R_true, t_true, out_idx = _problem(**CASES[case])
    r = _port(X, uvr, valid, stereo, R0, t0, bf)
    R, t, inl = r.R.numpy(), r.t.numpy(), r.inliers.numpy()
    assert r.R.dtype == torch.float32 and int(r.n_inliers) == int(inl.sum())
    for ref in _jax_routes(X, uvr, valid, stereo, R0, t0, bf):
        assert rot_angle(R, ref.R) < 0.05
        assert np.linalg.norm(t - np.asarray(ref.t)) < 2e-3
        assert int(r.n_inliers) == int(ref.n_inliers)
    assert not inl[~valid].any() and not inl[out_idx].any()
    if case == "no_observation":
        # Every step is rejected: the pose stays exactly where it started.
        np.testing.assert_array_equal(R, R0)
        np.testing.assert_array_equal(t, t0)
        assert int(r.n_inliers) == 0
    else:
        assert rot_angle(R, R_true) < (0.1 if len(out_idx) else 0.05)


def test_plain_lm_past_1024_rows_matches_xla():
    """The outlier problem's rows tiled to 1120 (more rows than the kernel
    has threads): the plain LM still agrees with the JAX XLA route."""
    X, uvr, valid, stereo, R0, t0, bf, R_true, _, out_idx = _problem(**CASES["outliers"])
    reps = 7
    X, uvr, valid, stereo = (np.concatenate([a] * reps) for a in (X, uvr, valid, stereo))
    assert X.shape[0] > 1024
    r = _port(X, uvr, valid, stereo, R0, t0, bf)
    n = X.shape[0]
    obs = JObs(jnp.zeros(n, jnp.int32), jnp.arange(n, dtype=jnp.int32), jnp.asarray(uvr),
               jnp.ones(n, jnp.float32), jnp.asarray(stereo), jnp.asarray(valid))
    ref = jpose_opt.pose_optimization_jit(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                                          obs, FX, FY, CX, CY, bf)
    assert rot_angle(r.R.numpy(), ref.R) < 0.05
    assert np.linalg.norm(r.t.numpy() - np.asarray(ref.t)) < 2e-3
    assert int(r.n_inliers) == int(ref.n_inliers) == reps * (160 - len(out_idx))
    assert rot_angle(r.R.numpy(), R_true) < 0.1


def test_build_flags_per_source(monkeypatch):
    """Every source but pose_lm.cu is built without FMA contraction (the
    kernels that must round like their plain versions), and each library's
    file name hashes its own flags."""
    assert "-fmad=false" not in _build.nvcc_flags("pose_lm")
    for name in _build.SOURCES:
        if name != "pose_lm":
            assert "-fmad=false" in _build.nvcc_flags(name)
    paths = {name: _build._library_path(name) for name in _build.SOURCES}
    for name in ("level", "pose_lm"):
        monkeypatch.setitem(_build.SOURCE_FLAGS, name, (*_build.SOURCE_FLAGS[name], "-lineinfo"))
        changed = {n for n in _build.SOURCES if _build._library_path(n) != paths[n]}
        assert changed == {name}
        monkeypatch.undo()


def test_failed_factor_is_rejected(monkeypatch):
    """A step whose Cholesky factor fails (NaN) projects every point to NaN,
    which passes no depth gate and so costs nothing; it must still be
    rejected, as the kernel rejects it, and the pose stay finite."""
    X, uvr, valid, stereo, R0, t0, bf, *_ = _problem(0)
    monkeypatch.setattr(linalg, "chol_solve_spd",
                        lambda H, b: torch.full_like(b, float("nan")))
    r = _port(X, uvr, valid, stereo, R0, t0, bf)
    np.testing.assert_array_equal(r.R.numpy(), R0)
    np.testing.assert_array_equal(r.t.numpy(), t0)
