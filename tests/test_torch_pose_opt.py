"""Port's pose-only LM on the CPU against the JAX package's XLA route, on
the problems of test_pallas_pose_opt.py and with its bounds: rotation
< 0.05 deg, |dt| < 2e-3, equal inlier counts. The JAX route runs in
float64 there (its inputs are float64 under the suite's x64 mode); the
port runs in float32, its working type, and also in float64, where the
fixed-length masked loop must land on the early-exit loop's result to
rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import lie as jlie
from orb_slam2_commit_tpu.optim import pose_opt as jpose_opt
from orb_slam2_commit_tpu.optim.residuals import BAObservations as JObs
from orb_slam2_commit_tpu_torch.ops import lie
from orb_slam2_commit_tpu_torch.optim import linalg, pose_opt
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations

torch.set_num_threads(1)

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def _problem(seed, n=160, n_outliers=0, stereo=False, masked=False):
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
    if masked:
        valid[100:] = False
        uvr[100:] = 1e6
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
    R0 = dR @ R_true
    t0 = t_true + np.array([0.05, -0.04, 0.08])
    return X, R_true, t_true, uvr, valid, np.full(n, stereo), R0, t0, bf, out_idx


def _solve_jax(X, uvr, valid, stereo, R0, t0, bf):
    n = X.shape[0]
    obs = JObs(jnp.zeros(n, jnp.int32), jnp.arange(n, dtype=jnp.int32),
               jnp.asarray(uvr, jnp.float32), jnp.ones(n, jnp.float32),
               jnp.asarray(stereo), jnp.asarray(valid))
    r = jpose_opt.pose_optimization_jit(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X), obs, FX, FY, CX, CY, bf)
    return np.asarray(r.R), np.asarray(r.t), np.asarray(r.inliers)


def _solve_port(X, uvr, valid, stereo, R0, t0, bf, dtype):
    n = X.shape[0]

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    obs = BAObservations(torch.zeros(n, dtype=torch.int32),
                         torch.arange(n, dtype=torch.int32),
                         f(np.asarray(uvr, np.float32)), torch.ones(n, dtype=dtype),
                         torch.from_numpy(stereo), torch.from_numpy(valid))
    r = pose_opt.pose_optimization(f(R0), f(t0), f(X), obs, FX, FY, CX, CY, bf)
    assert int(r.n_inliers) == int(r.inliers.sum())
    return r.R.numpy().astype(np.float64), r.t.numpy().astype(np.float64), r.inliers.numpy()


CASES = {
    "clean": dict(seed=0),
    "outliers": dict(seed=3, n_outliers=25),
    "stereo": dict(seed=7, stereo=True),
    "masked": dict(seed=11, masked=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pose_optimization_matches_jax(case):
    X, R_true, t_true, uvr, valid, stereo, R0, t0, bf, out_idx = _problem(**CASES[case])
    jR, jt, jinl = _solve_jax(X, uvr, valid, stereo, R0, t0, bf)
    R, t, inl = _solve_port(X, uvr, valid, stereo, R0, t0, bf, torch.float32)
    assert rot_angle(R, jR) < 0.05
    assert np.linalg.norm(t - jt) < 2e-3
    assert inl.sum() == jinl.sum()
    assert rot_angle(R, R_true) < (0.1 if len(out_idx) else 0.05)
    assert not inl[out_idx].any()
    assert not inl[~valid].any()

    R64, t64, inl64 = _solve_port(X, uvr, valid, stereo, R0, t0, bf, torch.float64)
    np.testing.assert_allclose(R64, jR, atol=1e-9)
    np.testing.assert_allclose(t64, jt, atol=1e-9)
    np.testing.assert_array_equal(inl64, jinl)


def test_se3_exp_and_chol_solve():
    rng = np.random.default_rng(12)
    xi = rng.normal(0, 0.3, (5, 6))
    xi[0] = 0.0                                   # small-angle branch
    jR, jt = jlie.se3_exp(jnp.asarray(xi))
    R, t = lie.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-12)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-12)
    A = rng.normal(size=(4, 6, 6))
    H = A @ A.transpose(0, 2, 1) + 6 * np.eye(6)
    b = rng.normal(size=(4, 6))
    x = linalg.chol_solve_spd(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(H, b[..., None])[..., 0], atol=1e-10)
