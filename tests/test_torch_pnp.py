"""The port's EPnP and EPnP RANSAC (geometry/pnp.py) on the CPU against
the JAX package's, on the cases of tests/test_pnp.py.

Inputs are cast to float32 (the port's precision) and the JAX side runs in
32-bit mode. The RANSAC cases draw the JAX package's own sample sets (the
per-round `jax.random.choice` of `epnp_ransac`, replayed from the same
key) and hand the same index sets to the port.

EPnP in float32 is ill-conditioned: M^T M's four smallest eigenvalues sit
at the float32 rounding of its largest (~1e6 px^2), so the two eigensolvers
each return the null space to within that noise, and a minimal sample of
4 points has nothing to average it out. Held:
- epnp_solve: both within tests/test_pnp.py's bounds of the true pose, and
  within 0.1 deg and 5e-3 of each other;
- epnp_ransac, one problem and three candidates in one batch
  (epnp_ransac_many against JAX's vmapped twin, keys split as the tracker
  splits them): ok equal; the inlier masks equal but for at most 3 rows
  a problem (points whose reprojection error sits at the chi2 threshold,
  which the two winning poses straddle), and the counts as far apart;
  where it succeeds the winning minimal-sample pose within 0.5 deg and
  0.05 of JAX's.
The port's own host sampler (geometry/ransac.py) is held by outcome with
tests/test_pnp.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.geometry import pnp as jpnp
from orb_slam2_commit_tpu_torch.geometry import pnp
from orb_slam2_commit_tpu_torch.geometry.ransac import RansacSampler
from orb_slam2_commit_tpu_torch.ops import lie

torch.set_num_threads(1)

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
SOLVE_ROT_DEG, SOLVE_T = 0.1, 5e-3       # port vs JAX, epnp_solve
RANSAC_ROT_DEG, RANSAC_T = 0.5, 0.05     # port vs JAX, the winning 4-point solve
MASK_SLACK = 3        # inlier rows that may flip per problem (chi2 threshold)
N_ITERS = 128


def make_scene(rng, n=80, noise=0.0, outlier_frac=0.0):
    """tests/test_pnp.py's scene: points, pixels, the true pose, outliers."""
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1)
    w = rng.normal(0, 0.3, 3)
    R = lie.so3_exp(torch.from_numpy(w)).numpy()
    t = rng.normal(0, 0.5, 3) + np.array([0, 0, 0.5])
    pc = X @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    uv += rng.normal(0, noise, uv.shape)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False) if n_out else np.array([], int)
    uv[out_idx] += rng.uniform(30, 120, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return X, uv, R, t, out_idx


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def rot_deg(Ra, Rb):
    """The angle between two rotations, from their chordal distance."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


@pytest.fixture(autouse=True)
def _x32():
    with jax.enable_x64(False):
        yield


# (seed, n, noise, rotation bound, translation bound) of tests/test_pnp.py.
SOLVE_CASES = [(0, 8, 0.0, 0.5, 0.05), (1, 50, 0.0, 0.2, 0.02), (2, 60, 0.5, 1.0, 0.1)]


@pytest.mark.parametrize("seed, n, noise, rot_bound, t_bound", SOLVE_CASES)
def test_epnp_solve_matches_jax(seed, n, noise, rot_bound, t_bound):
    X, uv, R, t, _ = make_scene(np.random.default_rng(seed), n=n, noise=noise)
    X, uv = _f32(X), _f32(uv)
    Rj, tj = (np.asarray(a) for a in jpnp.epnp_solve(jnp.asarray(X), jnp.asarray(uv),
                                                     FX, FY, CX, CY))
    Rp, tp = (a.numpy() for a in pnp.epnp_solve(_t(X), _t(uv), FX, FY, CX, CY))
    for Re, te in ((Rp, tp), (Rj, tj)):
        assert rot_deg(Re, R) < rot_bound
        np.testing.assert_allclose(te, t, atol=t_bound)
    assert rot_deg(Rp, Rj) < SOLVE_ROT_DEG
    np.testing.assert_allclose(tp, tj, rtol=0, atol=SOLVE_T)


def _ransac_problems():
    """tests/test_pnp.py's three RANSAC problems, padded to 100 rows:
    (X, uv, valid, min_inliers, true R or None, outlier rows)."""
    out = []
    X, uv, R, _, out_idx = make_scene(np.random.default_rng(3), n=100, noise=0.3,
                                      outlier_frac=0.3)
    out.append((X, uv, np.ones(100, bool), 10, R, out_idx))
    rng = np.random.default_rng(4)
    X = rng.uniform(-3, 3, (50, 3)) + [0, 0, 6]
    uv = rng.uniform(0, 640, (50, 2))
    out.append((X, uv, np.ones(50, bool), 15, None, np.array([], int)))
    rng = np.random.default_rng(5)
    X, uv, R, _, _ = make_scene(rng, n=60, noise=0.2)
    X[40:] = rng.uniform(-5, 5, (20, 3))
    valid = np.zeros(60, bool)
    valid[:40] = True
    out.append((X, uv, valid, 10, R, np.arange(40, 60)))
    return out


def _ransac_one(samples, X, uv, valid, sigma2, min_inliers):
    """epnp_ransac_many on one problem -> its result without the batch
    axis (the JAX package's epnp_ransac)."""
    res = pnp.epnp_ransac_many(samples[None], X[None], uv, valid[None], sigma2,
                               FX, FY, CX, CY, min_inliers=min_inliers)
    return pnp.PnPResult(*(r[0] for r in res))


def _jax_samples(key, valid, n_iters=N_ITERS):
    """The index sets epnp_ransac draws inside, replayed from its key."""
    n = valid.shape[0]
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(4,), replace=False, p=p))(
        jax.random.split(key, n_iters)))


def _hold_masks(got, want):
    """Inlier masks [..., n] equal but for MASK_SLACK rows a problem."""
    flips = (got.numpy() != np.asarray(want)).reshape(-1, got.shape[-1]).sum(-1)
    assert (flips <= MASK_SLACK).all(), flips


def _hold(res, jres, R_true, out_idx):
    assert bool(res.ok) == bool(jres.ok)
    assert abs(int(res.n_inliers) - int(jres.n_inliers)) <= MASK_SLACK
    _hold_masks(res.inliers, jres.inliers)
    if bool(jres.ok):
        assert rot_deg(res.R.numpy(), jres.R) < RANSAC_ROT_DEG
        np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), rtol=0, atol=RANSAC_T)
        assert not res.inliers.numpy()[out_idx].any()
        assert rot_deg(res.R.numpy(), R_true) < 1.5


@pytest.mark.parametrize("which", [0, 1, 2])
def test_epnp_ransac_matches_jax(which):
    X, uv, valid, min_in, R_true, out_idx = _ransac_problems()[which]
    X, uv = _f32(X), _f32(uv)
    n = X.shape[0]
    key = jax.random.key(which)
    jres = jpnp.epnp_ransac_jit(key, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                                jnp.ones(n, jnp.float32), FX, FY, CX, CY, min_inliers=min_in)
    res = _ransac_one(_t(_jax_samples(key, valid)), _t(X), _t(uv), _t(valid), torch.ones(n),
                      min_in)
    _hold(res, jres, R_true, out_idx)


def test_epnp_ransac_many_matches_jax():
    """Four candidates in one batch against one frame's pixels, keys split
    as the tracker splits them: problem 0's points with every row valid,
    with only its first 40 rows valid, garbage points, and a padded
    candidate with no valid row."""
    X0, uv, _, _, _, _ = _ransac_problems()[0]
    n = X0.shape[0]
    X = np.stack([X0, X0, np.random.default_rng(8).uniform(-3, 3, (n, 3)) + [0, 0, 6],
                  np.tile(X0[:1], (n, 1))]).astype(np.float32)
    valid = np.ones((4, n), bool)
    valid[1, 40:] = False
    valid[3] = False
    uv = _f32(uv)
    keys = jax.random.split(jax.random.key(9), 4)
    sigma2 = np.linspace(1.0, 2.0, n).astype(np.float32)
    jres = jpnp.epnp_ransac_many_jit(keys, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                                     jnp.asarray(sigma2), FX, FY, CX, CY)
    samples = np.stack([_jax_samples(keys[c], valid[c]) for c in range(4)])
    res = pnp.epnp_ransac_many(_t(samples), _t(X), _t(uv), _t(valid), _t(sigma2),
                               FX, FY, CX, CY)
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))
    np.testing.assert_array_equal(res.ok.numpy(), [True, True, False, False])
    assert (np.abs(res.n_inliers.numpy() - np.asarray(jres.n_inliers)) <= MASK_SLACK).all()
    _hold_masks(res.inliers, jres.inliers)
    for c in (0, 1):
        assert rot_deg(res.R[c].numpy(), np.asarray(jres.R[c])) < RANSAC_ROT_DEG
        np.testing.assert_allclose(res.t[c].numpy(), np.asarray(jres.t[c]), atol=RANSAC_T)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_own_sampler_outcome(which):
    """The port's own seeded sampler, with tests/test_pnp.py's bounds."""
    X, uv, valid, min_in, R_true, out_idx = _ransac_problems()[which]
    n = X.shape[0]
    samples = RansacSampler(seed=5).pnp(valid[None])[0]
    res = _ransac_one(_t(samples), _t(_f32(X)), _t(_f32(uv)), _t(valid), torch.ones(n), min_in)
    if R_true is None:
        assert not bool(res.ok)
        return
    assert bool(res.ok)
    assert rot_deg(res.R.numpy(), R_true) < (1.5 if which == 0 else 1.0)
    assert not res.inliers.numpy()[out_idx].any()
    assert int(res.n_inliers) >= (60 if which == 0 else 30)


def test_degenerate_problem_gives_no_pose():
    """A sample of one repeated point: JAX's solve gives NaNs, the port a
    NaN pose (its eigensolver would raise on the non-finite matrices), and
    so no inliers and no success on either side."""
    X = np.tile(np.array([[0.5, -0.2, 5.0]], np.float32), (10, 1))
    uv = np.tile(np.array([[350.0, 220.0]], np.float32), (10, 1))
    valid = np.ones(10, bool)
    samples = np.zeros((1, 8, 4), np.int64)
    res = pnp.epnp_ransac_many(_t(samples), _t(X[None]), _t(uv), _t(valid[None]),
                               torch.ones(10), FX, FY, CX, CY)
    assert not bool(res.ok[0]) and int(res.n_inliers[0]) == 0
    jres = jpnp.epnp_ransac_many_jit(jax.random.split(jax.random.key(0), 1),
                                     jnp.asarray(X[None]), jnp.asarray(uv),
                                     jnp.asarray(valid[None]), jnp.ones(10, jnp.float32),
                                     FX, FY, CX, CY)
    assert not bool(jres.ok[0])
