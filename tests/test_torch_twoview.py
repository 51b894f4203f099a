"""The port's two-view initialization (geometry/twoview.py) on the CPU
against the JAX package's, on the cases of tests/test_twoview.py.

Each case draws its correspondences as tests/test_twoview.py does, casts
them to float32 (the port's precision; the JAX side runs in 32-bit mode),
draws the JAX package's own sample sets (`twoview._ransac_samples` with
the case's key, the draws `find_models` makes inside) and hands the same
index sets to the port. Held, with float32 eigensolves and SVDs summed in
different orders on the two sides:
- find_models: H21 (normalized to H[2, 2] = 1) within 1e-4 relative to
  its largest entry; F21 up to scale and sign within 1e-4 on a general
  scene (a planar scene or a pure rotation leaves F undetermined, so
  there only its score is held, within 1e-3 relative); the other scores
  within 1e-4 relative; both inlier masks equal;
- initialize_two_view: ok, the model choice and the `good` mask equal;
  where it succeeds R21 within 1e-3 deg, t21 within 1e-4 and the points
  within 1e-3 relative where `good` holds;
- the pieces on their own: normalize_points, compute_h21 / compute_f21 on
  one minimal sample (unit norm, up to sign, within 1e-3: eight points
  leave the null vector less well conditioned), decompose_e and Faugeras' hypotheses as sets
  (a singular vector's sign only reorders them), check_rt's counts.
The port's own host sampler (geometry/ransac.py) is held by outcome on
the same scenes, with tests/test_twoview.py's bounds: the right model
wins, the pose is recovered, pure rotation is rejected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.geometry import twoview as jtwoview
from orb_slam2_commit_tpu_torch.geometry import twoview
from orb_slam2_commit_tpu_torch.geometry.ransac import RansacSampler, weighted_samples

torch.set_num_threads(1)

H_RTOL = 1e-4          # of H's largest entry
F_TOL = 1e-4           # unit-norm F, sign fixed
SCORE_RTOL = 1e-4
F_SCORE_RTOL_DEGENERATE = 1e-3   # F's score where the scene leaves F undetermined
ROT_DEG_TOL, T_TOL = 1e-3, 1e-4
PTS_RTOL = 1e-3
SAMPLE_TOL = 1e-3      # unit-norm H, F of one minimal sample of 8

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]])


def make_pair(rng, n=200, planar=False, noise=0.3, outlier_frac=0.1,
              baseline=0.5, yaw=0.05):
    """tests/test_twoview.py's correspondence pair with known (R21, t21)."""
    x = rng.uniform(-3, 3, n)
    y = rng.uniform(-2, 2, n)
    z = np.full(n, 6.0) + 0.3 * x if planar else rng.uniform(4, 10, n)
    pts = np.stack([x, y, z], -1)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R21 = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    t21 = np.array([-baseline, 0.02, 0.01])

    def proj(P, R, t):
        pc = P @ R.T + t
        return (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    uv1 = proj(pts, np.eye(3), np.zeros(3)) + rng.normal(0, noise, (n, 2))
    uv2 = proj(pts, R21, t21) + rng.normal(0, noise, (n, 2))
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), np.ones(n, bool), R21, t21, pts


# (name, make_pair seed and arguments, JAX key), as in tests/test_twoview.py.
CASES = [
    ("general", 1, {}, 0),
    ("planar", 2, dict(planar=True), 0),
    ("low_noise", 3, dict(noise=0.1), 1),
    ("general_recovery", 4, dict(noise=0.2), 2),
    ("planar_recovery", 5, dict(planar=True, noise=0.2, outlier_frac=0.05), 3),
    ("pure_rotation", 6, dict(baseline=0.0, yaw=0.08, noise=0.2, outlier_frac=0.0), 4),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def rot_deg(Ra, Rb):
    """The angle between two rotations, from their chordal distance (exact
    to float32 rounding for small angles, where arccos of the trace is
    not)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


def _unit(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, seed, kwargs, key = request.param
    uv1, uv2, valid, R21, t21, pts = make_pair(np.random.default_rng(seed), **kwargs)
    with jax.enable_x64(False):
        k = jax.random.key(key)
        args = (jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid))
        samples = np.asarray(jtwoview._ransac_samples(k, args[2], jtwoview.N_RANSAC))
        jm = jtwoview.find_models(k, *args)
        jr = jtwoview.initialize_two_view(k, *args, jnp.asarray(K, jnp.float32))
        jm = jax.tree_util.tree_map(np.asarray, jm)
        jr = jax.tree_util.tree_map(np.asarray, jr)
    return dict(name=name, uv1=uv1, uv2=uv2, valid=valid, samples=samples, jm=jm, jr=jr,
                R21=R21, t21=t21, pts=pts)


def test_find_models_matches_jax(case):
    jm = case["jm"]
    pm = twoview.find_models(_t(case["samples"]), _t(case["uv1"]), _t(case["uv2"]),
                             _t(case["valid"]))
    H = pm.H21.numpy()
    np.testing.assert_allclose(H, jm.H21, rtol=0, atol=H_RTOL * np.abs(jm.H21).max())
    f_determined = not case["name"].startswith(("planar", "pure_rotation"))
    if f_determined:
        np.testing.assert_allclose(_unit(pm.F21.numpy()), _unit(jm.F21), rtol=0, atol=F_TOL)
    np.testing.assert_allclose(float(pm.score_h), float(jm.score_h), rtol=SCORE_RTOL)
    np.testing.assert_allclose(float(pm.score_f), float(jm.score_f),
                               rtol=SCORE_RTOL if f_determined else F_SCORE_RTOL_DEGENERATE)
    np.testing.assert_array_equal(pm.inliers_h.numpy(), jm.inliers_h)
    np.testing.assert_array_equal(pm.inliers_f.numpy(), jm.inliers_f)


def test_initialize_two_view_matches_jax(case):
    jr = case["jr"]
    pr = twoview.initialize_two_view(_t(case["samples"]), _t(case["uv1"]), _t(case["uv2"]),
                                     _t(case["valid"]), _t(K.astype(np.float32)))
    assert bool(pr.ok) == bool(jr.ok)
    assert bool(pr.used_homography) == bool(jr.used_homography)
    good = pr.good.numpy()
    np.testing.assert_array_equal(good, jr.good)
    if bool(jr.ok):
        assert rot_deg(pr.R21.numpy(), jr.R21) < ROT_DEG_TOL
        np.testing.assert_allclose(pr.t21.numpy(), jr.t21, rtol=0, atol=T_TOL)
        p, j = pr.points.numpy()[good], jr.points[good]
        assert good.any()
        np.testing.assert_allclose(p, j, rtol=PTS_RTOL, atol=PTS_RTOL * np.abs(j).max())


def test_pieces_match_jax():
    """normalize_points, one sample's H and F (up to sign), the E
    decomposition and the Faugeras hypotheses (as sets), check_rt."""
    uv1, uv2, valid, R21, t21, _ = make_pair(np.random.default_rng(4), noise=0.2)
    valid[::7] = False
    with jax.enable_x64(False):
        jx1, jT1 = jtwoview.normalize_points(jnp.asarray(uv1), jnp.asarray(valid))
        jx2, _ = jtwoview.normalize_points(jnp.asarray(uv2), jnp.asarray(valid))
        jH = jtwoview.compute_h21(jx1[:8], jx2[:8])
        jF = jtwoview.compute_f21(jx1[:8], jx2[:8])
        E = (K.T @ np.cross(np.eye(3), t21 / np.linalg.norm(t21)) @ R21 @ K).astype(np.float32)
        jR1, jR2, jt = jtwoview.decompose_e(jnp.asarray(E))
        A = (np.linalg.inv(K) @ (K @ (R21 + np.outer(t21, [0, 0, 1.0 / 6.0]))
                                   @ np.linalg.inv(K)) @ K).astype(np.float32)
        jRs, jts, jdeg = jtwoview._faugeras_hypotheses(jnp.asarray(A))
        jn, jpar, _, jgood = jtwoview.check_rt(
            jnp.asarray(R21, jnp.float32), jnp.asarray(t21 / np.linalg.norm(t21), jnp.float32),
            jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(K, jnp.float32))
    x1, T1 = twoview.normalize_points(_t(uv1), _t(valid))
    x2, _ = twoview.normalize_points(_t(uv2), _t(valid))
    np.testing.assert_allclose(x1.numpy(), jx1, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(T1.numpy(), jT1, rtol=1e-6)
    np.testing.assert_allclose(_unit(twoview.compute_h21(x1[:8], x2[:8]).numpy()), _unit(jH),
                               atol=SAMPLE_TOL)
    np.testing.assert_allclose(_unit(twoview.compute_f21(x1[:8], x2[:8]).numpy()), _unit(jF),
                               atol=SAMPLE_TOL)
    R1, R2, t = twoview.decompose_e(_t(E))
    got = {(tuple(np.round(R.numpy().ravel(), 4)), tuple(np.round(s * t.numpy(), 4)))
           for R in (R1, R2) for s in (1, -1)}
    want = {(tuple(np.round(np.asarray(R).ravel(), 4)), tuple(np.round(s * np.asarray(jt), 4)))
            for R in (jR1, jR2) for s in (1, -1)}
    assert got == want
    Rs, ts, deg = twoview._faugeras_hypotheses(_t(A))
    assert bool(deg) == bool(jdeg)
    got = sorted(np.round(np.concatenate([Rs.numpy().reshape(8, 9), ts.numpy()], 1), 3).tolist())
    want = sorted(np.round(np.concatenate([np.asarray(jRs).reshape(8, 9), np.asarray(jts)], 1),
                           3).tolist())
    np.testing.assert_allclose(got, want, atol=2e-3)
    n, par, _, good = twoview.check_rt(
        _t(R21.astype(np.float32))[None], _t((t21 / np.linalg.norm(t21)).astype(np.float32))[None],
        _t(uv1), _t(uv2), _t(valid), _t(K.astype(np.float32)))
    assert int(n[0]) == int(jn)
    np.testing.assert_array_equal(good[0].numpy(), jgood)
    np.testing.assert_allclose(float(par[0]), float(jpar), rtol=1e-4)


def test_sampler_draws_distinct_valid_indices():
    """The host sampler: each set distinct, only valid indices while there
    are enough, every valid index drawn about equally often."""
    valid = np.zeros(50, bool)
    valid[::3] = True
    s = RansacSampler(seed=3).twoview(valid, 2000)
    assert s.shape == (2000, 8)
    assert all(len(set(row)) == 8 for row in s.tolist())
    assert valid[s].all()
    counts = np.bincount(s.ravel(), minlength=50)[valid]
    assert counts.min() > 0.7 * counts.mean()
    few = np.zeros((2, 10), bool)
    few[0, :2] = True
    s = weighted_samples(np.random.default_rng(0), few, 5, 4)
    assert s.shape == (2, 5, 4) and set(s[0, :, :2].ravel()) == {0, 1}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_own_sampler_outcome(name):
    """The port's own seeded sampler on tests/test_twoview.py's scenes, with
    its bounds."""
    _, seed, kwargs, _ = next(c for c in CASES if c[0] == name)
    uv1, uv2, valid, R21, t21, pts = make_pair(np.random.default_rng(seed), **kwargs)
    samples = _t(RansacSampler(seed=11).twoview(valid))
    args = (_t(uv1), _t(uv2), _t(valid))
    models = twoview.find_models(samples, *args)
    rh = float(models.score_h / (models.score_h + models.score_f))
    res = twoview.initialize_two_view(samples, *args, _t(K.astype(np.float32)))
    if name == "general":
        assert rh < 0.5, rh
    elif name == "planar":
        assert rh > 0.45, rh
    elif name == "low_noise":
        assert int(models.inliers_f.sum()) > 150
    elif name == "pure_rotation":
        assert not bool(res.ok)
    else:
        assert bool(res.ok)
        t_true = t21 / np.linalg.norm(t21)
        t_est = res.t21.numpy() / np.linalg.norm(res.t21.numpy())
        if name == "general_recovery":
            assert not bool(res.used_homography)
            assert rot_deg(res.R21.numpy(), R21) < 0.5
            assert abs(np.dot(t_est, t_true)) > 0.999
            good = res.good.numpy()
            assert good.sum() > 140
            err = np.linalg.norm(res.points.numpy()[good] * np.linalg.norm(t21) - pts[good],
                                 axis=1)
            assert np.median(err) < 0.25 and np.percentile(err, 90) < 0.7
        else:
            assert rot_deg(res.R21.numpy(), R21) < 1.0
            assert abs(np.dot(t_est, t_true)) > 0.995
