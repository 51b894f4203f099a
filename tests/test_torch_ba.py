"""The port's bundle adjustment on the CPU against the JAX package's, on
the same BAProblem: the synthetic problems of tests/test_optim.py (6-8
cameras, 120-200 points, two fixed cameras; exact, noisy, and with 5% of
observations corrupted), in float32 on both sides (the JAX package in
32-bit mode; x64 is on elsewhere in the suite).

Held: fixed cameras bit for bit unchanged; poses within 1e-3 deg and 1e-4
of the JAX result, points within 1e-3 (float32 sums in other orders move
the LM path in the last bits); the final cost within 1% (+1e-4); inlier
flags equal. Cases: bundle_adjust with Huber on and off, with stereo
rows, padded as build_ba_problem pads (extra fixed cameras, invalid
points and observations), with the dense and the implicit-Schur PCG
solvers (PCG steps are inexact, so it is held within 5e-3 deg / 2e-3 /
5e-3 of JAX and its translations within 5e-4 of the port's dense solve),
and local_bundle_adjust's two stages with outlier flags. With no valid
observation every step is rejected until the damping passes 1e8 and the
LM aborts: both packages return the problem bit for bit unchanged. (The
mapper's abort flag, which skips local BA, is held in
tests/test_torch_system.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import lie as jlie
from orb_slam2_commit_tpu.optim import ba as jba
from orb_slam2_commit_tpu.optim.residuals import BAObservations as JObs
from orb_slam2_commit_tpu_torch.optim import ba
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations

torch.set_num_threads(1)

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
ROT_DEG_TOL, T_TOL, PT_TOL, COST_RTOL = 1e-3, 1e-4, 1e-3, 0.01


def rot_angle(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2)))))


def make_problem(seed=0, n_cams=6, n_pts=200, noise=0.0, pose_perturb=0.02,
                 point_perturb=0.05, n_fixed=2, outliers=0.0, stereo_bf=0.0,
                 pad=(0, 0, 0)):
    """tests/test_optim.py's make_ba_problem in numpy (float32 out), with
    optional stereo rows (every third observation, bf = stereo_bf), a
    share of corrupted observations, and padding (extra fixed cameras,
    invalid points, invalid observations) as build_ba_problem pads."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                  rng.uniform(5, 12, n_pts)], -1)
    R_true = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3))))
                       for _ in range(n_cams)])
    t_true = np.stack([np.array([0.3 * k, 0.02 * k, 0.0]) + rng.normal(0, 0.02, 3)
                       for k in range(n_cams)])
    cam_idx, pt_idx, uvr = [], [], []
    for k in range(n_cams):
        pc = X @ R_true[k].T + t_true[k]
        uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
        if noise:
            uv = uv + rng.normal(0, noise, uv.shape)
        for p in range(n_pts):
            if 0 <= uv[p, 0] < 640 and 0 <= uv[p, 1] < 480:
                cam_idx.append(k)
                pt_idx.append(p)
                uvr.append([uv[p, 0], uv[p, 1], uv[p, 0] - stereo_bf / pc[p, 2]])
    O = len(cam_idx)
    uvr = np.asarray(uvr)
    is_stereo = np.zeros(O, bool)
    if stereo_bf:
        is_stereo[::3] = True
    uvr[~is_stereo, 2] = 0.0
    bad = np.zeros(O, bool)
    if outliers:
        idx = rng.choice(O, int(outliers * O), replace=False)
        uvr[idx, :2] += rng.uniform(20, 80, (idx.size, 2)) * rng.choice([-1, 1], (idx.size, 2))
        bad[idx] = True
    R0, t0 = R_true.copy(), t_true.copy()
    for k in range(n_fixed, n_cams):
        R0[k] = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, pose_perturb, 3)))) @ R_true[k]
        t0[k] = t_true[k] + rng.normal(0, pose_perturb * 2, 3)
    X0 = X + rng.normal(0, point_perturb, X.shape)
    fixed = np.arange(n_cams) < n_fixed
    pk, pp, po = pad
    arrays = dict(
        R=np.concatenate([R0, np.tile(np.eye(3), (pk, 1, 1))]),
        t=np.concatenate([t0, np.zeros((pk, 3))]),
        fixed=np.concatenate([fixed, np.ones(pk, bool)]),
        points=np.concatenate([X0, np.zeros((pp, 3))]),
        point_valid=np.concatenate([np.ones(n_pts, bool), np.zeros(pp, bool)]),
        cam_idx=np.concatenate([cam_idx, np.zeros(po, int)]).astype(np.int32),
        pt_idx=np.concatenate([pt_idx, np.zeros(po, int)]).astype(np.int32),
        uvr=np.concatenate([uvr, np.zeros((po, 3))]),
        inv_sigma2=np.ones(O + po),
        is_stereo=np.concatenate([is_stereo, np.zeros(po, bool)]),
        valid=np.concatenate([np.ones(O, bool), np.zeros(po, bool)]),
    )
    arrays = {k: v.astype(np.float32) if v.dtype == np.float64 else v
              for k, v in arrays.items()}
    return arrays, (R_true, t_true, X), bad


def _problem(mod, obs_cls, a, conv):
    return mod.BAProblem(
        R=conv(a["R"]), t=conv(a["t"]), fixed=conv(a["fixed"]), points=conv(a["points"]),
        point_valid=conv(a["point_valid"]),
        obs=obs_cls(*(conv(a[k]) for k in ("cam_idx", "pt_idx", "uvr", "inv_sigma2",
                                           "is_stereo", "valid"))))


def run_both(a, bf=0.0, local=False, **kw):
    with jax.enable_x64(False):
        jp = _problem(jba, JObs, a, jnp.asarray)
        if local:
            jout, jres = jba.local_bundle_adjust(jp, FX, FY, CX, CY, bf, **kw)
        else:
            jout, jres = jba.bundle_adjust_jit(jp, FX, FY, CX, CY, bf, **kw)
        want = {k: np.asarray(v) for k, v in (("R", jout.R), ("t", jout.t),
                                              ("points", jout.points),
                                              ("inlier", jres.inlier), ("cost", jres.cost))}
    pp = _problem(ba, BAObservations, a, torch.from_numpy)
    fn = ba.local_bundle_adjust if local else ba.bundle_adjust
    out, res = fn(pp, FX, FY, CX, CY, bf, **kw)
    got = {k: v.numpy() for k, v in (("R", out.R), ("t", out.t), ("points", out.points),
                                     ("inlier", res.inlier), ("cost", res.cost))}
    for k in ("R", "t", "points"):
        assert got[k].dtype == np.float32, k
    return got, want


def assert_close(got, want, a, rot_tol=ROT_DEG_TOL, t_tol=T_TOL, pt_tol=PT_TOL):
    fixed = a["fixed"]
    np.testing.assert_array_equal(got["R"][fixed], a["R"][fixed])
    np.testing.assert_array_equal(got["t"][fixed], a["t"][fixed])
    for k in range(a["R"].shape[0]):
        assert rot_angle(got["R"][k], want["R"][k]) < rot_tol, k
    np.testing.assert_allclose(got["t"], want["t"], atol=t_tol, rtol=0)
    valid = a["point_valid"]
    np.testing.assert_allclose(got["points"][valid], want["points"][valid], atol=pt_tol, rtol=0)
    np.testing.assert_array_equal(got["inlier"], want["inlier"])
    assert abs(float(got["cost"]) - float(want["cost"])) <= COST_RTOL * float(want["cost"]) + 1e-4


CASES = {
    "exact": (dict(seed=0), dict(n_iters=12, point_chunk=64)),
    "noisy": (dict(seed=2, noise=0.3), dict(n_iters=12, point_chunk=128)),
    "noisy_no_huber": (dict(seed=2, noise=0.3),
                       dict(n_iters=12, point_chunk=128, use_robust=False)),
    "outliers_huber": (dict(seed=3, noise=0.2, outliers=0.05), dict(n_iters=8)),
    "stereo": (dict(seed=4, noise=0.2, stereo_bf=40.0), dict(n_iters=10)),
    "padded": (dict(seed=5, noise=0.2, pad=(2, 56, 300)), dict(n_iters=10, point_chunk=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bundle_adjust_matches_jax(case):
    make_kw, kw = CASES[case]
    a, (R_true, t_true, X), _ = make_problem(**make_kw)
    got, want = run_both(a, bf=make_kw.get("stereo_bf", 0.0), solver="dense", **kw)
    assert_close(got, want, a)
    if case == "exact":
        for k in range(2, 6):
            assert rot_angle(got["R"][k], R_true[k]) < 0.02
            np.testing.assert_allclose(got["t"][k], t_true[k], atol=2e-3)


def test_pcg_matches_jax_and_dense():
    a, (R_true, t_true, _), _ = make_problem(seed=22, n_cams=8, n_pts=200)
    kw = dict(n_iters=12, point_chunk=64)
    got, want = run_both(a, solver="pcg", **kw)
    assert_close(got, want, a, rot_tol=5e-3, t_tol=2e-3, pt_tol=5e-3)
    dense, _ = run_both(a, solver="dense", **kw)
    np.testing.assert_allclose(got["t"], dense["t"], atol=5e-4)
    for k in range(2, 8):
        assert rot_angle(got["R"][k], R_true[k]) < 0.02
        np.testing.assert_allclose(got["t"][k], t_true[k], atol=2e-3)


def test_local_bundle_adjust_flags_outliers_as_jax():
    a, (R_true, _, _), bad = make_problem(seed=3, noise=0.2, outliers=0.05)
    got, want = run_both(a, local=True, point_chunk=128)
    assert_close(got, want, a)
    assert not got["inlier"][bad].any()
    assert got["inlier"].sum() > 0.85 * bad.size
    for k in range(2, 6):
        assert rot_angle(got["R"][k], R_true[k]) < 0.05


def test_stalled_lm_aborts_as_jax():
    a, _, _ = make_problem(seed=6, noise=0.2)
    a = dict(a, valid=np.zeros_like(a["valid"]))
    got, want = run_both(a, solver="dense", n_iters=40, point_chunk=64)
    for k in ("R", "t", "points"):
        np.testing.assert_array_equal(got[k], a[k], err_msg=k)
        np.testing.assert_array_equal(want[k], a[k], err_msg=k)
    assert not got["inlier"].any() and not want["inlier"].any()
    assert float(got["cost"]) == float(want["cost"]) == 0.0


def test_failed_solve_is_rejected(monkeypatch):
    """A singular Schur system in float32 gives a non-finite step, whose
    projections fail every depth gate (cost 0): the step is rejected and
    the LM goes on from the problem as it was (the mapper's local BA on a
    monocular ring survey once took such a step and wrote NaN poses)."""
    a, _, _ = make_problem(seed=6, noise=0.2)
    problem = _problem(ba, BAObservations, a, torch.from_numpy)
    solve = ba._solve_step
    calls = []

    def failing_first(*args, **kwargs):
        delta_c, delta_p = solve(*args, **kwargs)
        calls.append(1)
        if len(calls) == 1:
            return torch.full_like(delta_c, torch.nan), torch.full_like(delta_p, torch.nan)
        return delta_c, delta_p

    monkeypatch.setattr(ba, "_solve_step", failing_first)
    out, res = ba.bundle_adjust(problem, FX, FY, CX, CY, 0.0, n_iters=1, solver="dense")
    for k in ("R", "t", "points"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), a[k], err_msg=k)
    assert float(res.cost) > 0
    out, _ = ba.bundle_adjust(problem, FX, FY, CX, CY, 0.0, n_iters=6, solver="dense")
    assert torch.isfinite(out.R).all() and not torch.equal(out.R, problem.R)


def test_singular_preconditioner_block_is_rejected(monkeypatch):
    """A singular block of the PCG's block-Jacobi preconditioner (camera
    3's damped Hcc block zeroed) no longer raises (torch.linalg.inv did):
    inv_ex marks it NaN, the step comes out NaN and is rejected, as the
    JAX package's non-finite inverse is, and the problem is unchanged."""
    a, _, _ = make_problem(seed=22, n_cams=8)
    problem = _problem(ba, BAObservations, a, torch.from_numpy)
    pcg, calls = ba._schur_pcg, []

    def singular(Hcc_d, *args, **kwargs):
        calls.append(1)
        Hcc_d = Hcc_d.clone()
        Hcc_d[3] = 0.0
        return pcg(Hcc_d, *args, **kwargs)

    monkeypatch.setattr(ba, "_schur_pcg", singular)
    out, res = ba.bundle_adjust(problem, FX, FY, CX, CY, 0.0, n_iters=1, solver="pcg")
    assert calls == [1]
    for k in ("R", "t", "points"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), a[k], err_msg=k)
    assert float(res.cost) > 0
