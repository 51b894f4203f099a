"""The plain reference that decides `correct`, in plain PyTorch; it imports
nothing of the program.

The program's answers in a window are poses: each frame's pose from the
tracker (the pose-only optimization, reference Optimizer::PoseOptimization)
and each new keyframe's pose after the local mapper's bundle adjustment
(Optimizer::LocalBundleAdjustment).

What the generator knows, and the program does not, judges the outcome:
every frame is tracked (never LOST, never reset: the configuration's own
guarantee); each step between consecutive keyframes, and the drift over
the window, match the ground-truth trajectory (the KITTI odometry
benchmark's translational error: a wrong stereo depth, a wrong scale or a
pose solved wrongly shows there).

What the program used judges each solve: for every sampled frame and
every keyframe the window made, the measurements the program used (the
keypoints, their stereo or virtual-stereo right coordinate and octave)
and the map points they were matched to, as the program held them when it
answered. The reference minimizes the same cost over them in float64 from
the program's pose; the gap is how far the program's pose lies from that
minimum, in standard deviations of the estimate (the square root of its
excess cost). At that minimum it classifies all the matches the frame's
last pose solve was given by PoseOptimization's chi-square test, and
compares the count with the inliers the program kept (a solve that leaves
part of its matches out shows). These inputs come from the program's own
front end, matcher and map; of what made them, the depth association and
the lens's undistortion are checked directly, where the configuration
states them, and the stereo association and the map's points only
through the trajectory against the ground truth.

The cost is ORB-SLAM2's: a monocular residual (u, v) or a stereo residual
(u, v, u_r), u_r = u - bf / z, each weighted by 1 / 1.2^(2 octave) (the
level's inverse sigma squared), summed without a robust kernel over the
inliers the program kept (the last of PoseOptimization's four rounds and
the second stage of LocalBundleAdjustment run without one).

`solve_pose(..., dtype=torch.bfloat16)` is the control: the same solve in
the nearest precision below the configuration's float32, put in the
program's place (its poses are the ones the trajectory and the inlier
test then judge).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

CAMERA_KEYS = ("fx", "fy", "cx", "cy", "bf")


@dataclasses.dataclass
class Matches:
    """All the matches a pose solve was given: points [n, 3] (world),
    keypoints [n, 2], right coordinates [n], octaves [n], and which of them
    the program kept as inliers [n]."""

    points: np.ndarray
    xy: np.ndarray
    ur: np.ndarray
    octave: np.ndarray
    kept: np.ndarray


@dataclasses.dataclass
class Answer:
    """One pose the program gave, with what it was solved from: R, t
    (Tcw), the observed points [n, 3] (world), their keypoints [n, 2]
    (undistorted px), right coordinates [n] (< 0: monocular) and octaves
    [n]; the frame of the pool it came from; for a tracked frame, all the
    matches its last pose solve was given."""

    kind: str
    index: int
    R: np.ndarray
    t: np.ndarray
    points: np.ndarray
    xy: np.ndarray
    ur: np.ndarray
    octave: np.ndarray
    frame: int = -1
    matches: Optional[Matches] = None


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]), torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w)
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-12:
        return eye + K
    return eye + torch.sin(th) / th * K + (1.0 - torch.cos(th)) / th ** 2 * (K @ K)


def solve_pose(a: Answer, cam: Dict, scale_factor: float, dtype=torch.float64,
               device="cpu", max_iters: int = 50):
    """(R, t) minimizing the answer's reprojection cost, Gauss-Newton with
    Levenberg damping from the program's pose, every operation in `dtype`
    except the 6 x 6 solve (float64 for float64, float32 otherwise)."""
    dt = dtype
    sdt = torch.float64 if dtype == torch.float64 else torch.float32
    P = torch.as_tensor(a.points, device=device).to(dt)
    obs = torch.as_tensor(np.concatenate([a.xy, a.ur[:, None]], 1), device=device).to(dt)
    stereo = torch.as_tensor(a.ur >= 0, device=device)
    w = torch.as_tensor(1.0 / scale_factor ** (2.0 * a.octave.astype(np.float64)),
                        device=device).to(dt)
    fx, fy, cx, cy, bf = (float(cam[k]) for k in CAMERA_KEYS)
    R = torch.as_tensor(a.R, device=device).to(dt)
    t = torch.as_tensor(a.t, device=device).to(dt)

    def residual(R, t):
        X = P @ R.T + t
        z = X[:, 2]
        iz = 1.0 / z
        u = fx * X[:, 0] * iz + cx
        v = fy * X[:, 1] * iz + cy
        e = torch.stack([obs[:, 0] - u, obs[:, 1] - v,
                         torch.where(stereo, obs[:, 2] - (u - bf * iz), torch.zeros_like(u))], 1)
        return e, X, iz

    def cost(e):
        return float((w[:, None] * e * e).to(sdt).sum())

    lam = 1e-6
    e, X, iz = residual(R, t)
    c = cost(e)
    for _ in range(max_iters):
        x, y = X[:, 0], X[:, 1]
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        # d(u, v)/dXc, then dXc/d(dw, dt) = [-[Xc]x, I] (left perturbation).
        du = torch.stack([fx * iz, zero, -fx * x * iz2], 1)
        dv = torch.stack([zero, fy * iz, -fy * y * iz2], 1)
        dur = du - torch.stack([zero, zero, -bf * iz2], 1)
        dX = torch.cat([_batch_neg_skew(X),
                        torch.eye(3, dtype=dt, device=X.device).expand(X.shape[0], 3, 3)], 2)
        J = -torch.stack([torch.einsum("nk,nkj->nj", d, dX) for d in (du, dv, dur)], 1)
        J[:, 2] = torch.where(stereo[:, None], J[:, 2], torch.zeros_like(J[:, 2]))
        H = torch.einsum("n,nri,nrj->ij", w, J, J).to(sdt)
        g = torch.einsum("n,nri,nr->i", w, J, e).to(sdt)
        step = torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H)), -g).to(dt)
        dR = _exp_so3(step[:3])
        R_new, t_new = dR @ R, dR @ t + step[3:]
        e_new, X_new, iz_new = residual(R_new, t_new)
        c_new = cost(e_new)
        if c_new <= c:
            R, t, e, X, iz = R_new, t_new, e_new, X_new, iz_new
            done = c - c_new <= 1e-15 * max(c, 1e-30) or float(torch.linalg.norm(step)) < 1e-13
            c = c_new
            lam = max(lam / 10.0, 1e-12)
            if done:
                break
        else:
            lam *= 10.0
            if lam > 1e8:
                break
    return R.to(torch.float64).cpu().numpy(), t.to(torch.float64).cpu().numpy()


def _batch_neg_skew(X: torch.Tensor) -> torch.Tensor:
    """[n, 3, 3]: -[X_i]x."""
    z = torch.zeros_like(X[:, 0])
    x, y, w = X[:, 0], X[:, 1], X[:, 2]
    return -torch.stack([torch.stack([z, -w, y], 1), torch.stack([w, z, -x], 1),
                         torch.stack([-y, x, z], 1)], 1)


def cost(a: Answer, R: np.ndarray, t: np.ndarray, cam: Dict, scale_factor: float) -> float:
    """The answer's reprojection cost at the pose (R, t), in float64."""
    fx, fy, cx, cy, bf = (float(cam[k]) for k in CAMERA_KEYS)
    X = a.points @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    z = X[:, 2]
    u = fx * X[:, 0] / z + cx
    v = fy * X[:, 1] / z + cy
    e = np.stack([a.xy[:, 0] - u, a.xy[:, 1] - v,
                  np.where(a.ur >= 0, a.ur - (u - bf / z), 0.0)], 1)
    w = 1.0 / scale_factor ** (2.0 * a.octave.astype(np.float64))
    return float((w[:, None] * e * e).sum())


def pose_gaps(answers: List[Answer], cam: Dict, scale_factor: float,
              dtype=torch.float64, device="cpu") -> np.ndarray:
    """Each answer's distance from the reference's minimum in standard
    deviations of the estimate: sqrt(cost(answer's pose) - cost(minimum)),
    the cost in chi2 units (1 px at level 0). Near the minimum the excess
    is the gap's Mahalanobis norm under the cost's own Hessian, so a
    direction the measurements barely constrain counts for little. With
    dtype below float64, the excess of that solve in `dtype` (the control
    in the program's place) over the float64 one."""
    out = []
    for a in answers:
        R_ref, t_ref = solve_pose(a, cam, scale_factor, torch.float64, device)
        if dtype == torch.float64:
            R_b, t_b = a.R, a.t
        else:
            R_b, t_b = solve_pose(a, cam, scale_factor, dtype, device)
        excess = cost(a, R_b, t_b, cam, scale_factor) - cost(a, R_ref, t_ref, cam, scale_factor)
        out.append(float(np.sqrt(max(excess, 0.0))))
    return np.asarray(out)


# PoseOptimization's chi-square thresholds (95%, 2 and 3 degrees of freedom).
CHI2_MONO, CHI2_STEREO = 5.991, 7.815


def chi2(m: Matches, R, t, cam: Dict, scale_factor: float, dtype=torch.float64) -> np.ndarray:
    """Each match's weighted squared residual at the pose (R, t), in
    `dtype`; inf for a point behind the camera."""
    fx, fy, cx, cy, bf = (float(cam[k]) for k in CAMERA_KEYS)
    P = torch.as_tensor(m.points).to(dtype)
    X = P @ torch.as_tensor(np.asarray(R, np.float64)).to(dtype).T \
        + torch.as_tensor(np.asarray(t, np.float64)).to(dtype)
    z = X[:, 2]
    u = fx * X[:, 0] / z + cx
    v = fy * X[:, 1] / z + cy
    obs = torch.as_tensor(np.concatenate([m.xy, m.ur[:, None]], 1)).to(dtype)
    stereo = torch.as_tensor(m.ur >= 0)
    e = torch.stack([obs[:, 0] - u, obs[:, 1] - v,
                     torch.where(stereo, obs[:, 2] - (u - bf / z), torch.zeros_like(u))], 1)
    w = torch.as_tensor(1.0 / scale_factor ** (2.0 * m.octave.astype(np.float64))).to(dtype)
    c = (w[:, None] * e * e).sum(1).to(torch.float64).numpy()
    return np.where(z.to(torch.float64).numpy() > 0, c, np.inf)


def inlier_gaps(answers: List[Answer], cam: Dict, scale_factor: float,
                dtype=torch.float64, device="cpu") -> np.ndarray:
    """Each tracked frame's inlier count against the reference's: the
    matches its last pose solve was given, classified by PoseOptimization's
    chi-square test at the reference's float64 minimum, against those the
    program kept; the gap is |reference - program| over the reference's
    count. With dtype below float64, the classification of that solve in
    `dtype` stands in for the program's."""
    out = []
    for a in answers:
        m = a.matches
        if m is None or not len(m.points):
            continue
        thr = np.where(m.ur >= 0, CHI2_STEREO, CHI2_MONO)
        R_ref, t_ref = solve_pose(a, cam, scale_factor, torch.float64, device)
        n_ref = int((chi2(m, R_ref, t_ref, cam, scale_factor) < thr).sum())
        if dtype == torch.float64:
            n_got = int(m.kept.sum())
        else:
            R_b, t_b = solve_pose(a, cam, scale_factor, dtype, device)
            n_got = int((chi2(m, R_b, t_b, cam, scale_factor, dtype) < thr).sum())
        out.append(abs(n_ref - n_got) / max(n_ref, 1))
    return np.asarray(out)


def drift_pcts(answers: List[Answer], truth: List, min_m: float,
               poses: Optional[List] = None) -> np.ndarray:
    """The keyframes' drift from the ground truth over the window: for each
    keyframe at least `min_m` from the window's first, the distance between
    its camera centre and the true one, both in the first keyframe's camera
    frame, in % of the true distance between the two (the KITTI odometry
    benchmark's translational error, one segment from the window's start).
    `truth[frame]` is the pool's (R_cw, t_cw); `poses` stands in for the
    answers' poses (the control's)."""
    if poses is None:
        poses = [(a.R, a.t) for a in answers]
    if len(answers) < 2:
        return np.zeros(0)
    R0, t0 = (np.asarray(x, np.float64) for x in poses[0])
    G0, g0 = truth[answers[0].frame]
    out = []
    for a, (R, t) in zip(answers[1:], poses[1:]):
        G, g = truth[a.frame]
        want = G0 @ (-G.T @ g) + g0
        dist = float(np.linalg.norm(want))
        if dist < min_m:
            continue
        R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
        got = R0 @ (-R.T @ t) + t0
        out.append(100.0 * float(np.linalg.norm(got - want)) / dist)
    return np.asarray(out)


def step_errors_pct(answers: List[Answer], truth: List,
                    poses: Optional[List] = None) -> np.ndarray:
    """Each step between consecutive keyframes against the ground truth:
    the distance between the later camera centre and the true one, both in
    the earlier keyframe's camera frame, in % of the true step (the KITTI
    benchmark's relative error at the shortest segment: a wrong scale, a
    wrong stereo depth or a pose solved wrongly shows on every step).
    `poses` stands in for the answers' poses (the control's)."""
    if poses is None:
        poses = [(a.R, a.t) for a in answers]
    out = []
    for k in range(1, len(answers)):
        G0, g0 = truth[answers[k - 1].frame]
        G, g = truth[answers[k].frame]
        want = G0 @ (-G.T @ g) + g0
        dist = float(np.linalg.norm(want))
        if dist < 1e-3:
            continue
        R0, t0 = (np.asarray(x, np.float64) for x in poses[k - 1])
        R, t = (np.asarray(x, np.float64) for x in poses[k])
        got = R0 @ (-R.T @ t) + t0
        out.append(100.0 * float(np.linalg.norm(got - want)) / dist)
    return np.asarray(out)


def depth_gaps(samples: List[Dict], factor: float, dtype=torch.float64) -> np.ndarray:
    """RGB-D association: each sampled frame's largest relative gap between
    a feature's depth and the depth map's value at its rounded raw pixel
    over the factor (the guarantee of ComputeStereoFromRGBD). With dtype
    below float64, the reference's depth in that precision stands in for
    the program's."""
    out = []
    for s in samples:
        xy, depth, D = s["xy_raw"], s["depth"], s["depth_image"]
        h, w = D.shape
        u = np.clip(np.round(xy[:, 0]).astype(np.int64), 0, w - 1)
        v = np.clip(np.round(xy[:, 1]).astype(np.int64), 0, h - 1)
        ref = D[v, u].astype(np.float64) / factor
        has = ref > 0
        if dtype == torch.float64:
            got = np.where(depth > 0, depth.astype(np.float64), 0.0)
        else:
            got = torch.as_tensor(D[v, u].astype(np.float64)).to(dtype)
            got = (got / torch.tensor(factor, dtype=dtype)).to(torch.float64).numpy()
        gap = np.abs(got - ref) / np.where(has, ref, 1.0)
        gap = np.where(has | (depth > 0), np.where(has, gap, 1.0), 0.0)
        out.append(float(gap.max()) if gap.size else 0.0)
    return np.asarray(out)


def undistort(xy_raw: np.ndarray, cam: Dict, dtype=torch.float64) -> np.ndarray:
    """Raw (distorted) pixels -> undistorted pixels: the radial-tangential
    model (k1, k2, p1, p2, k3) inverted by Newton's method in `dtype`."""
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    k1, k2, p1, p2, k3 = (float(cam[k]) for k in ("k1", "k2", "p1", "p2", "k3"))
    xd = torch.as_tensor((xy_raw[:, 0] - cx) / fx).to(dtype)
    yd = torch.as_tensor((xy_raw[:, 1] - cy) / fy).to(dtype)
    x, y = xd.clone(), yd.clone()
    for _ in range(30):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        drad = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)      # d rad / d r2
        fxv = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        fyv = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - yd
        a = rad + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
        b = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
        c = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
        d = rad + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
        det = a * d - b * c
        x = x - (d * fxv - b * fyv) / det
        y = y - (a * fyv - c * fxv) / det
    u = (x * fx + cx).to(torch.float64).numpy()
    v = (y * fy + cy).to(torch.float64).numpy()
    return np.stack([u, v], 1)


def undistort_gaps(samples: List[Dict], cam: Dict, dtype=torch.float64) -> np.ndarray:
    """Lens: each sampled frame's largest gap (px) between a feature's
    undistorted pixel and the reference's inversion of its raw pixel. With
    dtype below float64, the inversion in that precision stands in for the
    program's."""
    out = []
    for s in samples:
        if not len(s["xy_raw"]):
            continue
        ref = undistort(s["xy_raw"], cam)
        got = s["xy"] if dtype == torch.float64 else undistort(s["xy_raw"], cam, dtype)
        out.append(float(np.abs(got - ref).max()))
    return np.asarray(out)


def judge(numbers: Dict[str, Optional[float]], limits: Dict[str, float]):
    """[(name, value, limit, ok)] for each number that has a limit; a
    number with a limit and no value (nothing was sampled) fails."""
    rows = []
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and np.isfinite(value) and value <= limit
        rows.append((name, value, limit, bool(ok)))
    return rows
