"""Trajectory export in TUM and KITTI formats + ATE evaluation (the port's
copy of utils/trajectory.py; host numpy, with the quaternion from the
port's ops/lie.py in float64 on the CPU).

Oracle: System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM /
SaveTrajectoryKITTI (reference: src/System.cc:336-486). Poses are stored
camera-from-world (Tcw); exports write world-from-camera (Twc), TUM rows as
`timestamp tx ty tz qx qy qz qw`, KITTI rows as the flattened 3x4 Twc.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.ops import lie


def tcw_to_twc(R: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    Rwc = R.T
    twc = -Rwc @ t
    return Rwc, twc


def tum_line(timestamp: float, R_cw: np.ndarray, t_cw: np.ndarray) -> str:
    Rwc, twc = tcw_to_twc(R_cw, t_cw)
    q = lie.rotation_to_quaternion(
        torch.from_numpy(np.array(Rwc, np.float64))).numpy()
    return (
        f"{timestamp:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
    )


def kitti_line(R_cw: np.ndarray, t_cw: np.ndarray) -> str:
    Rwc, twc = tcw_to_twc(R_cw, t_cw)
    T = np.concatenate([Rwc, twc[:, None]], axis=1)
    return " ".join(f"{v:.9e}" for v in T.reshape(-1))


def write_tum(
    path: str, entries: Sequence[Tuple[float, np.ndarray, np.ndarray]]
) -> None:
    with open(path, "w") as f:
        for ts, R, t in entries:
            f.write(tum_line(ts, R, t) + "\n")


def write_kitti(
    path: str, entries: Sequence[Tuple[float, np.ndarray, np.ndarray]]
) -> None:
    with open(path, "w") as f:
        for _, R, t in entries:
            f.write(kitti_line(R, t) + "\n")


# ---------------------------------------------------------------------------
# Evaluation (the external TUM-tools role, SURVEY.md §4)
# ---------------------------------------------------------------------------


def umeyama_alignment(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Closed-form similarity alignment est -> gt (Umeyama 1991).

    Returns (s, R, t) with gt ~ s * R @ est + t. with_scale=True for
    monocular (scale-free) trajectories, False for stereo/RGB-D.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / est.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe * xe).sum() / est.shape[0]
        s = float(np.trace(np.diag(d) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align_scale: bool = True,
) -> float:
    """Absolute trajectory error RMSE after (scaled) rigid alignment —
    the metric of the TUM RGB-D benchmark tools the reference defers to
    (README.md:116-187)."""
    s, R, t = umeyama_alignment(est_positions, gt_positions, align_scale)
    aligned = est_positions @ (s * R).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_stats(
    est_poses: Sequence[Tuple[np.ndarray, np.ndarray]],
    gt_poses: Sequence[Tuple[np.ndarray, np.ndarray]],
    delta: int = 1,
) -> Tuple[float, float]:
    """Relative pose error over a fixed frame delta (TUM benchmark
    evaluate_rpe.py semantics; the drift metric of the reference's
    evaluation workflow, README.md:116-187).

    Poses are camera-from-world (R_cw, t_cw) pairs, time-aligned between
    est and gt. For each i the error motion is
    E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}) with Q gt / P est
    world-from-camera transforms. Returns (translational RMSE in
    trajectory units per delta, rotational RMSE in radians per delta).
    """
    n = min(len(est_poses), len(gt_poses))
    t_errs, r_errs = [], []
    for i in range(n - delta):
        motions = []
        for poses in (est_poses, gt_poses):
            Ra, ta = poses[i]
            Rb, tb = poses[i + delta]
            # Relative camera motion a->b in a's frame:
            # Twc_a^-1 Twc_b = Tcw_a * Twc_b.
            R_rel = Ra @ Rb.T
            t_rel = Ra @ (-Rb.T @ tb.reshape(3)) + ta.reshape(3)
            motions.append((R_rel, t_rel))
        (Rp, tp), (Rq, tq) = motions
        # E = Q_rel^-1 P_rel.
        Re = Rq.T @ Rp
        te = Rq.T @ (tp - tq)
        t_errs.append(float(np.linalg.norm(te)))
        cos = (np.trace(Re) - 1.0) / 2.0
        r_errs.append(float(np.arccos(np.clip(cos, -1.0, 1.0))))
    t_arr = np.asarray(t_errs)
    r_arr = np.asarray(r_errs)
    return (
        float(np.sqrt((t_arr ** 2).mean())),
        float(np.sqrt((r_arr ** 2).mean())),
    )
