"""K8 pose_lm: the whole pose-only LM in one launch (PyTorch port of
optim/pallas_pose_opt.py:pose_optimization_pallas; kernel in
csrc/pose_lm.cu). Its plain version is the masked PyTorch LM,
optim/pose_opt.pose_optimization_plain.

On CUDA tensors the wrapper launches the kernel; on CPU tensors it runs
the plain version. They sum in different orders, so poses agree to float32
rounding and inlier masks up to observations on the chi2 boundary. The
kernel counts the inliers itself, so a call is one device operation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations

# Float32 operations per active observation per evaluation (projection,
# residual, Huber weight, Jacobian rows, the 21 + 6 normal-equation sums),
# and per valid observation per inlier classification.
OPS_PER_EVAL = 320
OPS_PER_CLASSIFY = 40


def _check(R0, t0, points, obs) -> None:
    """Shapes, dtypes (float32 on the card; the plain version also takes
    float64), contiguity and one device."""
    fdt = torch.float32 if points.device.type == "cuda" else points.dtype
    o = points.shape[0]
    checks = ((R0, "R0", fdt, (3, 3)), (t0, "t0", fdt, (3,)),
              (points, "points", fdt, (o, 3)), (obs.uvr, "uvr", fdt, (o, 3)),
              (obs.inv_sigma2, "inv_sigma2", fdt, (o,)),
              (obs.is_stereo, "is_stereo", torch.bool, (o,)),
              (obs.valid, "valid", torch.bool, (o,)))
    for t, name, dtype, shape in checks:
        _build.require(t, f"pose_lm {name}", dtype, len(shape))
        if tuple(t.shape) != shape or t.device != points.device:
            raise ValueError(f"pose_lm {name}: shape {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {points.device}")


def _launch(R0, t0, points, obs, fx, fy, cx, cy, bf, n_rounds, iters_per_round
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch -> (pose [15]: R row-major, t, then the work done:
    evaluations, active observations summed over them, rounds run;
    inliers [O] bool; their count, int64 0-dim)."""
    pose = torch.empty(15, dtype=torch.float32, device=points.device)
    inliers = torch.empty(points.shape[0], dtype=torch.bool, device=points.device)
    n_inliers = torch.empty((), dtype=torch.int64, device=points.device)
    err = _build.library("pose_lm").pose_lm_launch(
        R0.data_ptr(), t0.data_ptr(), points.data_ptr(), obs.uvr.data_ptr(),
        obs.inv_sigma2.data_ptr(), obs.is_stereo.data_ptr(), obs.valid.data_ptr(),
        points.shape[0], fx, fy, cx, cy, bf, n_rounds, iters_per_round,
        pose.data_ptr(), inliers.data_ptr(), n_inliers.data_ptr(),
        _build.stream_of(points))
    _build.check(err, "pose_lm")
    _build.count_launch("pose_lm")
    return pose, inliers, n_inliers


def pose_lm(
    R0: torch.Tensor,          # [3, 3] float32 Tcw rotation
    t0: torch.Tensor,          # [3]
    points: torch.Tensor,      # [O, 3] world points
    obs: BAObservations,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    n_rounds: int = 4,
    iters_per_round: int = 10,
):
    """Pose-only BA of Tcw = (R0, t0) -> PoseOptResult (R, t, inliers [O]
    bool, n_inliers)."""
    from orb_slam2_commit_tpu_torch.optim import pose_opt

    _check(R0, t0, points, obs)
    if not _build.on_card(points, "pose_lm"):
        return pose_opt.pose_optimization_plain(
            R0, t0, points, obs, fx, fy, cx, cy, bf, n_rounds, iters_per_round)
    pose, inliers, n_inliers = _launch(R0, t0, points, obs, fx, fy, cx, cy, bf,
                                       n_rounds, iters_per_round)
    return pose_opt.PoseOptResult(
        R=pose[:9].reshape(3, 3), t=pose[9:12], inliers=inliers, n_inliers=n_inliers)


def work_done(R0, t0, points, obs, fx, fy, cx, cy, bf,
              n_rounds: int = 4, iters_per_round: int = 10) -> Tuple[float, float, float]:
    """Launch K8 on CUDA tensors and return the work it did on them, to
    count the operations this input needs: (evaluations, active
    observations summed over evaluations, rounds run). Waits for the
    launch."""
    _check(R0, t0, points, obs)
    if not _build.on_card(points, "pose_lm"):
        raise ValueError("pose_lm work_done: the kernel runs only on the card")
    pose, _, _ = _launch(R0, t0, points, obs, fx, fy, cx, cy, bf, n_rounds,
                         iters_per_round)
    n_evals, obs_evals, rounds = pose[12:].cpu().tolist()
    return n_evals, obs_evals, rounds
