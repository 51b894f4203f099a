"""Monocular SLAM on a synthetic sequence (the port's counterpart of
examples/run_synthetic_mono.py; the stand-in for
Examples/Monocular/mono_tum.cc without a dataset).

Usage:
  python -m orb_slam2_commit_tpu_torch.examples.run_synthetic_mono [n_frames] [--device=cpu]

40 frames at 400x300 and 1000 features by default, on the CUDA card
unless --device=cpu. Prints each frame's state, the ATE RMSE against the
exact ground truth (scale-aligned), the RPE, and the stage timings; writes
the trajectory to synthetic_traj.txt under the temporary directory.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np


def main(argv) -> int:
    from orb_slam2_commit_tpu_torch.slam.system import System
    from orb_slam2_commit_tpu_torch.utils import synthetic
    from orb_slam2_commit_tpu_torch.utils import trajectory as traj
    from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

    n_frames = int(argv[0]) if argv and argv[0].isdigit() else 40
    device = "cpu" if "--device=cpu" in argv else "cuda"
    cfg = synthetic_config(width=400, height=300, n_features=1000)
    print(f"rendering {n_frames} frames...")
    images, poses_gt, _ = synthetic.render_sequence(
        cfg.camera, n_frames=n_frames, n_points=400, seed=3, step=0.05)
    sys_ = System(cfg, device=device)

    t0 = time.time()
    n_tracked = 0
    for i in range(n_frames):
        t1 = time.time()
        pose = sys_.track_monocular(images[i], i / cfg.camera.fps)
        if pose is not None:
            n_tracked += 1
        print(f"frame {i:3d}: state={sys_.tracking_state().name:15s} "
              f"kf={sys_.map.n_keyframes():3d} pts={sys_.map.n_points():5d} "
              f"inliers={sys_.tracker.n_inliers:4d} dt={time.time() - t1:.2f}s")
    sys_.shutdown()
    print(f"total {time.time() - t0:.1f}s, tracked {n_tracked}/{n_frames}")

    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    # The trajectory starts at the first initialized frame.
    offset = n_frames - len(est)
    gt_used = gt[offset:]
    ok = ~lost
    if est.shape[0] >= 5:
        rmse = traj.ate_rmse(est[ok], gt_used[ok], align_scale=True)
        print(f"ATE RMSE (scale-aligned): {rmse:.4f} m  "
              f"(trajectory span {np.linalg.norm(gt[-1] - gt[0]):.2f} m)")
        # Drift (TUM evaluate_rpe semantics), the monocular scale aligned first.
        s, _, _ = traj.umeyama_alignment(est[ok], gt_used[ok])
        est_poses = [(R, s * t) for _, R, t in sys_._resolve_trajectory()]
        gt_poses = [poses_gt[i + offset] for i in range(len(est_poses))]
        t_rpe, r_rpe = traj.rpe_stats(est_poses, gt_poses, delta=1)
        print(f"RPE (delta=1 frame): {t_rpe:.4f} m, {np.degrees(r_rpe):.3f} deg")
    path = os.path.join(tempfile.gettempdir(), "synthetic_traj.txt")
    sys_.save_trajectory_tum(path)
    print(f"saved {path}")
    print(sys_.profiler.report())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
