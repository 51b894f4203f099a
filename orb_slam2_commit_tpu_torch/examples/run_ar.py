"""Monocular AR demo (the port's counterpart of examples/run_ar.py): track
a synthetic sequence, detect the dominant plane in the sparse map, and
draw a virtual cube anchored to it on every frame after.

The stand-in for the reference's MonoAR ROS node
(Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.h; README.md:196-205). The frames
with the overlay are written as PNG files.

Usage:
  python -m orb_slam2_commit_tpu_torch.examples.run_ar [n_frames] [--out DIR] [--device=cpu]

24 frames at 400x300, 1000 features, 60% of the landmarks on a plane
(seed 3), on the CUDA card unless --device=cpu; PNGs into DIR (ar_frames
under the temporary directory by default).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from typing import List

import numpy as np


@dataclasses.dataclass
class ARRun:
    """One run: the System, the anchor, the ground-truth poses, whether
    each frame got the cube, and the PNG files written."""

    system: object
    anchor: object
    poses_gt: list
    overlaid: List[bool]
    pngs: List[str]


def run(n_frames: int = 24, out_dir: str = None, device="cuda") -> ARRun:
    from orb_slam2_commit_tpu_torch.slam import viewer
    from orb_slam2_commit_tpu_torch.slam.ar import ARAnchor
    from orb_slam2_commit_tpu_torch.slam.system import System
    from orb_slam2_commit_tpu_torch.utils import synthetic
    from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

    if out_dir is None:
        out_dir = os.path.join(tempfile.gettempdir(), "ar_frames")
    os.makedirs(out_dir, exist_ok=True)
    cfg = synthetic_config(width=400, height=300, n_features=1000)
    cam = cfg.camera
    print(f"rendering {n_frames} frames (60% of landmarks on a plane)...")
    images, poses_gt, _ = synthetic.render_sequence(
        cam, n_frames=n_frames, n_points=400, seed=3, step=0.05, planar_frac=0.6)
    sys_ = System(cfg, device=device)
    anchor = ARAnchor(min_points=40, seed=7, device=device)

    overlaid, pngs = [], []
    t0 = time.time()
    for i in range(n_frames):
        pose = sys_.track_monocular(images[i], i / cam.fps)
        frame = sys_.tracker.last_frame
        canvas = np.stack([images[i]] * 3, axis=-1).astype(np.uint8)
        status = "tracking..."
        drawn = False
        if pose is not None and frame is not None:
            R, t = pose
            anchor.update(sys_.map.pt_pos, sys_.map.pt_valid, -R.T @ t)
            canvas = viewer.draw_frame(frame, images[i], sys_.tracking_state().name, sys_.map)
            drawn = anchor.overlay(canvas, R, t, cam.fx, cam.fy, cam.cx, cam.cy)
            if drawn:
                status = "cube anchored"
        overlaid.append(drawn)
        pngs.append(os.path.join(out_dir, f"ar_{i:04d}.png"))
        viewer.save_png(pngs[-1], canvas)
        print(f"frame {i:3d}: state={sys_.tracking_state().name:15s} {status}")
    sys_.shutdown()
    print(f"total {time.time() - t0:.1f}s; cube overlaid on {sum(overlaid)}/{n_frames} "
          f"frames; PNGs in {out_dir}")
    return ARRun(sys_, anchor, poses_gt, overlaid, pngs)


def main(argv) -> int:
    n_frames = int(argv[0]) if argv and argv[0].isdigit() else 24
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else None
    device = "cpu" if "--device=cpu" in argv else "cuda"
    run(n_frames, out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
