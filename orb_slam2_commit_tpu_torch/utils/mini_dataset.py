"""On-disk miniature datasets in the reference's dataset layouts (the
port's copy of utils/mini_dataset.py).

The reference's example drivers load a sequence from disk through each
dataset's file conventions, drive the System and export trajectories
(Examples/Monocular/mono_tum.cc:36-134, Stereo/stereo_kitti.cc:29-166,
RGB-D/rgbd_tum.cc). These writers lay out rendered sequences the same way:
8-bit gray PNGs, 16-bit TUM depth PNGs (through utils/png.py), the
`rgb.txt` / `associations.txt` / `times.txt` / `data.csv` indexes, and a
reference-style settings YAML, so that the port's driver
(examples/run_dataset.py) runs on them as it runs on the real datasets.

Layouts:
  TUM   rgb.txt `# comment` + `ts path` rows    (mono_tum.cc:137-163)
  TUM   associations `t1 rgb t2 depth` rows     (rgbd_tum.cc:140-167)
  KITTI times.txt + image_0/%06d.png (+image_1)  (mono_kitti.cc:135-157)
  EuRoC mav0/cam0/data.csv ns timestamps         (mono_euroc.cc:134-156)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.png import write_png


def _save_png8(path: str, img: np.ndarray) -> None:
    write_png(path, np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8))


def _save_png16(path: str, depth_m: np.ndarray, factor: float) -> None:
    """A TUM-convention 16-bit depth PNG: depth x factor, 0 for no depth."""
    write_png(path, np.clip(np.round(np.asarray(depth_m) * factor), 0, 65535)
              .astype(np.uint16))


def write_settings_yaml(path: str, cfg: SLAMConfig,
                        depth_map_factor: float = 0.0) -> str:
    """A reference-style OpenCV settings YAML (the schema of
    Examples/Monocular/TUM1.yaml: Camera.*, ThDepth, DepthMapFactor,
    ORBextractor.*), with Camera.width / Camera.height, so a miniature
    dataset carries its own image size (the real KITTI and EuRoC YAMLs
    leave it out, and the drivers pass each dataset's own)."""
    cam, orb = cfg.camera, cfg.orb
    lines = [
        "%YAML:1.0",
        "",
        "# Camera calibration and distortion parameters (OpenCV)",
        f"Camera.fx: {cam.fx}",
        f"Camera.fy: {cam.fy}",
        f"Camera.cx: {cam.cx}",
        f"Camera.cy: {cam.cy}",
        f"Camera.k1: {cam.k1}",
        f"Camera.k2: {cam.k2}",
        f"Camera.p1: {cam.p1}",
        f"Camera.p2: {cam.p2}",
        f"Camera.k3: {cam.k3}",
        f"Camera.width: {cam.width}",
        f"Camera.height: {cam.height}",
        f"Camera.fps: {cam.fps}",
        f"Camera.bf: {cam.bf}",
        "Camera.RGB: 1",
        f"ThDepth: {cam.th_depth}",
    ]
    if depth_map_factor:
        lines.append(f"DepthMapFactor: {depth_map_factor}")
    lines += [
        "",
        f"ORBextractor.nFeatures: {orb.n_features}",
        f"ORBextractor.scaleFactor: {orb.scale_factor}",
        f"ORBextractor.nLevels: {orb.n_levels}",
        f"ORBextractor.iniThFAST: {orb.ini_th_fast}",
        f"ORBextractor.minThFAST: {orb.min_th_fast}",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def _matrix_block(name: str, arr: np.ndarray) -> List[str]:
    a = np.asarray(arr, dtype=float)
    data = ", ".join(f"{v:.12g}" for v in a.reshape(-1))
    return [
        f"{name}: !!opencv-matrix",
        f"   rows: {a.shape[0]}",
        f"   cols: {a.shape[1]}",
        "   dt: d",
        f"   data: [{data}]",
    ]


def append_euroc_stereo_blocks(
    yaml_path: str,
    K_l: np.ndarray, D_l: np.ndarray, R_l: np.ndarray, P_l: np.ndarray,
    K_r: np.ndarray, D_r: np.ndarray, R_r: np.ndarray, P_r: np.ndarray,
) -> str:
    """Append the LEFT.* / RIGHT.* opencv-matrix blocks that the
    euroc-stereo driver rectifies from (the schema of
    Examples/Stereo/EuRoC.yaml; stereo_euroc.cc:55-98). K and D describe
    the raw cameras, R rotates raw-camera rays into the rectified frame
    (cv::initUndistortRectifyMap's convention), P is the rectified
    projection, whose pinhole must match the Camera.* block."""
    lines: List[str] = [""]
    for name, arr in (
        ("LEFT.K", K_l), ("LEFT.D", np.asarray(D_l).reshape(1, -1)),
        ("LEFT.R", R_l), ("LEFT.P", P_l),
        ("RIGHT.K", K_r), ("RIGHT.D", np.asarray(D_r).reshape(1, -1)),
        ("RIGHT.R", R_r), ("RIGHT.P", P_r),
    ):
        lines += _matrix_block(name, arr)
    with open(yaml_path, "a") as f:
        f.write("\n".join(lines) + "\n")
    return yaml_path


def write_tum_mono(root: str, images: np.ndarray,
                   timestamps: Sequence[float]) -> str:
    """`rgb/<ts>.png` and `rgb.txt` (a comment header, `ts path` rows)."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    rows = ["# color images", "# file: mini synthetic", "# timestamp filename"]
    for ts, img in zip(timestamps, images):
        rel = f"rgb/{ts:.6f}.png"
        _save_png8(os.path.join(root, rel), img)
        rows.append(f"{ts:.6f} {rel}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return root


def write_tum_rgbd(root: str, images: np.ndarray, depths: np.ndarray,
                   timestamps: Sequence[float],
                   depth_map_factor: float = 5000.0) -> str:
    """TUM RGB-D: rgb/ and depth/ (16-bit PNGs at TUM's factor 5000),
    rgb.txt and depth.txt, and the associations file the reference driver
    takes as its third argument. Returns the associations file's path."""
    write_tum_mono(root, images, timestamps)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    drows = ["# depth maps", "# timestamp filename"]
    arows = []
    for ts, d in zip(timestamps, depths):
        rel = f"depth/{ts:.6f}.png"
        _save_png16(os.path.join(root, rel), d, depth_map_factor)
        drows.append(f"{ts:.6f} {rel}")
        arows.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} {rel}")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(drows) + "\n")
    assoc = os.path.join(root, "associations.txt")
    with open(assoc, "w") as f:
        f.write("\n".join(arows) + "\n")
    return assoc


def write_kitti(root: str, lefts: np.ndarray,
                timestamps: Sequence[float],
                rights: Optional[np.ndarray] = None) -> str:
    """KITTI odometry: times.txt and image_0/%06d.png (and image_1/)."""
    os.makedirs(os.path.join(root, "image_0"), exist_ok=True)
    if rights is not None:
        os.makedirs(os.path.join(root, "image_1"), exist_ok=True)
    for i, ts in enumerate(timestamps):
        _save_png8(os.path.join(root, "image_0", f"{i:06d}.png"), lefts[i])
        if rights is not None:
            _save_png8(os.path.join(root, "image_1", f"{i:06d}.png"), rights[i])
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(f"{ts:.6e}" for ts in timestamps) + "\n")
    return root


def write_euroc(root: str, images: np.ndarray,
                timestamps: Sequence[float],
                rights: Optional[np.ndarray] = None) -> str:
    """EuRoC MAV: mav0/cam0/data.csv (ns) and mav0/cam0/data/<ns>.png
    (and cam1/)."""
    cams = ["cam0"] + (["cam1"] if rights is not None else [])
    for cam in cams:
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    rows = ["#timestamp [ns],filename"]
    for i, ts in enumerate(timestamps):
        ns = int(round(ts * 1e9))
        rows.append(f"{ns},{ns}.png")
        _save_png8(os.path.join(root, "mav0", "cam0", "data", f"{ns}.png"), images[i])
        if rights is not None:
            _save_png8(os.path.join(root, "mav0", "cam1", "data", f"{ns}.png"), rights[i])
    for cam in cams:
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return root


def load_tum_trajectory(path: str):
    """A TUM-format trajectory file -> (timestamps [N], centres [N, 3]),
    the format the driver exports and the TUM benchmark tools read."""
    ts: List[float] = []
    pos: List[List[float]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 8:
                continue
            ts.append(float(parts[0]))
            pos.append([float(p) for p in parts[1:4]])
    return np.asarray(ts), np.asarray(pos)
