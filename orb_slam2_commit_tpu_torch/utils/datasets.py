"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV (the port's copy
of utils/datasets.py).

The loading code of the reference's example drivers (reference:
Examples/Monocular/mono_tum.cc LoadImages :137-163, mono_kitti.cc,
mono_euroc.cc, Stereo/stereo_kitti.cc, stereo_euroc.cc :55-98 online
rectification, RGB-D/rgbd_tum.cc associations parsing). Images load
lazily through the port's own PNG reader (utils/png.py); timestamps, file
lists, associations and the rectification maps are host numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from orb_slam2_commit_tpu_torch.utils.png import read_png


def _load_gray(path: str) -> np.ndarray:
    """An image as grayscale [H, W]. 8-bit sources stay uint8, so the
    upload to the device moves 1 byte a pixel (the extraction casts to
    float32 on the device, from the reference's 8-bit grayscale input,
    src/Tracking.cc:246-259); colour is weighted to gray as cvtColor does
    and rounded back to 8 bits; 16-bit sources (TUM depth) come back as
    float32 raw units."""
    img = read_png(path)
    if img.ndim == 3:
        gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        if img.dtype == np.uint8:
            return np.clip(np.round(gray), 0, 255).astype(np.uint8)
        return gray.astype(np.float32)
    if img.dtype == np.uint8:
        return img
    return img.astype(np.float32)


@dataclasses.dataclass
class Sequence:
    """A frame sequence, its images read as it is walked."""

    timestamps: List[float]
    rgb_paths: List[str]
    depth_paths: Optional[List[str]] = None
    right_paths: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.timestamps)

    def frames(self) -> Iterator[Tuple[float, np.ndarray, Optional[np.ndarray]]]:
        """(timestamp, image, depth map or right image or None) per frame."""
        for i in range(len(self.timestamps)):
            img = _load_gray(self.rgb_paths[i])
            aux = None
            if self.depth_paths is not None:
                aux = _load_gray(self.depth_paths[i])
            elif self.right_paths is not None:
                aux = _load_gray(self.right_paths[i])
            yield self.timestamps[i], img, aux


def load_tum_mono(root: str) -> Sequence:
    """rgb.txt: `# comment` lines and `timestamp path` rows
    (mono_tum.cc LoadImages :137-163)."""
    ts, paths = [], []
    with open(os.path.join(root, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, rel = line.split()[:2]
            ts.append(float(t))
            paths.append(os.path.join(root, rel))
    return Sequence(ts, paths)


def load_tum_rgbd(root: str, associations: str) -> Sequence:
    """An associations file of `t1 rgb t2 depth` rows
    (rgbd_tum.cc LoadImages :140-167)."""
    ts, rgb, depth = [], [], []
    with open(associations) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ts.append(float(parts[0]))
            rgb.append(os.path.join(root, parts[1]))
            depth.append(os.path.join(root, parts[3]))
    return Sequence(ts, rgb, depth_paths=depth)


def load_kitti(root: str, stereo: bool = False) -> Sequence:
    """times.txt and image_0/%06d.png (and image_1/)
    (mono_kitti.cc LoadImages :135-157, stereo_kitti.cc)."""
    ts = []
    with open(os.path.join(root, "times.txt")) as f:
        for line in f:
            if line.strip():
                ts.append(float(line))
    left_dir = os.path.join(root, "image_0")
    left = [os.path.join(left_dir, f"{i:06d}.png") for i in range(len(ts))]
    right = None
    if stereo:
        right_dir = os.path.join(root, "image_1")
        right = [os.path.join(right_dir, f"{i:06d}.png") for i in range(len(ts))]
    return Sequence(ts, left, right_paths=right)


def load_euroc(root: str, stereo: bool = False) -> Sequence:
    """The EuRoC mav0 layout: cam0/data.csv timestamps (ns) and
    cam0/data/<ns>.png, cam1/ beside it for stereo
    (mono_euroc.cc LoadImages :134-156)."""
    cam0 = os.path.join(root, "mav0", "cam0")
    ts, left = [], []
    with open(os.path.join(cam0, "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            stamp = line.split(",")[0]
            ts.append(float(stamp) * 1e-9)
            left.append(os.path.join(cam0, "data", stamp + ".png"))
    right = None
    if stereo:
        cam1 = os.path.join(root, "mav0", "cam1")
        right = [p.replace(cam0, cam1) for p in left]
    return Sequence(ts, left, right_paths=right)


# ---------------------------------------------------------------------------
# Stereo rectification (stereo_euroc.cc:55-98: initUndistortRectifyMap, then
# a remap of every frame)
# ---------------------------------------------------------------------------


def rectify_maps(
    K: np.ndarray, D: np.ndarray, R: np.ndarray, P: np.ndarray,
    width: int, height: int,
):
    """The undistort + rectify sampling maps (map_x, map_y) float32, as
    cv::initUndistortRectifyMap builds them for the radial-tangential
    model: each rectified pixel's ray, rotated back into the raw camera by
    R^T, distorted by D and projected by K."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    fx_p, fy_p = P[0, 0], P[1, 1]
    cx_p, cy_p = P[0, 2], P[1, 2]
    xn = (xs - cx_p) / fx_p
    yn = (ys - cy_p) / fy_p
    ones = np.ones_like(xn)
    rays = np.stack([xn, yn, ones], axis=-1) @ R   # R^T applied to each ray
    x = rays[..., 0] / rays[..., 2]
    y = rays[..., 1] / rays[..., 2]
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.shape[0] > 4 else 0.0
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray
                   ) -> np.ndarray:
    """cv::remap with INTER_LINEAR and a zero border; 8-bit input is
    rounded back to uint8, as cv::remap does on CV_8U."""
    h, w = img.shape
    x0 = np.clip(np.floor(map_x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(map_y).astype(int), 0, h - 2)
    fx = np.clip(map_x - x0, 0.0, 1.0)
    fy = np.clip(map_y - y0, 0.0, 1.0)
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    invalid = (map_x < 0) | (map_x > w - 1) | (map_y < 0) | (map_y > h - 1)
    out = np.where(invalid, 0.0, out)
    if img.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(np.float32)
