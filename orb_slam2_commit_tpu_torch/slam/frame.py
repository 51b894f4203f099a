"""Per-image measurement bundle (PyTorch port of slam/frame.py): the image
goes through the port's ORB extractor once, on the System's device (one
CUDA graph replay on the card: ops/extractor.extract_features_jit, and
ops/stereo.stereo_frontend_jit for a stereo pair); keypoints are
undistorted; everything else is fixed-shape numpy mirrors
that the host pipeline reads and the matchers and optimizers take back to
the device as they need them (reference: src/Frame.cc).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.interop import image_to_device, resolve_device, to_host
from orb_slam2_commit_tpu_torch.ops import camera as cam_ops
from orb_slam2_commit_tpu_torch.ops import extractor as ext
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig
from orb_slam2_commit_tpu_torch.utils.rotation import orthonormalize_rotation


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    # Feature arrays, padded to config.orb feature budget N.
    xy: np.ndarray          # [N, 2] undistorted keypoint coords
    xy_raw: np.ndarray      # [N, 2] raw (distorted) coords
    octave: np.ndarray      # [N] int32
    angle: np.ndarray       # [N] float32
    response: np.ndarray    # [N] float32
    desc: np.ndarray        # [N, 8] uint32
    valid: np.ndarray       # [N] bool
    # Stereo / RGB-D channels (<= 0 where absent).
    depth: np.ndarray       # [N]
    ur: np.ndarray          # [N] right-image u coordinate (-1 if none)
    # Pose Tcw (None until tracked).
    R: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    # Map-point binding per feature (-1 none).
    point_ids: Optional[np.ndarray] = None
    # Trajectory entry recorded for this frame (set by the tracker): the
    # relative pose to its reference keyframe, used to re-anchor the pose
    # when the map moves under BA (Tracking::UpdateLastFrame,
    # src/Tracking.cc:971-980).
    anchor: Optional[object] = None
    # The fused motion stage's packed feature matrix [N, 12] and
    # descriptor table [N, 8] int32, left on the device for the fused
    # local-map stage.
    dev_feat: Optional[torch.Tensor] = None
    dev_desc: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.point_ids is None:
            self.point_ids = np.full(self.xy.shape[0], -1, np.int32)

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def n_tracked(self) -> int:
        return int((self.point_ids >= 0).sum())

    def set_pose(self, R: np.ndarray, t: np.ndarray) -> None:
        self.R = orthonormalize_rotation(np.asarray(R, np.float64))
        self.t = np.asarray(t, np.float64)

    def camera_center(self) -> np.ndarray:
        return -self.R.T @ self.t


def make_frame(
    image: np.ndarray,
    frame_id: int,
    timestamp: float,
    config: SLAMConfig,
    depth_image: Optional[np.ndarray] = None,
    device="cuda",
) -> Frame:
    """Extract ORB features on `device` and build the host Frame.

    For RGB-D input, per-feature depth is read from depth_image at the raw
    keypoint location and a virtual right coordinate ur = u - bf/z is
    synthesized (Frame::ComputeStereoFromRGBD, src/Frame.cc:791-816)."""
    device = resolve_device(device)
    cam = config.camera
    feats = ext.extract_features_jit(image_to_device(image, device), config.orb, cam.height,
                                     cam.width)
    xy_raw = to_host(feats.xy).astype(np.float64)
    valid = to_host(feats.valid)
    # Undistorted in float32 on the device, as the JAX package does.
    xy_und = to_host(cam_ops.undistort_pixels(
        torch.as_tensor(xy_raw, dtype=torch.float32, device=device), cam)
    ).astype(np.float64)

    n = xy_raw.shape[0]
    depth = np.full(n, -1.0, np.float32)
    ur = np.full(n, -1.0, np.float32)
    if depth_image is not None:
        u = np.clip(np.round(xy_raw[:, 0]).astype(int), 0, cam.width - 1)
        v = np.clip(np.round(xy_raw[:, 1]).astype(int), 0, cam.height - 1)
        d = np.asarray(depth_image)[v, u].astype(np.float32)
        if cam.depth_map_factor not in (0.0, 1.0):
            d = d / cam.depth_map_factor
        has = d > 0
        depth = np.where(has, d, -1.0).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            ur_v = xy_und[:, 0] - cam.bf / np.where(has, d, 1.0)
        ur = np.where(has, ur_v, -1.0).astype(np.float32)

    return Frame(
        frame_id=frame_id,
        timestamp=timestamp,
        xy=xy_und,
        xy_raw=xy_raw,
        octave=to_host(feats.octave).astype(np.int32),
        angle=to_host(feats.angle).astype(np.float32),
        response=to_host(feats.response).astype(np.float32),
        desc=to_host(feats.desc).view(np.uint32),
        valid=valid,
        depth=depth,
        ur=ur,
    )


def make_stereo_frame(
    image_left: np.ndarray,
    image_right: np.ndarray,
    frame_id: int,
    timestamp: float,
    config: SLAMConfig,
    device="cuda",
) -> Frame:
    """Stereo frame: both extractions and the epipolar stereo matcher
    (ops/stereo.stereo_frontend; the stereo Frame constructor,
    src/Frame.cc:39-124, with ComputeStereoMatches :547-788)."""
    from orb_slam2_commit_tpu_torch.ops import stereo as stereo_ops

    device = resolve_device(device)
    cam = config.camera
    feats_l, _, match = stereo_ops.stereo_frontend_jit(
        image_to_device(image_left, device),
        image_to_device(image_right, device),
        config.orb, cam.height, cam.width, cam.bf, cam.baseline,
    )
    xy_raw = to_host(feats_l.xy).astype(np.float64)
    xy_und = to_host(cam_ops.undistort_pixels(
        torch.as_tensor(xy_raw, dtype=torch.float32, device=device), cam)
    ).astype(np.float64)
    return Frame(
        frame_id=frame_id,
        timestamp=timestamp,
        xy=xy_und,
        xy_raw=xy_raw,
        octave=to_host(feats_l.octave).astype(np.int32),
        angle=to_host(feats_l.angle).astype(np.float32),
        response=to_host(feats_l.response).astype(np.float32),
        desc=to_host(feats_l.desc).view(np.uint32),
        valid=to_host(feats_l.valid),
        depth=to_host(match.depth).astype(np.float32),
        ur=to_host(match.u_right).astype(np.float32),
    )
