"""Pinhole camera projection and distortion (PyTorch port of
ops/camera.py).

Replaces the reference's scattered cv:: camera math: projection in
isInFrustum (src/Frame.cc:315-378), cv::undistortPoints in
UndistortKeyPoints (src/Frame.cc:471-506), and stereo back-projection
(src/Frame.cc:823-839). Batched over leading dimensions.
"""

from __future__ import annotations

import torch

from orb_slam2_commit_tpu_torch.utils.config import CameraConfig


def project(points_cam: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (no distortion:
    keypoints are undistorted once at extraction, the reference's
    convention)."""
    z = points_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = cam.fx * points_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * points_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(points_cam: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """[..., 3] -> (u_left, v, u_right) for stereo residuals
    (g2o EdgeStereoSE3ProjectXYZ, types_six_dof_expmap.h:122-127)."""
    uv = project(points_cam, cam)
    z = points_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u_r = uv[..., 0] - cam.bf * inv_z
    return torch.cat([uv, u_r[..., None]], dim=-1)


def distort_normalized(xn: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(
    xd: torch.Tensor, cam: CameraConfig, iters: int = 20
) -> torch.Tensor:
    """Invert the distortion model by fixed-point iteration (the scheme
    cv::undistortPoints uses). 20 iterations reach < 2e-4 px round-trip
    error at the image corners for TUM1-size coefficients."""
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xx * yy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xx * yy
        x = torch.stack(
            [(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return x


def undistort_pixels(uv: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Distorted pixel coords [..., 2] -> undistorted pixel coords
    (Frame::UndistortKeyPoints, src/Frame.cc:471-506). A no-op, returning
    uv itself, when the camera has no distortion (:475-480)."""
    if not cam.has_distortion:
        return uv
    xn = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xu = undistort_normalized(xn, cam)
    return torch.stack(
        [xu[..., 0] * cam.fx + cam.cx, xu[..., 1] * cam.fy + cam.cy], dim=-1)


def unproject(uv: torch.Tensor, depth: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Undistorted pixels + depth -> camera-frame 3D points
    (Frame::UnprojectStereo, src/Frame.cc:823-839)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)
