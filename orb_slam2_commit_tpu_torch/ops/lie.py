"""SO3 / SE3 manifold operations (PyTorch port of the SO3 / SE3 half of
ops/lie.py; the Sim3 half comes with loop closing).

Conventions as in the JAX package: rotations are 3x3 matrices, rigid
transforms (R, t) act as x_cam = R @ x_world + t, and se3 tangent vectors
are [omega(3), upsilon(3)] (g2o's SE3Quat::exp ordering). Leading
dimensions broadcast.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w[..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: exp of so3 tangent w[..., 3] -> R[..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    # Taylor-safe coefficients: sin(t)/t and (1-cos t)/t^2.
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO3 s.t. exp([w,v]) translation = J @ v."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    c = (theta - torch.sin(theta)) / (theta2 * theta + _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def se3_exp(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp of se3 tangent xi[..., 6] = [omega, upsilon] -> (R, t)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    J = _so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", J, v)
    return R, t


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map R[..., 3, 3] -> w[..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    # theta / (2 sin theta), Taylor-safe near 0; near pi the axis comes
    # from the diagonal instead.
    generic = torch.abs(sin_theta) > 1e-5
    safe_sin = torch.where(generic, sin_theta, torch.ones_like(sin_theta))
    scale = torch.where(generic, theta / (2.0 * safe_sin), 0.5 + theta * theta / 12.0)
    w_generic = v * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp_min(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), 0.0)
    axis = torch.sqrt(axis2)
    one = torch.ones_like(theta)
    signs = torch.stack([
        torch.where(R[..., 2, 1] - R[..., 1, 2] < 0, -one, one),
        torch.where(R[..., 0, 2] - R[..., 2, 0] < 0, -one, one),
        torch.where(R[..., 1, 0] - R[..., 0, 1] < 0, -one, one),
    ], dim=-1)
    w_pi = axis * signs * theta[..., None]
    near_pi = torch.abs(sin_theta) <= 1e-5
    near_zero = theta < 1e-5
    return torch.where((near_pi & ~near_zero)[..., None], w_pi, w_generic)


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-6
    half_theta = 0.5 * theta
    safe_sin = torch.where(small, torch.ones_like(theta), torch.sin(half_theta))
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    cot = torch.cos(half_theta) / safe_sin
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half_theta * cot) / safe_theta2)
    return _eye_like(W) - 0.5 * W + k[..., None, None] * W2


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log of (R, t) -> xi[..., 6] = [omega, upsilon]."""
    w = so3_log(R)
    v = torch.einsum("...ij,...j->...i", _so3_left_jacobian_inv(w), t)
    return torch.cat([w, v], dim=-1)


def se3_compose(Ra, ta, Rb, tb) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ra, ta) * (Rb, tb): apply b first, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inverse(R, t) -> Tuple[torch.Tensor, torch.Tensor]:
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, x) -> torch.Tensor:
    """Transform points x[..., 3]."""
    return torch.einsum("...ij,...j->...i", R, x) + t


def se3_matrix(R, t) -> torch.Tensor:
    """Homogeneous 4x4 matrix from (R, t)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def se3_from_matrix(T) -> Tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """R[..., 3, 3] -> unit quaternion [..., 4] as (qx, qy, qz, qw), by
    branch-free Shepperd's method: all four candidates, the best
    conditioned one selected (the reference writes qx qy qz qw,
    src/System.cc:390)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, _EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(qx, qy, qz, qw)[..., 4] -> R[..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
