"""SO3 / SE3 exponential maps (PyTorch port of the parts of ops/lie.py the
pose-only optimizer needs).

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
