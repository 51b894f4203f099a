"""SO3 / SE3 / Sim3 manifold operations (PyTorch port of ops/lie.py).

Conventions as in the JAX package: rotations are 3x3 matrices, rigid
transforms (R, t) act as x_cam = R @ x_world + t, se3 tangent vectors
are [omega(3), upsilon(3)] (g2o's SE3Quat::exp ordering), similarities
(s, R, t) act as x -> s R x + t with sim3 tangent vectors
[omega(3), upsilon(3), sigma(1)]. Leading dimensions broadcast.
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


# ---------------------------------------------------------------------------
# Sim3 (g2o's types/sim3.h), used by loop closing: (s, R, t), x -> s R x + t.
# ---------------------------------------------------------------------------


def sim3_apply(s, R, t, x) -> torch.Tensor:
    return s[..., None] * torch.einsum("...ij,...j->...i", R, x) + t


def sim3_inverse(s, R, t) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa, Ra, ta) * (sb, Rb, tb): apply b first."""
    return sa * sb, Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta


def _sim3_w_matrix(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The sim3 V matrix, t = V upsilon for exp([omega, upsilon, sigma]):
    V = C I + A hat(w) + B hat(w)^2 with (s = e^sigma, theta = |w|,
    a = s sin theta, b = s cos theta, c = sigma^2 + theta^2)
      C = (s - 1) / sigma
      A = (a sigma + (1 - b) theta) / (theta c)
      B = (C - ((b - 1) sigma + a theta) / c) / theta^2
    and the JAX package's Taylor-safe limits for small sigma and theta."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    sig2 = sigma * sigma
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a = s * sin_t
    b = s * cos_t
    c = sig2 + theta2

    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta2 < 1e-8

    C = torch.where(small_sigma, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / (sigma + _EPS))
    a_gen = (a * sigma + (1.0 - b) * theta) / (theta * c + _EPS)
    b_gen = (C - ((b - 1.0) * sigma + a * theta) / (c + _EPS)) / (theta2 + _EPS)
    # sigma -> 0: the SE3 left Jacobian's coefficients.
    a_sig0 = (1.0 - cos_t) / (theta2 + _EPS)
    b_sig0 = (theta - sin_t) / (theta2 * theta + _EPS)
    # theta -> 0, sigma != 0.
    a_th0 = torch.where(small_sigma, 0.5 + sigma / 3.0,
                        (s * (sigma - 1.0) + 1.0) / (sig2 + _EPS))
    b_th0 = torch.where(small_sigma, 1.0 / 6.0 + sigma / 8.0,
                        (s * (sig2 - 2.0 * sigma + 2.0) - 2.0) / (2.0 * sig2 * sigma + _EPS))

    A = torch.where(small_theta, a_th0, torch.where(small_sigma, a_sig0, a_gen))
    B = torch.where(small_theta, b_th0, torch.where(small_sigma, b_sig0, b_gen))
    W = hat(w)
    W2 = W @ W
    return C[..., None, None] * _eye_like(W) + A[..., None, None] * W + B[..., None, None] * W2


def sim3_exp(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """exp of the sim3 tangent xi[..., 7] = [omega, upsilon, sigma] -> (s, R, t)."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    V = _sim3_w_matrix(w, sigma)
    return torch.exp(sigma), so3_exp(w), torch.einsum("...ij,...j->...i", V, v)


def sim3_log(s, R, t) -> torch.Tensor:
    """log of (s, R, t) -> xi[..., 7] = [omega, upsilon, sigma]."""
    w = so3_log(R)
    sigma = torch.log(s)
    V = _sim3_w_matrix(w, sigma)
    # solve_ex, not solve: solve checks the result on the host, which a
    # CUDA graph capture refuses (the pose graph's, optim/pose_graph.py);
    # a singular V gives NaN, as the JAX package's solve gives a
    # non-finite result.
    v, info = torch.linalg.solve_ex(V, t[..., None])
    v = torch.where((info == 0)[..., None, None], v, torch.nan)[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)
