"""DLT triangulation, batched (PyTorch port of geometry/triangulation.py;
Initializer::Triangulate, src/Initializer.cc:1018-1064, and the SVD
triangulation of LocalMapping::CreateNewMapPoints,
src/LocalMapping.cc:420-438). One batched 4x4 symmetric eigensolve per
point (optim/linalg.eigh). Leading batch dimensions broadcast.
"""

from __future__ import annotations

import torch

from orb_slam2_commit_tpu_torch.optim import linalg


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], [3, 4]."""
    return K @ torch.cat([R, t[:, None]], dim=1)


def triangulate_dlt(
    uv1: torch.Tensor, uv2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor
) -> torch.Tensor:
    """Triangulate correspondences uv1, uv2 [..., N, 2] -> world points
    [..., N, 3] under P1, P2 [..., 3, 4].

    Rows of A per the reference (src/Initializer.cc:1028-1060):
    x * P[2] - P[0], y * P[2] - P[1] for both views; the solution is the
    eigenvector of A^T A with the smallest eigenvalue, dehomogenized."""
    _, V = linalg.eigh(dlt_normal_matrices(uv1, uv2, P1, P2))
    return dlt_points(V)


def dlt_normal_matrices(
    uv1: torch.Tensor, uv2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor
) -> torch.Tensor:
    """triangulate_dlt's A^T A [..., N, 4, 4], before its eigensolve."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    A = torch.stack([
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                            # [..., N, 4, 4]
    return A.transpose(-1, -2) @ A


def dlt_points(V: torch.Tensor) -> torch.Tensor:
    """World points [..., N, 3] from the eigenvectors V [..., N, 4, 4] of
    triangulate_dlt's A^T A (ascending eigenvalues): the first,
    dehomogenized."""
    x = V[..., :, 0]
    w = torch.where(torch.abs(x[..., 3]) > 1e-12, x[..., 3],
                    torch.full_like(x[..., 3], 1e-12))
    return x[..., :3] / w[..., None]


def reprojection_error_sq(
    points: torch.Tensor, uv: torch.Tensor, P: torch.Tensor
) -> torch.Tensor:
    """Squared pixel reprojection error of world points [..., N, 3] under
    P [..., 3, 4]."""
    ph = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    proj = ph @ P.transpose(-1, -2)
    z = torch.where(torch.abs(proj[..., 2]) > 1e-12, proj[..., 2],
                    torch.full_like(proj[..., 2], 1e-12))
    du = proj[..., 0] / z - uv[..., 0]
    dv = proj[..., 1] / z - uv[..., 1]
    return du * du + dv * dv


def depths(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """z coordinate of world points in the camera frame (R, t)."""
    return points @ R[2] + t[2]


def cos_parallax(points: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Cosine of the ray angle between camera centres c1, c2 and each point
    (src/Initializer.cc:1199-1211)."""
    r1 = points - c1[None]
    r2 = points - c2[None]
    n1 = torch.linalg.norm(r1, dim=1)
    n2 = torch.linalg.norm(r2, dim=1)
    return torch.sum(r1 * r2, dim=1) / torch.clamp_min(n1 * n2, 1e-12)
