"""Reprojection residuals + analytic Jacobians (PyTorch port of
optim/residuals.py).

Conventions as in the JAX package (and g2o's edge types): Tcw = (R, t),
P_cam = R @ X_world + t; residual e = observed - projected; pose tangent
[omega, upsilon] applied as T <- exp(delta) * T. Mono observations embed as
(u, v, 0) with a zero third-row weight, stereo as (u_l, v, u_r). Robust
loss: Huber with per-observation delta (sqrt(5.991) mono, sqrt(7.815)
stereo; reference src/Optimizer.cc:96-97,434-439).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAObservations(NamedTuple):
    """Flat observation table (padded, masked).

    cam_idx   [O] int32 — index into the pose arrays
    pt_idx    [O] int32 — index into the point array
    uvr       [O, 3] float — (u, v, u_right); u_right ignored for mono
    inv_sigma2[O] float — per-observation information (octave-scaled)
    is_stereo [O] bool
    valid     [O] bool
    """

    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uvr: torch.Tensor
    inv_sigma2: torch.Tensor
    is_stereo: torch.Tensor
    valid: torch.Tensor


def project_with_jacobians(
    R: torch.Tensor,
    t: torch.Tensor,
    X: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched projection + Jacobians; R [O, 3, 3], t [O, 3], X [O, 3].

    Returns pred [O, 3] (u, v, u_r), J_pose [O, 3, 6] (d e / d [omega,
    upsilon]), J_point [O, 3, 3] (d e / d X_world), z [O] (camera depth)."""
    P = torch.einsum("oij,oj->oi", R, X) + t
    x, y, z = P[:, 0], P[:, 1], P[:, 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    pred = torch.stack([u, v, ur], dim=-1)

    zero = torch.zeros_like(x)
    A = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
            torch.stack(
                [fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2], dim=-1
            ),
        ],
        dim=-2,
    )  # [O, 3, 3]

    # dP/d_omega = -hat(P); dP/d_upsilon = I.
    hatP = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    # e = obs - pred  =>  J = -A @ dP/d(delta).
    J_omega = A @ hatP
    J_upsilon = -A
    J_pose = torch.cat([J_omega, J_upsilon], dim=-1)        # [O, 3, 6]
    J_point = -torch.einsum("oab,obc->oac", A, R)           # [O, 3, 3]
    return pred, J_pose, J_point, z


def residuals_and_weights(
    pred: torch.Tensor,
    z: torch.Tensor,
    obs: BAObservations,
    use_robust: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual e [O, 3], per-row weights [O, 3], chi2 [O].

    chi2 = inv_sigma2 * ||e||^2 over the active rows (2 mono, 3 stereo);
    the weight folds information and Huber: w = inv_sigma2 * rho'. Rows
    behind the camera get weight 0."""
    e = obs.uvr - pred
    row_mask = torch.stack(
        [torch.ones_like(z), torch.ones_like(z), obs.is_stereo.to(z.dtype)],
        dim=-1,
    )
    e = e * row_mask
    chi2 = obs.inv_sigma2 * torch.sum(e * e, dim=-1)

    delta2 = torch.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO).to(z.dtype)
    # Huber on the chi2 statistic: rho' = min(1, delta/sqrt(chi2)).
    sqrt_chi2 = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    huber = torch.clamp_max(torch.sqrt(delta2) / sqrt_chi2, 1.0)
    if not use_robust:
        huber = torch.ones_like(huber)

    w = obs.inv_sigma2 * huber
    w = torch.where(obs.valid & (z > 0), w, torch.zeros_like(w))
    weights = w[:, None] * row_mask
    return e, weights, chi2
