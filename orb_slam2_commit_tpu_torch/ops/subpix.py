"""Batched gradient-based subpixel corner refinement (PyTorch port of
ops/subpix.py; the kernel, K5, is csrc/subpix.cu behind kernels/subpix.py).

The reference keeps FAST corners at integer pixels
(src/ORBextractor.cc:818-946). This is the standard gradient-orthogonality
refinement (cv::cornerSubPix): the subpixel corner c solves

    sum_i w_i (g_i g_i^T) (x_i - c) = 0

over a 7x7 window, each pixel's central-difference gradient g_i being
orthogonal to (x_i - c) at a corner. Two fixed iterations re-centre the
Gaussian weights (sigma^2 = 9); offsets are clamped to +-1 px and left
where they are when the 2x2 normal matrix is near-singular (flat or edge
neighbourhoods).
"""

from __future__ import annotations

import torch

from orb_slam2_commit_tpu_torch.ops import descriptors

HALF = 3          # window radius (7x7)
ITERS = 2
MAX_OFFSET = 1.0  # trust region, px


def corner_subpix_offsets(image: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Subpixel offsets [N, 2] (dy, dx) float32 for integer corners
    yx [N, 2] (row, col). The caller adds them to the reported keypoint
    coordinates; orientation and descriptor sampling stay at the integer
    location."""
    # Window + 1 px halo so central differences cover the full window.
    win = descriptors.gather_patches(image.to(torch.float32), yx, HALF + 1)
    return offsets_from_windows(win)


def corner_subpix_from_patches(
    patches: torch.Tensor, center_y: int, center_x: int
) -> torch.Tensor:
    """The same refinement from pre-gathered per-keypoint patches
    [N, >= 2*(HALF+1)+1, ...] whose keypoint sits at (center_y, center_x):
    K5's plain version."""
    r = HALF + 1
    win = patches[:, center_y - r:center_y + r + 1, center_x - r:center_x + r + 1]
    return offsets_from_windows(win)


def offsets_from_windows(win: torch.Tensor) -> torch.Tensor:
    """Core solve on [N, S+2, S+2] windows (S = 2*HALF+1, +1 px halo for
    the central differences) -> [N, 2] (dy, dx)."""
    win = win.to(torch.float32)
    gy = 0.5 * (win[:, 2:, 1:-1] - win[:, :-2, 1:-1])    # [N, S, S]
    gx = 0.5 * (win[:, 1:-1, 2:] - win[:, 1:-1, :-2])

    s = 2 * HALF + 1
    d = torch.arange(-HALF, HALF + 1, dtype=torch.float32, device=win.device)
    px = d[None, :].expand(s, s).reshape(-1)              # x offsets
    py = d[:, None].expand(s, s).reshape(-1)              # y offsets
    gxx = (gx * gx).reshape(-1, s * s)
    gyy = (gy * gy).reshape(-1, s * s)
    gxy = (gx * gy).reshape(-1, s * s)

    n = win.shape[0]
    cy = torch.zeros(n, dtype=torch.float32, device=win.device)
    cx = torch.zeros(n, dtype=torch.float32, device=win.device)
    sigma2 = float(HALF * HALF)
    for _ in range(ITERS):
        # Gaussian weights centred at the current estimate.
        wgt = torch.exp(
            -((px[None] - cx[:, None]) ** 2 + (py[None] - cy[:, None]) ** 2)
            / (2.0 * sigma2))
        a = torch.sum(wgt * gxx, dim=1)     # Gxx
        b = torch.sum(wgt * gxy, dim=1)     # Gxy
        c = torch.sum(wgt * gyy, dim=1)     # Gyy
        bx = torch.sum(wgt * (gxx * px[None] + gxy * py[None]), dim=1)
        by = torch.sum(wgt * (gxy * px[None] + gyy * py[None]), dim=1)
        det = a * c - b * b
        ok = det > 1e-6 * torch.clamp_min(a + c, 1e-12) ** 2
        det_safe = torch.where(ok, det, torch.ones_like(det))
        nx = (c * bx - b * by) / det_safe
        ny = (a * by - b * bx) / det_safe
        cx = torch.where(ok, torch.clamp(nx, -MAX_OFFSET, MAX_OFFSET), cx)
        cy = torch.where(ok, torch.clamp(ny, -MAX_OFFSET, MAX_OFFSET), cy)
    return torch.stack([cy, cx], dim=-1)
