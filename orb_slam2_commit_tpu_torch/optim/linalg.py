"""Small dense SPD solves (PyTorch port of optim/linalg.py).

Batched over all leading axes, in two library calls: the Cholesky factor
and the two triangular solves. `cholesky_ex` reports a failed factor in
its `info` tensor instead of raising, so nothing waits on the device.
"""

from __future__ import annotations

import torch


def chol_solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H[..., n, n], b[..., n].

    Where H is not positive definite the factor fails and x is NaN; the
    pose LM rejects such a step explicitly (optim/pose_opt.py)."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x, torch.nan)
