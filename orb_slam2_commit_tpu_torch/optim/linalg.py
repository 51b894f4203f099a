"""Small dense SPD solves (PyTorch port of optim/linalg.py), and batched
eigensolves and SVDs of small matrices.

`chol_solve_spd` is batched over all leading axes, in two library calls:
the Cholesky factor and the two triangular solves. `cholesky_ex` reports
a failed factor in its `info` tensor instead of raising, so nothing waits
on the device.

`eigh` and `svd` are torch.linalg's, taken LINALG_CHUNK matrices at a
time: cuSOLVER's batched symmetric eigensolver rejects larger batches of
small matrices (CUSOLVER_STATUS_INVALID_VALUE from
cusolverDnXsyevBatched_bufferSize at 32768 4x4, 9x9 and 12x12 matrices,
not at 8000, on an H100 with CUDA 12.8), and the monocular mapper
triangulates 32 x 2000 points at once. Each matrix's result is the same
either way.
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


LINALG_CHUNK = 8192


def _in_chunks(fn, A: torch.Tensor):
    """fn over A[..., m, n] at most LINALG_CHUNK matrices at a time -> the
    tuple of fn's outputs with A's leading axes."""
    lead = A.shape[:-2]
    flat = A.reshape((-1,) + tuple(A.shape[-2:]))
    if flat.shape[0] <= LINALG_CHUNK:
        return tuple(fn(A))
    outs = [tuple(fn(c)) for c in flat.split(LINALG_CHUNK)]
    return tuple(torch.cat(parts).reshape(lead + parts[0].shape[1:]) for parts in zip(*outs))


def eigh(A: torch.Tensor):
    """torch.linalg.eigh in chunks -> (ascending eigenvalues, eigenvectors)."""
    return _in_chunks(torch.linalg.eigh, A)


def svd(A: torch.Tensor):
    """torch.linalg.svd (reduced) in chunks -> (U, S, Vh)."""
    return _in_chunks(lambda a: torch.linalg.svd(a, full_matrices=False), A)
