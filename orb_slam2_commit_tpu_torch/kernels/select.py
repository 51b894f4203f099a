"""K3 cell_topk: exact per-row top-k, with its plain version (PyTorch port
of ops/pallas_select.py; kernel in csrc/select.cu).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
the plain version. Both give the same values and indices.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import fast

LANE = 128        # rows are padded with -inf to a multiple of this
WARPS = 4         # rows per block of the kernel
MAX_SMEM = 227 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cell_topk_plain(cells: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: -inf padding to LANE columns, then k rounds of
    (max, lowest index holding it, mask)."""
    s = cells.shape[1]
    x = F.pad(cells, (0, _round_up(s, LANE) - s), value=float("-inf"))
    return fast.topk_iterative(x, k)


def cell_topk(cells: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cells [C, S] float32 -> (vals [C, k] float32, args [C, k] int32):
    per-row top-k, values descending, ties to the lowest index (as
    lax.top_k). With fewer than k finite entries a row's remaining slots
    hold -inf at the lowest index holding -inf, as the Pallas kernel."""
    _build.require(cells, "cell_topk", torch.float32, 2)
    c, s = cells.shape
    s_pad = _round_up(s, LANE)
    if not 1 <= k <= LANE:
        raise ValueError(f"cell_topk: k={k} outside [1, {LANE}]")
    if not _build.on_card(cells, "cell_topk"):
        return cell_topk_plain(cells, k)
    if WARPS * s_pad * 4 > MAX_SMEM:
        raise ValueError(f"cell_topk: rows of {s} do not fit shared memory")
    lib = _build.library("select")
    vals = torch.empty((c, k), dtype=torch.float32, device=cells.device)
    args = torch.empty((c, k), dtype=torch.int32, device=cells.device)
    if c:
        err = lib.cell_topk_launch(
            cells.data_ptr(), c, s, s_pad, k, vals.data_ptr(), args.data_ptr(),
            _build.stream_of(cells))
        _build.check(err, "cell_topk")
        _build.launches["cell_topk"] += 1
    return vals, args
