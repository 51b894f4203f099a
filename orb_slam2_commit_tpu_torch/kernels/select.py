"""K3 cell_topk: exact per-cell top-k, with its plain version (PyTorch port
of ops/pallas_select.py; kernel in csrc/select.cu).

Two entry points share the kernel: `cell_topk_map` reads the score map in
place, one row per scoring cell (the main path's call), and `cell_topk`
takes the [C, S] matrix of those rows that `cell_matrix` lays out.

On a CUDA tensor a wrapper launches the kernel; on a CPU tensor it runs
the plain version. Both give the same values and indices.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import fast

LANE = 128        # rows are padded with -inf to a multiple of this
MAX_ROW = 1024    # the kernel holds a row in registers: 32 entries a lane


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cell_matrix(score: torch.Tensor, cell_size: int) -> torch.Tensor:
    """[n_cells, cell_size**2] rows of the score map's cells in raster
    order (the width zero-padded to whole cells); entry i of a row is
    pixel (i // cell_size, i % cell_size) of its cell."""
    hc, w = score.shape
    if hc % cell_size:
        raise ValueError("score rows must be a multiple of the cell size")
    wp = _round_up(w, cell_size)
    sp = F.pad(score, (0, wp - w))
    n_cy, n_cx = hc // cell_size, wp // cell_size
    cells = sp.reshape(n_cy, cell_size, n_cx, cell_size).permute(0, 2, 1, 3)
    return cells.reshape(n_cy * n_cx, cell_size * cell_size).contiguous()


def cell_topk_plain(cells: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: -inf padding to LANE columns, then k rounds of
    (max, lowest index holding it, mask)."""
    s = cells.shape[1]
    x = F.pad(cells, (0, _round_up(s, LANE) - s), value=float("-inf"))
    return fast.topk_iterative(x, k)


def cell_topk_map_plain(
    score: torch.Tensor, cell_size: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the map form: the cell matrix, then K3's plain
    version."""
    return cell_topk_plain(cell_matrix(score, cell_size), k)


def _check_k(name: str, k: int) -> None:
    if not 1 <= k <= LANE:
        raise ValueError(f"{name}: k={k} outside [1, {LANE}]")


def _check_row(name: str, s: int) -> None:
    if s > MAX_ROW:
        raise ValueError(f"{name}: rows of {s} entries, more than the kernel's {MAX_ROW}")


def cell_topk(cells: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cells [C, S] float32 -> (vals [C, k] float32, args [C, k] int32):
    per-row top-k, values descending, ties to the lowest index (as
    lax.top_k). With fewer than k finite entries a row's remaining slots
    hold -inf at the lowest index holding -inf, as the Pallas kernel."""
    _build.require(cells, "cell_topk", torch.float32, 2)
    c, s = cells.shape
    _check_k("cell_topk", k)
    if not _build.on_card(cells, "cell_topk"):
        return cell_topk_plain(cells, k)
    _check_row("cell_topk", s)
    vals = torch.empty((c, k), dtype=torch.float32, device=cells.device)
    args = torch.empty((c, k), dtype=torch.int32, device=cells.device)
    if c:
        err = _build.library("select").cell_topk_launch(
            cells.data_ptr(), c, s, _round_up(s, LANE), k, vals.data_ptr(),
            args.data_ptr(), _build.stream_of(cells))
        _build.check(err, "cell_topk")
        _build.count_launch("cell_topk")
    return vals, args


def cell_topk_map(
    score: torch.Tensor, cell_size: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """score [hc, W] float32, hc a multiple of cell_size -> per-cell top-k
    (vals [C, k] float32, args [C, k] int32), C = (hc / cell_size) *
    ceil(W / cell_size) cells in raster order: `cell_topk` of
    `cell_matrix(score, cell_size)`, read from the map in place."""
    _build.require(score, "cell_topk_map", torch.float32, 2)
    hc, w = score.shape
    if hc % cell_size:
        raise ValueError("cell_topk_map: score rows must be a multiple of the cell size")
    _check_k("cell_topk_map", k)
    if not _build.on_card(score, "cell_topk_map"):
        return cell_topk_map_plain(score, cell_size, k)
    _check_row("cell_topk_map", cell_size * cell_size)
    c = (hc // cell_size) * (-(-w // cell_size))
    vals = torch.empty((c, k), dtype=torch.float32, device=score.device)
    args = torch.empty((c, k), dtype=torch.int32, device=score.device)
    if c:
        err = _build.library("select").cell_topk_map_launch(
            score.data_ptr(), hc, w, cell_size, k, vals.data_ptr(), args.data_ptr(),
            _build.stream_of(score))
        _build.check(err, "cell_topk_map")
        _build.count_launch("cell_topk_map")
    return vals, args
