"""Segment sums whose float additions happen in an order fixed by the data.

`out[j] = sum of vals[o] over the rows o with idx[o] == j` is a scatter-add,
and the card's scatter-add (`index_add_`, `index_put_(accumulate=True)`)
adds with atomics, in whatever order the threads arrive: two runs of the
same problem may differ in the last bits, and through an LM's accept test
or a keyframe decision those bits can change a whole SLAM run.

Here the ids are sorted once per problem (a BA's observation -> camera and
observation -> point maps, a pose graph's edge -> vertex maps do not change
during its solve) into a padded `[n, L]` table of row numbers, each segment's
rows in ascending order; a sum gathers `vals` into that layout and adds
along it one row after another: the last entry of a running sum (`cumsum`)
along the table's rows, an axis that is not the last, which PyTorch scans
sequentially. So the result does not depend on the table's width or on
zero rows in it (on the card the additions are float32 ones in
`index_add_`'s row order; the CPU's cumsum accumulates float32 in float64).
L is the longest segment's
length rounded up to a power of two (the padded columns gather the zero
row), so that problems of nearby sizes give tables of one shape: the
tables are inputs of the solvers' CUDA graphs (utils/cuda_graph.py), which
are keyed by their inputs' shapes, and local BA's second stage sums over
its first stage's tables (a dropped row adds a zero).

The port's CPU parity tests were set on `index_add_`'s row order (the
monocular global BA of a loop closure walks along its free scale in
float32, and another order moves it past those tests' bounds). A table is
made for CUDA ids, and CPU ids keep `index_add_` unless the caller asks for
the table (`ordered=True`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Segments(NamedTuple):
    """key [O]: each row's segment, n for a row in none. gather [n, L]: the
    rows of each segment, ascending, padded with O (a zero row appended at
    the sum); None to sum with index_add_."""

    key: torch.Tensor
    n: int
    gather: Optional[torch.Tensor]


def segments(idx: torch.Tensor, n: int, include: Optional[torch.Tensor] = None,
             ordered: Optional[bool] = None) -> Segments:
    """The segments of ids idx [O] in [0, n); rows where `include` is False
    belong to none. ordered: make the table (the default for CUDA ids),
    which reads the longest segment's length on the host, once."""
    idx = idx.long()
    rows = idx.shape[0]
    key = idx if include is None else torch.where(include, idx, n)
    if not (idx.is_cuda if ordered is None else ordered):
        return Segments(key, n, None)
    order = torch.argsort(key, stable=True)
    bounds = torch.searchsorted(key[order].contiguous(),
                                torch.arange(n + 1, dtype=torch.long, device=idx.device))
    length = bounds[1:] - bounds[:-1]
    width = bucket(int(length.max())) if n else 0
    j = torch.arange(width, dtype=torch.long, device=idx.device)
    pos = (bounds[:-1, None] + j).clamp(max=max(rows - 1, 0))
    gather = torch.where(j < length[:, None], order[pos], rows)
    return Segments(key, n, gather)


def bucket(width: int) -> int:
    """A table's width: the least power of two >= width (0 for 0)."""
    return 1 << (width - 1).bit_length() if width > 0 else 0


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """out [n, ...]: out[j] = the sum of vals[o] over segment j's rows,
    added one after another in ascending row order."""
    if seg.gather is None:
        out = vals.new_zeros((seg.n + 1,) + vals.shape[1:])
        return out.index_add_(0, seg.key, vals)[:seg.n]
    n, width = seg.gather.shape
    if width == 0:
        return vals.new_zeros((seg.n,) + vals.shape[1:])
    padded = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    rows = padded[seg.gather].reshape(n, width, -1)
    return rows.cumsum(dim=1)[:, -1].reshape((n,) + vals.shape[1:])
