"""Segment sums whose float additions happen in an order fixed by the data.

`out[j] = sum of vals[o] over the rows o with idx[o] == j` is a scatter-add,
and the card's scatter-add (`index_add_`, `index_put_(accumulate=True)`)
adds with atomics, in whatever order the threads arrive: two runs of the
same problem may differ in the last bits, and through an LM's accept test
or a keyframe decision those bits can change a whole SLAM run.

Here the ids are sorted once per problem (a BA's observation -> camera and
observation -> point maps, a pose graph's edge -> vertex maps do not change
during its solve) into a padded `[n, L]` table of row numbers, each segment's
rows in ascending order; a sum gathers `vals` into that layout and reduces
along it, which PyTorch does in a fixed order.

The CPU's `index_add_` already adds in row order, one row after another,
and the port's CPU parity tests were set on that order: the monocular
global BA of a loop closure walks along its free scale in float32, and a
new summation order moves it past those tests' bounds. So a table is made
for CUDA ids, and CPU ids keep `index_add_` unless the caller asks for the
table (`ordered=True`).
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
    width = int(length.max()) if n else 0
    j = torch.arange(width, dtype=torch.long, device=idx.device)
    pos = (bounds[:-1, None] + j).clamp(max=max(rows - 1, 0))
    gather = torch.where(j < length[:, None], order[pos], rows)
    return Segments(key, n, gather)


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """out [n, ...]: out[j] = the sum of vals[o] over segment j's rows."""
    if seg.gather is None:
        out = vals.new_zeros((seg.n + 1,) + vals.shape[1:])
        return out.index_add_(0, seg.key, vals)[:seg.n]
    padded = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    return padded[seg.gather].sum(dim=1)
