"""Hamming top-2 per row, with plain versions (PyTorch port of
ops/pallas_matching.py; kernels in csrc/matching.cu):

- K6 projection_hamming_top2: windowed, octave-banded top-2 per projected
  map point, in one window or in two from one scan;
- K7 stereo_band_top2: top-2 under the stereo matcher's candidate band
  (ops/stereo.py), left -> right and right -> left in one launch that
  tests the band itself;
- K7 under a candidate test, one kernel with the test compiled in:
  - masked_hamming_top2: a caller-supplied [M, N] candidate mask, the
    exact counterpart of the Pallas kernel (no caller on the main paths);
  - valid_hamming_top2: row flags x column flags (match_brute_force:
    reference-keyframe tracking, relocalization over candidate keyframes,
    loop closing over its candidates);
  - window_hamming_top2: flags and a square window (monocular
    initialization's match_for_initialization);
  - epipolar_hamming_top2: flags and the epipolar band (the mapper's
    match_for_triangulation).
  The last three build no [M, N] mask on the card; each plain version
  builds its caller's mask and takes masked_hamming_top2's.

K6 and K7 under a test also take a leading batch axis: one launch serves
B problems (the mapper's fuse pass into B target keyframes, its
triangulation matcher over B neighbour pairs, relocalization's and loop
closing's matchers over B candidate keyframes) and counts as one launch;
a single problem is a batch of one.

On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs
the plain version. Both give the same four outputs, the Pallas kernels'
index fallbacks included.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import matching
from orb_slam2_commit_tpu_torch.ops.matching import BIG_DIST
from orb_slam2_commit_tpu_torch.utils.precision import full_float32

COL_BITS = 23     # the kernel's packed key holds the column in 23 bits
# K7's candidate tests (csrc/matching.cu, Test) and the bits that mark a
# table with a batch axis (Batched).
T_MASK, T_FLAGS, T_WINDOW, T_EPIPOLAR = range(4)
BATCHED = dict(desc_a=1, row_ok=2, row_v=4, den=8, desc_b=16, col_ok=32, col_xy=64, thr=128)

Top2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _top2_rows(d: torch.Tensor) -> Top2:
    """The Pallas kernels' _top2_reduce over the rows of d [K, N] (BIG
    where no candidate): ties to the lowest column, the best column
    dropped below every other for the second."""
    best_idx = matching._first_argmin(d)
    best = d.amin(dim=-1)
    cols = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device)
    d2 = torch.where(cols == best_idx[..., None], torch.full_like(d, BIG_DIST + 1), d)
    return best, best_idx, torch.clamp_max(d2.amin(dim=-1), BIG_DIST), matching._first_argmin(d2)


def masked_hamming_top2_plain(desc_a, desc_b, mask) -> Top2:
    """Plain version of K7, the dense route: per problem, the distance
    matrix of the rows with a candidate under the mask, then the top-2 of
    the Pallas kernels' _top2_reduce: ties to the lowest column, BIG where
    there is no candidate, and the second index the lowest column other
    than the best when the row has fewer than two candidates (a row with
    none: BIG, 0, BIG, 1). mask [..., M, N] with desc_a [..., M, 8] or
    [M, 8] and desc_b [..., N, 8] or [N, 8]."""
    lead, (m, n) = mask.shape[:-2], mask.shape[-2:]
    masks = mask.reshape(-1, m, n)
    rows_a = desc_a.reshape(-1, m, 8) if desc_a.dim() > 2 else desc_a[None]
    cols_b = desc_b.reshape(-1, n, 8) if desc_b.dim() > 2 else desc_b[None]
    dev, i32 = mask.device, torch.int32
    out = (torch.full(masks.shape[:2], BIG_DIST, dtype=i32, device=dev),
           torch.zeros(masks.shape[:2], dtype=i32, device=dev),
           torch.full(masks.shape[:2], BIG_DIST, dtype=i32, device=dev),
           torch.full(masks.shape[:2], min(1, n - 1), dtype=i32, device=dev))
    hit = masks.any(dim=-1)
    for b in range(masks.shape[0]):
        r = torch.nonzero(hit[b])[:, 0]
        if r.numel():
            a, c = rows_a[b % rows_a.shape[0]][r], cols_b[b % cols_b.shape[0]]
            d = matching.hamming_distance_matrix(a, c)
            top = _top2_rows(torch.where(masks[b, r], d, torch.full_like(d, BIG_DIST)))
            for o, t in zip(out, top):
                o[b, r] = t.to(i32)
    return tuple(o.reshape(lead + (m,)) for o in out)


def projection_hamming_top2_plain(
    desc_a, proj, radii, oct_lo, oct_hi, valid_a,
    desc_b, xy_b, octave_b, valid_b,
) -> Tuple[Top2, ...]:
    """Plain version of K6: per radius, the window and octave masks, then
    K7's plain version (leading batch dimensions broadcast)."""
    band = (
        valid_a[..., :, None]
        & valid_b[..., None, :]
        & matching.octave_band_mask(octave_b, oct_lo, oct_hi)
    )
    return tuple(
        masked_hamming_top2_plain(desc_a, desc_b, band & matching.window_mask(proj, xy_b, r))
        for r in radii)


def projection_hamming_top2(
    desc_a: torch.Tensor,     # [M, 8] int32 (uint32 bits)
    proj: torch.Tensor,       # [M, 2] float32 projected pixel (u, v)
    radii: Tuple[torch.Tensor, ...],   # one or two [M] float32 window half-sizes
    oct_lo: torch.Tensor,     # [M] int32 inclusive octave band
    oct_hi: torch.Tensor,     # [M] int32
    valid_a: torch.Tensor,    # [M] bool
    desc_b: torch.Tensor,     # [N, 8] int32
    xy_b: torch.Tensor,       # [N, 2] float32 keypoint pixels
    octave_b: torch.Tensor,   # [N] int32
    valid_b: torch.Tensor,    # [N] bool
) -> Tuple[Top2, ...]:
    """-> one (best, best_idx, second, second_idx) per window, each [M]
    int32; best and second are BIG_DIST where the row has no (second)
    candidate. Two windows per row (the motion stage's search and its
    widened retry) come from one kernel launch, exact for any two radii;
    the plain version takes each window on its own.

    B problems in one launch: every tensor but desc_a takes a leading
    batch axis ([B, M, 2], [B, N, 8], ...), desc_a is [B, M, 8] or stays
    [M, 8] (one point set shared by the problems), and each output is
    [B, M]; problem b's rows are exactly what the call on its slices
    gives."""
    name = "projection_hamming_top2"
    if not 1 <= len(radii) <= 2:
        raise ValueError(f"{name}: one or two radii, got {len(radii)}")
    k = proj.dim() - 2
    if k not in (0, 1):
        raise ValueError(f"{name}: proj [M, 2] or [B, M, 2], got {tuple(proj.shape)}")
    lead = tuple(proj.shape[:k])
    m, n = proj.shape[k], (desc_b.shape[k] if desc_b.dim() > k else 0)
    row_args = ((proj, "proj", torch.float32, 2),
                *((r, f"radii[{i}]", torch.float32, 1) for i, r in enumerate(radii)),
                (oct_lo, "oct_lo", torch.int32, 1), (oct_hi, "oct_hi", torch.int32, 1),
                (valid_a, "valid_a", torch.bool, 1))
    col_args = ((desc_b, "desc_b", torch.int32, 2), (xy_b, "xy_b", torch.float32, 2),
                (octave_b, "octave_b", torch.int32, 1), (valid_b, "valid_b", torch.bool, 1))
    for args, rows in ((row_args, m), (col_args, n)):
        for t, what, dtype, ndim in args:
            _build.require(t, f"{name} {what}", dtype, ndim + k)
            if tuple(t.shape[:k + 1]) != lead + (rows,) or t.device != desc_a.device:
                raise ValueError(
                    f"{name} {what}: shape {tuple(t.shape)} on {t.device}, "
                    f"expected {lead + (rows,)} leading on {desc_a.device}")
    _build.require(desc_a, f"{name} desc_a", torch.int32, 2 if desc_a.dim() == 2 else 2 + k)
    bsz = lead[0] if lead else 1
    if tuple(desc_a.shape) not in ((m, 8), lead + (m, 8)) or desc_b.shape[-1] != 8 \
            or proj.shape[-1] != 2 or xy_b.shape[-1] != 2 \
            or not 1 <= n < (1 << COL_BITS) or not 1 <= bsz < (1 << 16):
        raise ValueError(
            f"{name}: descriptors {tuple(desc_a.shape)} x {tuple(desc_b.shape)}, "
            f"proj {tuple(proj.shape)}, xy {tuple(xy_b.shape)}")
    if not _build.on_card(desc_a, name):
        return projection_hamming_top2_plain(
            desc_a, proj, radii, oct_lo, oct_hi, valid_a,
            desc_b, xy_b, octave_b, valid_b)
    # The kernel reads desc_b 16 bytes and proj, xy_b 8 bytes at a time.
    desc_b, proj, xy_b = (_build.aligned(t) for t in (desc_b, proj, xy_b))
    out = torch.empty((bsz, len(radii), 4, m), dtype=torch.int32, device=desc_a.device)
    if m:
        err = _build.library("matching").projection_top2_launch(
            desc_a.data_ptr(), m * 8 if desc_a.dim() == 3 else 0, proj.data_ptr(),
            radii[0].data_ptr(), radii[1].data_ptr() if len(radii) == 2 else None,
            oct_lo.data_ptr(), oct_hi.data_ptr(), valid_a.data_ptr(), m,
            desc_b.data_ptr(), xy_b.data_ptr(), octave_b.data_ptr(),
            valid_b.data_ptr(), n, bsz, out.data_ptr(), _build.stream_of(desc_a))
        _build.check(err, name)
        _build.count_launch(name)
    out = out.reshape(lead + (len(radii), 4, m)).movedim(-3, 0)
    return tuple(tuple(o.unbind(-2)) for o in out)


def stereo_band_mask(xy_l, octave_l, scale_l, valid_l, xy_r, octave_r, valid_r,
                     max_d: float) -> torch.Tensor:
    """The stereo matcher's [N_l, N_r] candidate mask (JAX ops/stereo.py
    stereo_match): both keypoints valid, |y_l - y_r| <= 2 scale_l, octave_r
    within octave_l +- 1, and -2 <= x_l - x_r <= max_d, in float32."""
    row_band = torch.abs(xy_l[:, 1:2] - xy_r[None, :, 1]) <= (2.0 * scale_l)[:, None]
    octave_band = matching.octave_band_mask(octave_r, octave_l - 1, octave_l + 1)
    disp = xy_l[:, 0:1] - xy_r[None, :, 0]
    disp_ok = (disp >= -2.0) & (disp <= max_d)
    return valid_l[:, None] & valid_r[None, :] & row_band & octave_band & disp_ok


def stereo_band_top2_plain(
    desc_l, xy_l, octave_l, scale_l, valid_l, desc_r, xy_r, octave_r, valid_r,
    max_d: float, top2=masked_hamming_top2_plain,
) -> Tuple[Top2, Top2]:
    """Plain version of K7 on the stereo band: the mask, then `top2` left
    -> right and right -> left on the transposed mask."""
    mask = stereo_band_mask(xy_l, octave_l, scale_l, valid_l, xy_r, octave_r, valid_r,
                            max_d)
    return top2(desc_l, desc_r, mask), top2(desc_r, desc_l, mask.t().contiguous())


def stereo_band_top2(
    desc_l: torch.Tensor,     # [N_l, 8] int32 (uint32 bits)
    xy_l: torch.Tensor,       # [N_l, 2] float32 keypoint pixels (x, y)
    octave_l: torch.Tensor,   # [N_l] int32
    scale_l: torch.Tensor,    # [N_l] float32 scale factor of each left octave
    valid_l: torch.Tensor,    # [N_l] bool
    desc_r: torch.Tensor,     # [N_r, 8] int32
    xy_r: torch.Tensor,       # [N_r, 2] float32
    octave_r: torch.Tensor,   # [N_r] int32
    valid_r: torch.Tensor,    # [N_r] bool
    max_d: float,             # largest disparity, compared in float32
) -> Tuple[Top2, Top2]:
    """K7 on the stereo matcher's candidate band -> (left -> right top-2
    over [N_l] rows, right -> left top-2 over [N_r] rows), each
    (best, best_idx, second, second_idx) int32 as `masked_hamming_top2`
    gives it under `stereo_band_mask` and under its transpose. On the card
    one launch tests the band itself, so no [N_l, N_r] mask exists; on the
    CPU the mask goes through `masked_hamming_top2` twice."""
    nl, nr = desc_l.shape[0], desc_r.shape[0]
    for args, rows in (((desc_l, "desc_l", torch.int32, 2), (xy_l, "xy_l", torch.float32, 2),
                        (octave_l, "octave_l", torch.int32, 1),
                        (scale_l, "scale_l", torch.float32, 1),
                        (valid_l, "valid_l", torch.bool, 1)), nl), \
                      (((desc_r, "desc_r", torch.int32, 2), (xy_r, "xy_r", torch.float32, 2),
                        (octave_r, "octave_r", torch.int32, 1),
                        (valid_r, "valid_r", torch.bool, 1)), nr):
        for t, name, dtype, ndim in args:
            _build.require(t, f"stereo_band_top2 {name}", dtype, ndim)
            if t.shape[0] != rows or t.device != desc_l.device:
                raise ValueError(
                    f"stereo_band_top2 {name}: shape {tuple(t.shape)} on {t.device}, "
                    f"expected {rows} rows on {desc_l.device}")
    if desc_l.shape[1] != 8 or desc_r.shape[1] != 8 or xy_l.shape[1] != 2 \
            or xy_r.shape[1] != 2 or not 1 <= nl < (1 << COL_BITS) \
            or not 1 <= nr < (1 << COL_BITS):
        raise ValueError(
            f"stereo_band_top2: descriptors {tuple(desc_l.shape)} x {tuple(desc_r.shape)}, "
            f"xy {tuple(xy_l.shape)} x {tuple(xy_r.shape)}")
    if not _build.on_card(desc_l, "stereo_band_top2"):
        # masked_hamming_top2 takes its plain version on the CPU.
        return stereo_band_top2_plain(desc_l, xy_l, octave_l, scale_l, valid_l, desc_r,
                                      xy_r, octave_r, valid_r, max_d,
                                      top2=masked_hamming_top2)
    # The kernel reads descriptors 16 bytes and positions 8 bytes at a time.
    desc_l, desc_r, xy_l, xy_r = (_build.aligned(t) for t in (desc_l, desc_r, xy_l, xy_r))
    out = torch.empty((4, nl + nr), dtype=torch.int32, device=desc_l.device)
    # PyTorch compares a float32 tensor with a Python float in float32: the
    # kernel gets that float32 value (ctypes rounds the double to nearest).
    err = _build.library("matching").stereo_band_top2_launch(
        desc_l.data_ptr(), xy_l.data_ptr(), octave_l.data_ptr(), scale_l.data_ptr(),
        valid_l.data_ptr(), nl, desc_r.data_ptr(), xy_r.data_ptr(), octave_r.data_ptr(),
        valid_r.data_ptr(), nr, max_d, out.data_ptr(), _build.stream_of(desc_l))
    _build.check(err, "stereo_band_top2")
    _build.count_launch("stereo_band_top2")
    return tuple(out[:, :nl]), tuple(out[:, nl:])


def masked_hamming_top2(
    desc_a: torch.Tensor,     # [M, 8] int32 (uint32 bits)
    desc_b: torch.Tensor,     # [N, 8] int32
    mask: torch.Tensor,       # [M, N] bool candidate pairs
) -> Top2:
    """-> (best, best_idx, second, second_idx), each [M] int32; best and
    second are BIG_DIST where the row has no (second) candidate, and a row
    with no candidate has best_idx 0, as jnp.argmin gives over a BIG row.

    B problems in one launch: mask [B, M, N], desc_a [B, M, 8] or [M, 8]
    and desc_b [B, N, 8] or [N, 8] (a [M, 8] or [N, 8] table is shared by
    the problems: one keyframe's descriptors against its neighbours, or
    relocalization's candidate keyframes against one frame), each output
    [B, M]; problem b's rows are exactly what the call on its slices
    gives."""
    name = "masked_hamming_top2"
    k = mask.dim() - 2
    if k not in (0, 1):
        raise ValueError(f"{name}: mask [M, N] or [B, M, N], got {tuple(mask.shape)}")
    for t, what, dtype, ndim in ((desc_a, "desc_a", torch.int32,
                                  2 if desc_a.dim() == 2 else 2 + k),
                                 (desc_b, "desc_b", torch.int32,
                                  2 if desc_b.dim() == 2 else 2 + k),
                                 (mask, "mask", torch.bool, 2 + k)):
        _build.require(t, f"{name} {what}", dtype, ndim)
        if t.device != desc_a.device:
            raise ValueError(f"{name} {what}: on {t.device}, expected {desc_a.device}")
    lead = tuple(mask.shape[:k])
    m, n = mask.shape[k:]
    bsz = lead[0] if lead else 1
    if tuple(desc_a.shape) not in ((m, 8), lead + (m, 8)) \
            or tuple(desc_b.shape) not in ((n, 8), lead + (n, 8)) \
            or not 1 <= n < (1 << COL_BITS) or not 1 <= bsz < (1 << 16):
        raise ValueError(
            f"{name}: descriptors {tuple(desc_a.shape)} x {tuple(desc_b.shape)}, "
            f"mask {tuple(mask.shape)}")
    if not _build.on_card(desc_a, name):
        return masked_hamming_top2_plain(desc_a, desc_b, mask)
    batched = dict(desc_a=desc_a.dim() == 3, desc_b=desc_b.dim() == 3)
    return _launch(name, T_MASK, lead, m, n, batched, desc_a, desc_b, mask=mask)


def _launch(name, test, lead, m, n, batched, desc_a, desc_b, mask=None, row_ok=None,
            col_ok=None, row_v=None, den=None, col_xy=None, thr=None, radius=0.0) -> Top2:
    """One launch of K7 under `test` over the problems of `lead` (() or
    (B,)); `batched`: which tables carry the batch axis."""
    bsz = lead[0] if lead else 1
    # The kernel reads desc_b 16 bytes and col_xy 8 bytes at a time.
    desc_b = _build.aligned(desc_b)
    col_xy = None if col_xy is None else _build.aligned(col_xy)
    out = torch.empty((bsz, 4, m), dtype=torch.int32, device=desc_a.device)
    if m:
        def ptr(t):
            return None if t is None else t.data_ptr()

        bits = sum(BATCHED[k] for k, v in batched.items() if v)
        # PyTorch compares a float32 tensor with a Python float in float32:
        # the kernel gets that float32 value (ctypes rounds the double).
        err = _build.library("matching").candidate_top2_launch(
            test, ptr(desc_a), ptr(desc_b), ptr(mask), ptr(row_ok), ptr(col_ok), ptr(row_v),
            ptr(den), ptr(col_xy), ptr(thr), radius, m, n, bsz, bits, ptr(out),
            _build.stream_of(desc_a))
        _build.check(err, name)
        _build.count_launch(name)
    return tuple(out.reshape(lead + (4, m)).unbind(-2))


def _check_tables(name, desc_a, desc_b, tables):
    """The checks of a K7 wrapper with a candidate test: the descriptors
    and each (tensor, what, dtype, rows, trailing shape) of the dtype
    given, contiguous, on desc_a's device, [rows, *trailing] (shared by the
    problems) or [B, rows, *trailing] with one B for all; rows is "M" for a
    row table, "N" for a column table, "" for F12. -> (lead: () or (B,), M,
    N, {what: has a batch axis})."""
    if desc_a.dim() not in (2, 3) or desc_b.dim() not in (2, 3):
        raise ValueError(f"{name}: descriptors {tuple(desc_a.shape)} x "
                         f"{tuple(desc_b.shape)}, expected [M, 8] / [B, M, 8] and "
                         f"[N, 8] / [B, N, 8]")
    size = {"M": (desc_a.shape[-2],), "N": (desc_b.shape[-2],), "": ()}
    lead, batched = (), {}
    for t, what, dtype, rows, trail in ((desc_a, "desc_a", torch.int32, "M", (8,)),
                                        (desc_b, "desc_b", torch.int32, "N", (8,)),
                                        *tables):
        base = size[rows] + trail
        _build.require(t, f"{name} {what}", dtype, t.dim())
        if t.device != desc_a.device:
            raise ValueError(f"{name} {what}: on {t.device}, expected {desc_a.device}")
        if tuple(t.shape) == base:
            batched[what] = False
        elif t.dim() == len(base) + 1 and tuple(t.shape[1:]) == base \
                and lead in ((), tuple(t.shape[:1])):
            lead, batched[what] = tuple(t.shape[:1]), True
        else:
            raise ValueError(f"{name} {what}: shape {tuple(t.shape)}, expected {base} or "
                             f"[B, *{base}] with one B for every table")
    m, n = size["M"][0], size["N"][0]
    if not 1 <= n < (1 << COL_BITS) or not 1 <= (lead[0] if lead else 1) < (1 << 16):
        raise ValueError(f"{name}: N = {n} and B = {lead} out of range")
    return lead, m, n, batched


def _flags_mask(lead, m, n, row_ok, col_ok, test=None):
    """row_ok x col_ok (and the test's [..., M, N] mask) as [*lead, M, N]."""
    mask = row_ok[..., :, None] & col_ok[..., None, :]
    if test is not None:
        mask = mask & test
    return mask.expand(lead + (m, n))


def _lead(*tensors_and_ranks):
    """The batch shape, () or (B,), of (tensor, rank without a batch axis)
    pairs."""
    for t, rank in tensors_and_ranks:
        if t.dim() > rank:
            return tuple(t.shape[:1])
    return ()


def valid_candidate_mask(desc_a, desc_b, row_ok, col_ok) -> torch.Tensor:
    """match_brute_force's [*lead, M, N] validity mask."""
    lead = _lead((desc_a, 2), (desc_b, 2), (row_ok, 1), (col_ok, 1))
    return _flags_mask(lead, desc_a.shape[-2], desc_b.shape[-2], row_ok, col_ok)


def valid_hamming_top2_plain(desc_a, desc_b, row_ok, col_ok) -> Top2:
    """Plain version of K7 under row x column flags: match_brute_force's
    validity mask, then masked_hamming_top2_plain."""
    return masked_hamming_top2_plain(
        desc_a, desc_b, valid_candidate_mask(desc_a, desc_b, row_ok, col_ok))


def valid_hamming_top2(
    desc_a: torch.Tensor,     # [M, 8] or [B, M, 8] int32 (uint32 bits)
    desc_b: torch.Tensor,     # [N, 8] or [B, N, 8] int32
    row_ok: torch.Tensor,     # [M] or [B, M] bool
    col_ok: torch.Tensor,     # [N] or [B, N] bool
) -> Top2:
    """K7 over the pairs whose row and column flags are both set ->
    (best, best_idx, second, second_idx), each [M] or [B, M] int32, as
    masked_hamming_top2 gives them under row_ok[:, None] & col_ok[None, :].
    Any table may carry the batch axis; one without it is shared by the B
    problems. On the card the flags are tested in the kernel: no [B, M, N]
    mask exists."""
    name = "valid_hamming_top2"
    lead, m, n, batched = _check_tables(name, desc_a, desc_b, (
        (row_ok, "row_ok", torch.bool, "M", ()), (col_ok, "col_ok", torch.bool, "N", ())))
    if not _build.on_card(desc_a, name):
        return valid_hamming_top2_plain(desc_a, desc_b, row_ok, col_ok)
    return _launch(name, T_FLAGS, lead, m, n, batched, desc_a, desc_b, row_ok=row_ok,
                   col_ok=col_ok)


def window_candidate_mask(desc_a, desc_b, row_ok, col_ok, xy_a, xy_b,
                          radius: float) -> torch.Tensor:
    """match_for_initialization's [*lead, M, N] mask: the flags, then
    window_mask."""
    lead = _lead((desc_a, 2), (desc_b, 2), (row_ok, 1), (col_ok, 1), (xy_a, 2), (xy_b, 2))
    return _flags_mask(lead, desc_a.shape[-2], desc_b.shape[-2], row_ok, col_ok,
                       matching.window_mask(xy_a, xy_b, radius))


def window_hamming_top2_plain(desc_a, desc_b, row_ok, col_ok, xy_a, xy_b,
                              radius: float) -> Top2:
    """Plain version of K7 under flags and a square window:
    window_candidate_mask, then masked_hamming_top2_plain."""
    return masked_hamming_top2_plain(desc_a, desc_b, window_candidate_mask(
        desc_a, desc_b, row_ok, col_ok, xy_a, xy_b, radius))


def window_hamming_top2(
    desc_a: torch.Tensor,     # [M, 8] or [B, M, 8] int32 (uint32 bits)
    desc_b: torch.Tensor,     # [N, 8] or [B, N, 8] int32
    row_ok: torch.Tensor,     # [M] or [B, M] bool
    col_ok: torch.Tensor,     # [N] or [B, N] bool
    xy_a: torch.Tensor,       # [M, 2] or [B, M, 2] float32 pixels
    xy_b: torch.Tensor,       # [N, 2] or [B, N, 2] float32
    radius: float,            # the window's half size, compared in float32
) -> Top2:
    """K7 over the pairs with both flags set and |x_a - x_b| <= radius,
    |y_a - y_b| <= radius (float32) -> the four [M] or [B, M] outputs of
    masked_hamming_top2 under that mask. Batch axes as valid_hamming_top2;
    on the card no [B, M, N] mask exists."""
    name = "window_hamming_top2"
    lead, m, n, batched = _check_tables(name, desc_a, desc_b, (
        (row_ok, "row_ok", torch.bool, "M", ()), (col_ok, "col_ok", torch.bool, "N", ()),
        (xy_a, "xy_a", torch.float32, "M", (2,)), (xy_b, "xy_b", torch.float32, "N", (2,))))
    if not _build.on_card(desc_a, name):
        return window_hamming_top2_plain(desc_a, desc_b, row_ok, col_ok, xy_a, xy_b, radius)
    batched["row_v"], batched["col_xy"] = batched.pop("xy_a"), batched.pop("xy_b")
    return _launch(name, T_WINDOW, lead, m, n, batched, desc_a, desc_b, row_ok=row_ok,
                   col_ok=col_ok, row_v=xy_a, col_xy=xy_b, radius=radius)


@full_float32
def epipolar_candidate_mask(desc_a, desc_b, row_ok, col_ok, xy_a, xy_b, F12,
                            sigma2_b) -> torch.Tensor:
    """match_for_triangulation's [*lead, M, N] mask: the flags, then
    epipolar_mask (triangulation_mask with far_from_epipole in col_ok)."""
    lead = _lead((desc_a, 2), (desc_b, 2), (row_ok, 1), (col_ok, 1), (xy_a, 2), (xy_b, 2),
                 (F12, 2), (sigma2_b, 1))
    return _flags_mask(lead, desc_a.shape[-2], desc_b.shape[-2], row_ok, col_ok,
                       matching.epipolar_mask(xy_a, xy_b, F12, sigma2_b))


def epipolar_hamming_top2_plain(desc_a, desc_b, row_ok, col_ok, xy_a, xy_b, F12,
                                sigma2_b) -> Top2:
    """Plain version of K7 under flags and the epipolar band:
    epipolar_candidate_mask, then masked_hamming_top2_plain."""
    return masked_hamming_top2_plain(desc_a, desc_b, epipolar_candidate_mask(
        desc_a, desc_b, row_ok, col_ok, xy_a, xy_b, F12, sigma2_b))


@full_float32
def epipolar_hamming_top2(
    desc_a: torch.Tensor,     # [M, 8] or [B, M, 8] int32 (uint32 bits)
    desc_b: torch.Tensor,     # [N, 8] or [B, N, 8] int32
    row_ok: torch.Tensor,     # [M] or [B, M] bool
    col_ok: torch.Tensor,     # [N] or [B, N] bool
    xy_a: torch.Tensor,       # [M, 2] or [B, M, 2] float32 pixels in image a
    xy_b: torch.Tensor,       # [N, 2] or [B, N, 2] float32 pixels in image b
    F12: torch.Tensor,        # [3, 3] or [B, 3, 3] float32: a's point -> its line in b
    sigma2_b: torch.Tensor,   # [N] or [B, N] float32 sigma^2 of b's octave
) -> Top2:
    """K7 over the pairs with both flags set and b inside the chi2(1) =
    3.84 band of a's epipolar line (ops/matching.epipolar_mask) -> the four
    [M] or [B, M] outputs of masked_hamming_top2 under that mask. The lines,
    their clamped l0^2 + l1^2 and b's thresholds come from
    ops/matching.epipolar_terms (O(M + N) operations); the kernel computes
    each pair's ((l0 x + l1 y) + l2)^2 / den < thr in IEEE float32, in
    epipolar_mask's order, so no [B, M, N] tensor exists on the card."""
    name = "epipolar_hamming_top2"
    lead, m, n, batched = _check_tables(name, desc_a, desc_b, (
        (row_ok, "row_ok", torch.bool, "M", ()), (col_ok, "col_ok", torch.bool, "N", ()),
        (xy_a, "xy_a", torch.float32, "M", (2,)), (xy_b, "xy_b", torch.float32, "N", (2,)),
        (F12, "F12", torch.float32, "", (3, 3)),
        (sigma2_b, "sigma2_b", torch.float32, "N", ())))
    if not _build.on_card(desc_a, name):
        return epipolar_hamming_top2_plain(desc_a, desc_b, row_ok, col_ok, xy_a, xy_b, F12,
                                           sigma2_b)
    lines, den, thr = matching.epipolar_terms(xy_a, F12, sigma2_b)
    batched = dict(desc_a=batched["desc_a"], desc_b=batched["desc_b"],
                   row_ok=batched["row_ok"], col_ok=batched["col_ok"],
                   row_v=lines.dim() == 3, den=den.dim() == 2,
                   col_xy=batched["xy_b"], thr=thr.dim() == 2)
    return _launch(name, T_EPIPOLAR, lead, m, n, batched, desc_a, desc_b, row_ok=row_ok,
                   col_ok=col_ok, row_v=lines.contiguous(), den=den.contiguous(),
                   col_xy=xy_b, thr=thr.contiguous())


# Each form's mask builder and plain version, by wrapper name.
CANDIDATE_MASKS = {"valid_hamming_top2": valid_candidate_mask,
                   "window_hamming_top2": window_candidate_mask,
                   "epipolar_hamming_top2": epipolar_candidate_mask}
CANDIDATE_PLAINS = {"valid_hamming_top2": valid_hamming_top2_plain,
                    "window_hamming_top2": window_hamming_top2_plain,
                    "epipolar_hamming_top2": epipolar_hamming_top2_plain}
