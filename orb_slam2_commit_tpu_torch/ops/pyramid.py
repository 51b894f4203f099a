"""Image pyramid + Gaussian blur (PyTorch port of ops/pyramid.py).

The 7x7 sigma=2 blur is separable (horizontal taps first, then vertical,
each pass accumulated tap by tap in float32), and the pyramid resamples
every level straight from level 0 with dense resize operators, as two
batched matrix products.

Precision: the pyramid products run in full float32 on every device
(`utils.precision.full_float32`), even where the caller allows TF32; the
JAX package's accelerator route used bf16 operands for them, which the
port does not copy.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam2_commit_tpu_torch.utils.device_cache import device_table
from orb_slam2_commit_tpu_torch.utils.precision import full_float32


def gaussian_kernel_1d(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Normalized 1-D Gaussian taps (matches cv::GaussianBlur(7,7,2,2))."""
    half = (size - 1) / 2.0
    x = np.arange(size) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect_pad(x: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of a 2-D tensor; pad = (left, right,
    top, bottom) as in torch.nn.functional.pad."""
    return F.pad(x[None, None], pad, mode="reflect")[0, 0]


def separable_blur(padded: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """7-tap blur of an image already padded by 3 on the top and left:
    out[y, x] = sum_v taps[v] * (sum_u taps[u] * padded[y+v, x+u]), each
    sum accumulated in tap order in float32 (the order the level kernel
    uses, so both give the same bits)."""
    taps = [float(t) for t in gaussian_kernel_1d(7, 2.0)]
    rows = out_h + 6
    acc = None
    for t, tap in enumerate(taps):
        s = tap * padded[:rows, t : t + out_w]
        acc = s if acc is None else acc + s
    out = None
    for t, tap in enumerate(taps):
        s = tap * acc[t : t + out_h]
        out = s if out is None else out + s
    return out


def gaussian_blur(image: torch.Tensor) -> torch.Tensor:
    """7x7 sigma=2 separable blur of image[H, W] with reflect-101 borders."""
    h, w = image.shape
    return separable_blur(_reflect_pad(image, (3, 3, 3, 3)), h, w)


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] linear-resize operator (half-pixel centers,
    antialiased triangle kernel)."""
    scale = n_out / n_in
    kscale = max(1.0, 1.0 / scale)
    center = (np.arange(n_out) + 0.5) / scale - 0.5
    x = (np.arange(n_in)[None, :] - center[:, None]) / kscale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _direct_resize_mats(
    level_shapes: Tuple[Tuple[int, int], ...]
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-padded [L-1, h0, h0] row and [L-1, w0, w0] column operators
    resizing level 0 directly to each level 1..L-1."""
    (h0, w0) = level_shapes[0]
    n = len(level_shapes) - 1
    A = np.zeros((n, h0, h0), np.float32)
    B = np.zeros((n, w0, w0), np.float32)
    for i, (h, w) in enumerate(level_shapes[1:]):
        A[i, :h, :] = _resize_matrix(h0, h)
        B[i, :, :w] = _resize_matrix(w0, w).T
    return A, B


_resize_table = device_table(_resize_matrix)


@full_float32
def resize_bilinear(image: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of image[H, W] float32 to out_shape (cv::resize
    INTER_LINEAR equivalent): rows, then columns, each one product with
    `_resize_matrix`'s dense operator. No path of the port calls it (nor
    does one of the JAX package call its copy): it keeps the JAX module's
    name, and the tests hold it to JAX's."""
    h_in, w_in = image.shape
    h_out, w_out = out_shape
    out = torch.matmul(_resize_table(image.device, h_in, h_out), image.to(torch.float32))
    return torch.matmul(out, _resize_table(image.device, w_in, w_out).T)


_row_ops = device_table(lambda shapes: _direct_resize_mats(shapes)[0])
_col_ops = device_table(lambda shapes: _direct_resize_mats(shapes)[1])


@full_float32
def direct_pyramid_stack(
    image: torch.Tensor, level_shapes: Tuple[Tuple[int, int], ...]
) -> torch.Tensor:
    """[L-1, h0, w0] stack: level l+1 resized directly from level 0 into
    the top-left corner (zeros elsewhere), as two batched products."""
    shapes = tuple(level_shapes)
    t = torch.matmul(_row_ops(image.device, shapes), image.to(torch.float32))
    return torch.matmul(t, _col_ops(image.device, shapes))


def build_pyramid(
    image: torch.Tensor, level_shapes: Tuple[Tuple[int, int], ...]
) -> Tuple[torch.Tensor, ...]:
    """The scale pyramid of image[H, W] float32: level 0 is the input
    itself, levels 1+ the top-left crops of direct_pyramid_stack."""
    if len(level_shapes) == 1:
        return (image,)
    stack = direct_pyramid_stack(image, tuple(level_shapes))
    levels = [image]
    for i, (h, w) in enumerate(level_shapes[1:]):
        levels.append(stack[i, :h, :w])
    return tuple(levels)
