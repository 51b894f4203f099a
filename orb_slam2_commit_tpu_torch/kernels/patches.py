"""K4 extract_patches: [K, P, P] windows around keypoints, with its plain
version (PyTorch port of ops/pallas_patches.py; kernel in
csrc/patches.cu), and the main paths' fused launch `describe_patches`:
both windows of an extraction and K5's subpixel offsets in one launch.

On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs
the plain version. Both copy the same pixels; offsets agree to ~1e-6 px.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.kernels import subpix
# The IC-angle window (on the canvas; K5 reads its 9x9 centre) and the BRIEF
# window (on the blurred canvas), which csrc/patches.cu compiles in.
from orb_slam2_commit_tpu_torch.ops.descriptors import BRIEF_PATCH, PATCH_SIZE


def extract_patches_plain(image: torch.Tensor, yx: torch.Tensor, patch: int) -> torch.Tensor:
    """Plain version of K4: clamp each centre into the image, then gather
    the window with clamped (edge-replicated) indices."""
    h, w = image.shape
    half = patch // 2
    d = torch.arange(-half, half + 1, device=image.device)
    yc = yx[:, 0].long().clamp(0, h - 1)
    xc = yx[:, 1].long().clamp(0, w - 1)
    ys = (yc[:, None] + d[None, :]).clamp(0, h - 1)        # [K, P]
    xs = (xc[:, None] + d[None, :]).clamp(0, w - 1)
    return image[ys[:, :, None], xs[:, None, :]]


def _check_centres(name: str, image: torch.Tensor, yx: torch.Tensor) -> None:
    _build.require(image, f"{name} image", torch.float32, 2)
    _build.require(yx, f"{name} yx", torch.int32, 2)
    if yx.shape[1] != 2 or yx.device != image.device:
        raise ValueError(f"{name}: yx {tuple(yx.shape)} on {yx.device}, "
                         f"image on {image.device}")


def extract_patches(image: torch.Tensor, yx: torch.Tensor, patch: int) -> torch.Tensor:
    """image [H, W] float32, yx [K, 2] int32 (row, col) centres, odd patch
    size P -> [K, P, P] float32 windows; pixels outside the image repeat
    the nearest edge pixel. The kernel is compiled for P = 31 and 39 and
    loops over any other P at run time."""
    _check_centres("extract_patches", image, yx)
    if patch % 2 != 1:
        raise ValueError(f"extract_patches: patch {patch} is not odd")
    if not _build.on_card(image, "extract_patches"):
        return extract_patches_plain(image, yx, patch)
    h, w = image.shape
    k = yx.shape[0]
    out = torch.empty((k, patch, patch), dtype=torch.float32, device=image.device)
    err = _build.library("patches").extract_patches_launch(
        image.data_ptr(), h, w, yx.data_ptr(), k, patch, out.data_ptr(),
        _build.stream_of(image))
    _build.check(err, "extract_patches")
    _build.count_launch("extract_patches")
    return out


def describe_patches_plain(
    canvas: torch.Tensor, blur_c: torch.Tensor, yx: torch.Tensor, refine: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the fused launch: K4's plain version for each
    window, then K5's on the 31x31 windows."""
    ic = extract_patches_plain(canvas, yx, PATCH_SIZE)
    brief = extract_patches_plain(blur_c, yx, BRIEF_PATCH)
    half = PATCH_SIZE // 2
    offsets = subpix.corner_subpix_from_patches_plain(ic, half, half) if refine else None
    return ic, brief, offsets


def describe_patches(
    canvas: torch.Tensor, blur_c: torch.Tensor, yx: torch.Tensor, refine: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """canvas [H, W] float32, blur_c [Hb, Wb] float32 (the blurred canvas
    as K1 gives it: Hb >= H, Wb >= W, with pad rows and columns), yx
    [K, 2] int32 (row, col) centres -> (the [K, 31, 31] windows of canvas,
    the [K, 39, 39] windows of blur_c, and when refine is set the [K, 2]
    (dy, dx) subpixel offsets of each centre from its 31x31 window, else
    None). Each window clamps its centre and pixels to its own image, as
    extract_patches does."""
    _check_centres("describe_patches", canvas, yx)
    _build.require(blur_c, "describe_patches blur_c", torch.float32, 2)
    if (blur_c.shape[0] < canvas.shape[0] or blur_c.shape[1] < canvas.shape[1]
            or blur_c.device != canvas.device):
        raise ValueError(
            f"describe_patches: blur_c {tuple(blur_c.shape)} on {blur_c.device} does "
            f"not cover canvas {tuple(canvas.shape)} on {canvas.device}")
    if not _build.on_card(canvas, "describe_patches"):
        return describe_patches_plain(canvas, blur_c, yx, refine)
    h, w = canvas.shape
    k = yx.shape[0]
    dev = canvas.device
    ic = torch.empty((k, PATCH_SIZE, PATCH_SIZE), dtype=torch.float32, device=dev)
    brief = torch.empty((k, BRIEF_PATCH, BRIEF_PATCH), dtype=torch.float32, device=dev)
    offsets = torch.empty((k, 2), dtype=torch.float32, device=dev) if refine else None
    if k:
        err = _build.library("patches").describe_patches_launch(
            canvas.data_ptr(), h, w, blur_c.data_ptr(), *blur_c.shape, yx.data_ptr(), k,
            ic.data_ptr(), brief.data_ptr(), offsets.data_ptr() if refine else None,
            _build.stream_of(canvas))
        _build.check(err, "describe_patches")
        _build.count_launch("describe_patches")
    return ic, brief, offsets
