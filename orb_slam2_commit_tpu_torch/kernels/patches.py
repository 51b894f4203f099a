"""K4 extract_patches: [K, P, P] windows around keypoints, with its plain
version (PyTorch port of ops/pallas_patches.py; kernel in
csrc/patches.cu).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
the plain version. Both copy the same pixels.
"""

from __future__ import annotations

import torch

from orb_slam2_commit_tpu_torch.kernels import _build


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


def extract_patches(image: torch.Tensor, yx: torch.Tensor, patch: int) -> torch.Tensor:
    """image [H, W] float32, yx [K, 2] int32 (row, col) centres, odd patch
    size P -> [K, P, P] float32 windows; pixels outside the image repeat
    the nearest edge pixel."""
    _build.require(image, "extract_patches image", torch.float32, 2)
    _build.require(yx, "extract_patches yx", torch.int32, 2)
    if yx.shape[1] != 2 or patch % 2 != 1 or yx.device != image.device:
        raise ValueError(
            f"extract_patches: yx {tuple(yx.shape)} on {yx.device}, "
            f"image on {image.device}, patch {patch}")
    if not _build.on_card(image, "extract_patches"):
        return extract_patches_plain(image, yx, patch)
    h, w = image.shape
    k = yx.shape[0]
    lib = _build.library("patches")
    out = torch.empty((k, patch, patch), dtype=torch.float32, device=image.device)
    err = lib.extract_patches_launch(
        image.data_ptr(), h, w, yx.data_ptr(), k, patch, out.data_ptr(),
        _build.stream_of(image))
    _build.check(err, "extract_patches")
    _build.launches["extract_patches"] += 1
    return out
