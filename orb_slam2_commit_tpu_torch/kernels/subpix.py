"""K5 corner_subpix_from_patches: subpixel corner offsets from the K4
patches, with its plain version (PyTorch port of the Pallas route of
ops/subpix.py; kernel in csrc/subpix.cu).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
the plain version. The two sum in different orders and agree to ~1e-6 px.
"""

from __future__ import annotations

import torch

from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import subpix


def corner_subpix_from_patches_plain(
    patches: torch.Tensor, center_y: int, center_x: int
) -> torch.Tensor:
    """Plain version of K5: offsets_from_windows on the sliced 9x9 window."""
    return subpix.corner_subpix_from_patches(patches, center_y, center_x)


def corner_subpix_from_patches(
    patches: torch.Tensor, center_y: int, center_x: int
) -> torch.Tensor:
    """patches [K, P, P] float32 with each keypoint at (center_y, center_x)
    -> offsets [K, 2] float32 (dy, dx), each within +-1 px."""
    _build.require(patches, "corner_subpix patches", torch.float32, 3)
    r = subpix.HALF + 1
    k, ph, pw = patches.shape
    if ph != pw or not (r <= center_y < ph - r and r <= center_x < pw - r):
        raise ValueError(
            f"corner_subpix: centre ({center_y}, {center_x}) leaves no 9x9 "
            f"window in patches of {ph}x{pw}")
    if not _build.on_card(patches, "corner_subpix"):
        return corner_subpix_from_patches_plain(patches, center_y, center_x)
    out = torch.empty((k, 2), dtype=torch.float32, device=patches.device)
    if k:
        err = _build.library("subpix").corner_subpix_launch(
            patches.data_ptr(), k, ph, center_y, center_x, out.data_ptr(),
            _build.stream_of(patches))
        _build.check(err, "corner_subpix")
        _build.count_launch("corner_subpix")
    return out
