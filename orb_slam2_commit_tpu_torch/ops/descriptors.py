"""Keypoint orientation (intensity centroid) + rotated BRIEF descriptors
(PyTorch port of ops/descriptors.py).

Both stages read a window gathered around every keypoint by the patch
kernel (kernels/patches.py): a 31x31 window of the level image for the
IC angle and a 39x39 window of the blurred level for BRIEF. BRIEF steers
its 256-pair pattern by a 32-bin angle table and reads the two samples of
each pair straight from the 39x39 window, so every bit is an exact
float comparison.

The tables (circular patch, sampling pattern, steered offsets) are built
by the same numpy recipe and seed as the JAX package's, so both give the
same integers.

Descriptors are [N, 8] int32 tensors holding the bits of the JAX
package's uint32 words (numpy `.view(np.int32)` converts between them).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.utils.device_cache import device_table

HALF_PATCH_SIZE = 15
PATCH_SIZE = 31
N_BITS = 256
N_WORDS = 8  # 256 bits packed into 8 x 32-bit words

# BRIEF steering quantization: angles snap to N_ANGLE_BINS bin centers
# (11.25 degrees) before the rotated sample offsets are looked up.
N_ANGLE_BINS = 32
BRIEF_HALF = 19     # max |rotated offset| = ceil(13 * sqrt(2)) = 19
BRIEF_PATCH = 39


@functools.lru_cache()
def circular_umax() -> np.ndarray:
    """Max |x| per |y| row of the radius-15 circular patch, symmetric in the
    same way as the reference ctor (src/ORBextractor.cc:470-489)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 2, dtype=np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


@functools.lru_cache()
def _circular_mask() -> np.ndarray:
    """[31, 31] 0/1 mask of the intensity-centroid patch."""
    umax = circular_umax()
    mask = np.zeros((PATCH_SIZE, PATCH_SIZE), dtype=np.float32)
    for dy in range(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1):
        u = umax[abs(dy)]
        mask[dy + HALF_PATCH_SIZE, HALF_PATCH_SIZE - u : HALF_PATCH_SIZE + u + 1] = 1.0
    return mask


@functools.lru_cache()
def brief_pattern() -> np.ndarray:
    """[256, 2, 2] int32 sampling pairs ((x0, y0), (x1, y1)): Gaussian
    (0, patch/5) offsets clipped to +/-13, seeded generator, duplicate and
    degenerate pairs rejected."""
    rng = np.random.default_rng(20260817)
    sigma = PATCH_SIZE / 5.0
    pairs = []
    seen = set()
    while len(pairs) < N_BITS:
        p = np.clip(np.round(rng.normal(0.0, sigma, size=4)), -13, 13).astype(np.int32)
        key = tuple(p)
        if key in seen or (p[0] == p[2] and p[1] == p[3]):
            continue
        seen.add(key)
        pairs.append(p)
    return np.asarray(pairs, dtype=np.int32).reshape(N_BITS, 2, 2)


@functools.lru_cache()
def binned_offsets() -> np.ndarray:
    """[N_ANGLE_BINS, 256, 2, 2] int32 steered sample offsets (oy, ox) per
    bin center, computed once in float64."""
    pattern = brief_pattern()                       # [256, 2, 2] (x, y)
    out = np.zeros((N_ANGLE_BINS, N_BITS, 2, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        th = (b + 0.5) * 2.0 * np.pi / N_ANGLE_BINS - np.pi
        ca, sa = np.cos(th), np.sin(th)
        px = pattern[..., 0].astype(np.float64)     # [256, 2]
        py = pattern[..., 1].astype(np.float64)
        ox = np.round(px * ca - py * sa).astype(np.int32)
        oy = np.round(px * sa + py * ca).astype(np.int32)
        out[b, ..., 0] = oy
        out[b, ..., 1] = ox
    if np.abs(out).max() > BRIEF_HALF:
        raise AssertionError("steered offsets leave the BRIEF window")
    return out


@functools.lru_cache()
def _moment_weights() -> Tuple[np.ndarray, np.ndarray]:
    """[31, 31] dx- and dy-weight maps of the circular IC patch."""
    mask = _circular_mask()
    d = np.arange(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1, dtype=np.float32)
    w10 = mask * d[None, :]   # weight = dx
    w01 = mask * d[:, None]   # weight = dy
    return w10, w01


_offsets_table = device_table(binned_offsets)
_moment_table = device_table(
    lambda: np.stack(_moment_weights()).astype(np.float64))


def angle_bin(angle: torch.Tensor) -> torch.Tensor:
    """Quantize radians in (-pi, pi] to one of N_ANGLE_BINS bins."""
    w = 2.0 * np.pi / N_ANGLE_BINS
    return torch.remainder(
        torch.floor((angle + np.pi) / w).to(torch.int32), N_ANGLE_BINS
    )


def ic_angle_from_patches(P: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation from [N, 31, 31] patches centred on
    the keypoints: m10 = sum dx*I, m01 = sum dy*I over the circular patch
    (IC_Angle, src/ORBextractor.cc:77-105); angle = atan2(m01, m10).

    The moments are summed in float64: the products of float32 pixels and
    integer weights are exact there, and the sum's rounding is far below
    float32's, so the angle hardly depends on the device's reduction order
    (a float32 sum of 961 terms moves the angle by up to ~1e-4 rad where
    the moments nearly cancel)."""
    W = _moment_table(P.device)
    m = torch.einsum("npq,wpq->nw", P.to(torch.float64), W)
    return torch.atan2(m[:, 1], m[:, 0]).to(torch.float32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 words (bit i of word j = column
    32*j + i), packed in int64 so no shift ever sees a sign bit."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(-1, N_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def brief_from_patches(P: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation-steered BRIEF from [N, 39, 39] blurred patches centred on
    the keypoints: bit i = I(p0) < I(p1) at the pair's offsets for the
    keypoint's angle bin (computeOrbDescriptor,
    src/ORBextractor.cc:110-152). -> [N, 8] int32."""
    n = P.shape[0]
    offs = _offsets_table(P.device)                         # [B, 256, 2, 2]
    off = offs[angle_bin(angle).to(torch.int64)]            # [N, 256, 2, 2]
    flat = ((off[..., 0] + BRIEF_HALF) * BRIEF_PATCH
            + off[..., 1] + BRIEF_HALF).to(torch.int64)     # [N, 256, 2]
    vals = torch.gather(P.reshape(n, -1), 1, flat.reshape(n, -1))
    vals = vals.reshape(n, N_BITS, 2)
    return _pack_bits(vals[..., 0] < vals[..., 1])
