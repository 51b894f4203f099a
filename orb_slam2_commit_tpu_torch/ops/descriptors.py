"""Keypoint orientation (intensity centroid) + rotated BRIEF descriptors
(PyTorch port of ops/descriptors.py).

The packed extraction and the per-level patch route read a window
gathered around every keypoint by the patch kernel (kernels/patches.py):
a 31x31 window of the level image for the IC angle and a 39x39 window of
the blurred level for BRIEF. The per-level gather route (`ic_angle`,
`brief_descriptors`) reads dense moment maps and the blurred level
directly. BRIEF steers its 256-pair pattern by a 32-bin angle table and
reads the two samples of each pair, so every bit is an exact float
comparison and both routes give the same bits.

The tables (circular patch, sampling pattern, steered offsets) are built
by the same numpy recipe and seed as the JAX package's, so both give the
same integers.

Descriptors are [N, 8] int32 tensors holding the bits of the JAX
package's uint32 words (numpy `.view(np.int32)` converts between them).
"""

from __future__ import annotations

import functools
import os
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
def _selection_matrices() -> np.ndarray:
    """[N_ANGLE_BINS, 512] int64: the JAX package's one-hot selection
    matrices [N_ANGLE_BINS, BRIEF_PATCH**2, 512], each column kept as the
    row of its one. Column 2j+k picks the 39x39 patch pixel at the bin's
    steered offset of pattern point (j, k); the port gathers it instead of
    multiplying by the one-hot column, which reads the same float."""
    offs = binned_offsets()
    oy = offs[..., 0] + BRIEF_HALF                  # [B, 256, 2]
    ox = offs[..., 1] + BRIEF_HALF
    return (oy * BRIEF_PATCH + ox).reshape(N_ANGLE_BINS, 2 * N_BITS).astype(np.int64)


N_RESIDUAL_BINS = N_ANGLE_BINS // 4


@functools.lru_cache()
def _residual_selection_matrices() -> np.ndarray:
    """[N_ANGLE_BINS // 4, 512] selections of the quadrant-decomposed BRIEF
    route (`brief_descriptors_patches`). Steering by bin b = q * (B/4) + r
    factors as R(90 deg)^q . R(theta_r): a 90-degree rotation maps the
    integer offset lattice onto itself and np.round is odd-symmetric, so
    round(R(theta_b) p) == R90^q round(R(theta_r) p) exactly, checked here
    for every bin. Only the B/4 residual bins need a selection; the
    quadrant is a flip or transpose of the patch."""
    offs = binned_offsets()
    for b in range(N_ANGLE_BINS):
        q, r = divmod(b, N_RESIDUAL_BINS)
        v = offs[r].astype(np.int64)                # [256, 2, 2] (oy, ox)
        for _ in range(q):                          # R90: (y, x) -> (x, -y)
            v = np.stack([v[..., 1], -v[..., 0]], axis=-1)
        if not np.array_equal(v, offs[b]):
            raise AssertionError(f"angle bin {b} does not factor through its quadrant")
    return _selection_matrices()[:N_RESIDUAL_BINS]


@functools.lru_cache()
def _moment_weights() -> Tuple[np.ndarray, np.ndarray]:
    """[31, 31] dx- and dy-weight maps of the circular IC patch."""
    mask = _circular_mask()
    d = np.arange(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1, dtype=np.float32)
    w10 = mask * d[None, :]   # weight = dx
    w01 = mask * d[:, None]   # weight = dy
    return w10, w01


_offsets_table = device_table(binned_offsets)
_residual_table = device_table(_residual_selection_matrices)
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


# ---------------------------------------------------------------------------
# The per-level routes (ops/extractor.py with ORB_TPU_FORCE_PACKED=0)
# ---------------------------------------------------------------------------

def use_patch_route(image: torch.Tensor) -> bool:
    """Patch-kernel route for orientation and BRIEF on the per-level
    extraction? ORB_TPU_FORCE_PATCHES=0/1 decides, read at each call, as
    in the JAX package; unset, a CUDA tensor takes the patch route (K1 and
    the standalone K4 per level) and a CPU tensor the gather route."""
    v = os.environ.get("ORB_TPU_FORCE_PATCHES")
    if v is not None:
        return v == "1"
    return image.device.type == "cuda"


def gather_patches(image: torch.Tensor, yx: torch.Tensor,
                   half: int = HALF_PATCH_SIZE) -> torch.Tensor:
    """[N, 2*half+1, 2*half+1] patches of image[H, W] centred at integer
    yx [N, 2], indices clamped to the image."""
    h, w = image.shape
    d = torch.arange(-half, half + 1, device=image.device)
    ys = (yx[:, 0, None].long() + d[None, :]).clamp(0, h - 1)
    xs = (yx[:, 1, None].long() + d[None, :]).clamp(0, w - 1)
    return image[ys[:, :, None], xs[:, None, :]]


def _moment_maps(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (m10, m01) intensity moments of the circular patch at every
    pixel, in float32: horizontal weighted and box sums per distinct circle
    half-width, then shifted vertical accumulation, with wrap-around shifts
    (a keypoint is >= 22 px inside its level, so no patch wraps). The
    additions run in the JAX package's order, so the maps agree bit for
    bit."""
    umax = circular_umax()
    distinct_u = sorted(set(int(u) for u in umax))
    hp = HALF_PATCH_SIZE
    acc_w = {u: torch.zeros_like(image) for u in distinct_u}
    acc_b = {u: torch.zeros_like(image) for u in distinct_u}
    for dx in range(-hp, hp + 1):
        s = torch.roll(image, -dx, dims=1)
        for u in distinct_u:
            if abs(dx) <= u:
                if dx != 0:
                    acc_w[u] = acc_w[u] + float(dx) * s
                acc_b[u] = acc_b[u] + s
    m10 = torch.zeros_like(image)
    m01 = torch.zeros_like(image)
    for dy in range(-hp, hp + 1):
        u = int(umax[abs(dy)])
        m10 = m10 + torch.roll(acc_w[u], -dy, dims=0)
        if dy != 0:
            m01 = m01 + float(dy) * torch.roll(acc_b[u], -dy, dims=0)
    return m10, m01


def ic_angle(image: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (IC_Angle, src/ORBextractor.cc:77-105)
    on the gather route: the dense float32 moment maps, read at the
    keypoints -> [N] radians."""
    h, w = image.shape
    m10_map, m01_map = _moment_maps(image)
    flat = yx[:, 0].long().clamp(0, h - 1) * w + yx[:, 1].long().clamp(0, w - 1)
    return torch.atan2(m01_map.reshape(-1)[flat], m10_map.reshape(-1)[flat])


def brief_descriptors(blurred: torch.Tensor, yx: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Rotation-steered BRIEF on the gather route: the binned offsets of
    each keypoint's angle, the two samples of each pair read from the
    blurred level (indices clamped) -> [N, 8] int32."""
    h, w = blurred.shape
    off = _offsets_table(blurred.device)[angle_bin(angle).long()]   # [N, 256, 2, 2]
    ys = (yx[:, 0, None, None].long() + off[..., 0]).clamp(0, h - 1)
    xs = (yx[:, 1, None, None].long() + off[..., 1]).clamp(0, w - 1)
    vals = blurred.reshape(-1)[(ys * w + xs).reshape(-1)].reshape(-1, N_BITS, 2)
    return _pack_bits(vals[..., 0] < vals[..., 1])


def ic_angle_patches(image: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """IC angle on the patch route: 31x31 windows by the standalone patch
    kernel (K4), then `ic_angle_from_patches`."""
    from orb_slam2_commit_tpu_torch.kernels import patches

    return ic_angle_from_patches(patches.extract_patches(image, yx.contiguous(), PATCH_SIZE))


def brief_descriptors_patches(blurred: torch.Tensor, yx: torch.Tensor,
                              angle: torch.Tensor) -> torch.Tensor:
    """BRIEF on the patch route: 39x39 windows of the blurred level by the
    standalone patch kernel (K4), each turned by its angle bin's quadrant
    (see _residual_selection_matrices), then the residual bin's samples
    -> [N, 8] int32. Bit for bit `brief_descriptors` for keypoints at least
    BRIEF_HALF px inside the level, which the detection border keeps."""
    from orb_slam2_commit_tpu_torch.kernels import patches

    P = patches.extract_patches(blurred, yx.contiguous(), BRIEF_PATCH)
    b = angle_bin(angle).long()
    q = (b // N_RESIDUAL_BINS)[:, None, None]
    P1 = P.transpose(1, 2).flip(1)                  # Patch[ix, 38 - iy]
    P2 = P.flip((1, 2))                             # Patch[38 - iy, 38 - ix]
    P3 = P.transpose(1, 2).flip(2)                  # Patch[38 - ix, iy]
    Prot = torch.where(q == 0, P, torch.where(q == 1, P1, torch.where(q == 2, P2, P3)))
    sel = _residual_table(blurred.device)[b % N_RESIDUAL_BINS]       # [N, 512]
    vals = torch.gather(Prot.reshape(P.shape[0], -1), 1, sel).reshape(-1, N_BITS, 2)
    return _pack_bits(vals[..., 0] < vals[..., 1])


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words -> [N, 256] int32 0/1 (bit i of word j -> column
    32*j + i). No path of the port calls it (nor does one of the JAX
    package call its copy): it keeps the JAX module's name, and the
    tests hold it to JAX's."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = (desc.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], N_BITS).to(torch.int32)
