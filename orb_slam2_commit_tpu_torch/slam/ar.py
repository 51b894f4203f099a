"""Augmented-reality anchoring: plane detection in the sparse map and a
virtual object over tracked frames (the port's copy of slam/ar.py).

The counterpart of the reference's MonoAR node
(Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.h: plane detection from tracked
map points by RANSAC in `ViewerAR::DetectPlane`, the plane's pose in
`Plane::Recompute`, the cube and plane grid in `ViewerAR::DrawCube` /
`DrawPlane` over the live camera image). Here:

  * the plane fit is a batched RANSAC on the caller's device: every
    3-point hypothesis is scored in one pass against a threshold scaled to
    the scene, then the winning consensus set is refitted by an
    eigendecomposition of its covariance. The sample index sets are drawn
    on the host from a torch.Generator (or passed in), so the card and the
    CPU score the same hypotheses. `fit_plane_ransac_jit` is the JAX
    package's jitted fit as a single dispatch: on CUDA tensors two CUDA
    graph replays (utils/cuda_graph.py) around the eigendecomposition,
    which reads its status on the host; on CPU tensors the same stages run
    eagerly;
  * the cube is projected with the tracker's current pose and drawn into
    the frame overlay in host numpy (no GL).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.interop import resolve_device, to_host
from orb_slam2_commit_tpu_torch.optim import linalg
from orb_slam2_commit_tpu_torch.utils import cuda_graph


class PlaneFit(NamedTuple):
    normal: torch.Tensor     # [3] unit normal (world)
    offset: torch.Tensor     # scalar d: n.x + d = 0 on the plane
    centroid: torch.Tensor   # [3] centroid of the consensus points
    n_inliers: torch.Tensor
    inliers: torch.Tensor    # [N] bool
    best: torch.Tensor       # index of the winning hypothesis
    threshold: torch.Tensor  # the distance threshold (rel_threshold x scale)


def sample_indices(n: int, n_iters: int = 128,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[n_iters, 3] int64 point indices in [0, n), drawn on the host."""
    return torch.randint(0, n, (n_iters, 3), generator=generator)


def _hypotheses(points, valid, idx, key):
    """Stage 1: the scene scale and threshold, every hypothesis's plane and
    inliers, the first best one -> (the consensus set's covariance and
    centroid, the threshold, the winner's index)."""
    rel_threshold, = key
    n = points.shape[0]
    pts = points.to(torch.float32)
    valid = valid.to(torch.bool)
    w = valid.to(torch.float32)
    centroid_all = (pts * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)
    dist_c = torch.linalg.vector_norm(pts - centroid_all, dim=-1)
    big = torch.where(valid, dist_c, 0.0).max() + 1.0
    # The median of an even count averages its two middle values, as
    # jnp.median does (torch.median would return the lower one).
    ranked = torch.sort(torch.where(valid, dist_c, big)).values
    scale = (ranked[(n - 1) // 2] + ranked[n // 2]) * 0.5
    th = rel_threshold * scale

    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    nrm = torch.linalg.cross(p1 - p0, p2 - p0)                 # [I, 3]
    nn = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    ok = (nn[:, 0] > 1e-9) & valid[idx[:, 0]] & valid[idx[:, 1]] & valid[idx[:, 2]]
    nrm = nrm / torch.clamp(nn, min=1e-12)
    d = -(nrm * p0).sum(-1)                                    # [I]

    dist = torch.abs(pts @ nrm.T + d[None, :])                 # [N, I]
    inl = (dist < th) & valid[:, None]
    score = torch.where(ok, inl.sum(0), 0)
    best = torch.argmax(score)
    # index_select, not a 0-d index (that one reads the index on the host).
    best_inl = inl.index_select(1, best[None])[:, 0]

    # Refit on the consensus set: the normal is the eigenvector of the
    # centred covariance with the smallest eigenvalue.
    wb = best_inl.to(torch.float32)
    m = torch.clamp(wb.sum(), min=1.0)
    c = (pts * wb[:, None]).sum(0) / m
    x = (pts - c) * wb[:, None]
    return x.T @ x / m, c, th, best


def _classify(points, valid, vecs, c, th, best, key):
    """Stage 2, after the eigendecomposition: the refitted plane and the
    final classification against it -> PlaneFit."""
    pts = points.to(torch.float32)
    valid = valid.to(torch.bool)
    n_fit = vecs[:, 0]
    n_fit = n_fit / torch.clamp(torch.linalg.vector_norm(n_fit), min=1e-12)
    d_fit = -torch.dot(n_fit, c)
    inl_fit = (torch.abs(pts @ n_fit + d_fit) < th) & valid
    return PlaneFit(normal=n_fit, offset=d_fit, centroid=c, n_inliers=inl_fit.sum(),
                    inliers=inl_fit, best=best, threshold=th)


def _fit(points, valid, generator, n_iters, rel_threshold, idx) -> PlaneFit:
    """The fit's two stages, each through utils/cuda_graph.call, with the
    eigendecomposition between them."""
    if idx is None:
        idx = sample_indices(points.shape[0], n_iters, generator)
    idx = idx.to(points.device)
    key = (float(rel_threshold),)
    cov, c, th, best = cuda_graph.call(_hypotheses, (points, valid, idx), key)
    _, vecs = linalg.eigh(cov)
    return cuda_graph.call(_classify, (points, valid, vecs, c, th, best), key)


def fit_plane_ransac(
    points: torch.Tensor,    # [N, 3]
    valid: torch.Tensor,     # [N] bool
    generator: Optional[torch.Generator] = None,
    n_iters: int = 128,
    rel_threshold: float = 0.02,
    idx: Optional[torch.Tensor] = None,
) -> PlaneFit:
    """Dominant-plane RANSAC over the map-point cloud, on the points'
    device.

    The distance threshold is rel_threshold x the scene scale (the median
    distance of the points to the valid points' centroid, invalid points
    counted as farther than all), so the fit does not depend on the
    monocular map's arbitrary scale, as the reference sizes its AR geometry
    in map units (ViewerAR.h's Plane). idx: the [n_iters, 3] sample index
    sets; drawn from `generator` (sample_indices) when None. The stages of
    fit_plane_ransac_jit, run eagerly on any device."""
    with cuda_graph.eager():
        return _fit(points, valid, generator, n_iters, rel_threshold, idx)


def fit_plane_ransac_jit(
    points: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_iters: int = 128,
    rel_threshold: float = 0.02,
    idx: Optional[torch.Tensor] = None,
) -> PlaneFit:
    """fit_plane_ransac with each stage through utils/cuda_graph.call: on
    the card two replays around one eigendecomposition, eagerly on the
    CPU."""
    return _fit(points, valid, generator, n_iters, rel_threshold, idx)


# The functions fit_plane_ransac_jit captures (cuda_graph.release's owners).
GRAPHED = (_hypotheses, _classify)


def plane_frame(normal: np.ndarray, centroid: np.ndarray,
                cam_center: np.ndarray) -> np.ndarray:
    """Twp [4, 4]: the plane-anchored frame (origin at the consensus
    centroid, z along the normal flipped to face the camera), the role of
    Plane::Recompute's Tpw in the reference (inverted convention here)."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    to_cam = np.asarray(cam_center, np.float64) - np.asarray(centroid, np.float64)
    if np.dot(n, to_cam) < 0:
        n = -n
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = np.cross(a, n)
    x /= np.linalg.norm(x)
    y = np.cross(n, x)
    Twp = np.eye(4)
    Twp[:3, 0] = x
    Twp[:3, 1] = y
    Twp[:3, 2] = n
    Twp[:3, 3] = np.asarray(centroid, np.float64)
    return Twp


def cube_vertices(size: float) -> np.ndarray:
    """[8, 3] cube corners in plane coordinates, the base on the plane (z
    in [0, size]), as the reference's cube sits on the detected plane."""
    s = size / 2.0
    base = [(-s, -s, 0), (s, -s, 0), (s, s, 0), (-s, s, 0)]
    top = [(x, y, size) for (x, y, _z) in base]
    return np.array(base + top, np.float64)


CUBE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _draw_line(canvas: np.ndarray, p0, p1, color) -> None:
    """A clipped line by dense sampling."""
    h, w = canvas.shape[:2]
    x0, y0 = p0
    x1, y1 = p1
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * ts).astype(int)
    ys = np.round(y0 + (y1 - y0) * ts).astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[keep], xs[keep]] = color


def draw_cube(
    canvas: np.ndarray,
    R: np.ndarray, t: np.ndarray,            # Tcw
    fx: float, fy: float, cx: float, cy: float,
    Twp: np.ndarray,
    size: float,
    color=(255, 90, 40),
) -> bool:
    """Project the plane-anchored cube with the current pose and draw its
    wireframe into canvas [H, W, 3]. False (nothing drawn) if a corner is
    behind the camera."""
    verts_p = cube_vertices(size)
    verts_w = (Twp[:3, :3] @ verts_p.T).T + Twp[:3, 3]
    pc = (np.asarray(R) @ verts_w.T).T + np.asarray(t)
    if np.any(pc[:, 2] <= 1e-6):
        return False
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fy * pc[:, 1] / pc[:, 2] + cy
    col = np.array(color, np.uint8)
    for i, j in CUBE_EDGES:
        _draw_line(canvas, (u[i], v[i]), (u[j], v[j]), col)
    return True


class ARAnchor:
    """Detect a plane once enough map points exist, then keep overlaying
    the cube (the reference re-detects on a user's click; this tries again
    while the consensus is too small). Each attempt draws its sample sets
    from a host torch.Generator seeded with `seed`, and fits on `device`.
    As in the JAX package, the samples range over every row of pt_pos, the
    invalid ones too: on a map table mostly empty, almost no sample is of
    three valid points, and the fit falls back to the least-variance
    direction of all the valid points."""

    def __init__(self, min_points: int = 40, cube_rel_size: float = 0.3,
                 seed: int = 0, device="cuda"):
        self.min_points = min_points
        self.cube_rel_size = cube_rel_size
        self.Twp: Optional[np.ndarray] = None
        self.size: float = 0.0
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(seed)

    def update(self, pt_pos: np.ndarray, pt_valid: np.ndarray,
               cam_center: np.ndarray) -> bool:
        n_valid = int(pt_valid.sum())
        if self.Twp is not None or n_valid < self.min_points:
            return self.Twp is not None
        fit = fit_plane_ransac_jit(
            torch.as_tensor(np.asarray(pt_pos, np.float32), device=self.device),
            torch.as_tensor(np.asarray(pt_valid, bool), device=self.device),
            self.generator)
        if int(fit.n_inliers) < max(12, n_valid // 5):
            return False
        centroid = to_host(fit.centroid)
        self.Twp = plane_frame(to_host(fit.normal), centroid, cam_center)
        pts = np.asarray(pt_pos)[to_host(fit.inliers)]
        spread = np.median(np.linalg.norm(pts - centroid, axis=-1))
        self.size = float(self.cube_rel_size * 2.0 * spread)
        return True

    def overlay(self, canvas: np.ndarray, R: np.ndarray, t: np.ndarray,
                fx, fy, cx, cy) -> bool:
        if self.Twp is None:
            return False
        return draw_cube(canvas, R, t, fx, fy, cx, cy, self.Twp, self.size)
