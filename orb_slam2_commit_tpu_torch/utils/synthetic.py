"""Synthetic scene rendering (host-side numpy) for the port's examples.

A copy of the parts of the JAX package's renderer that `render_sequence`
(with or without depth maps; the forward march or the lateral sweep, any
depth range, spread and planar fraction) and `render_stereo_sequence`
need without photometric degradation: a cloud of 3D landmarks, each
splatted as a small random-texture patch with bilinear subpixel accuracy
along a known trajectory; and the loop-closure survey
(`render_loop_sequence`: a landmark ring around a circular path that
revisits its start). The same seed gives the same images, depth maps,
poses and scene as the JAX package's renderer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from orb_slam2_commit_tpu_torch.utils.config import CameraConfig


@dataclasses.dataclass
class Scene:
    points: np.ndarray       # [P, 3] world coords
    patches: np.ndarray      # [P, S, S] float32 textures (0..255)
    patch_half: int


def make_scene(
    rng: np.random.Generator,
    n_points: int = 500,
    depth_range: Tuple[float, float] = (4.0, 12.0),
    spread: float = 6.0,
    patch_size: int = 15,
    planar_frac: float = 0.0,
) -> Scene:
    """Random landmark cloud in front of the origin (+z forward); each
    landmark's texture is a bright central disc (one strong FAST corner),
    random blocks (distinctive BRIEF) and a directional ramp (stable
    intensity-centroid orientation). The first planar_frac of the
    landmarks are moved onto a tilted ground plane."""
    z = rng.uniform(*depth_range, size=n_points)
    x = rng.uniform(-spread, spread, size=n_points)
    y = rng.uniform(-spread * 0.75, spread * 0.75, size=n_points)
    points = np.stack([x, y, z], axis=-1)
    if planar_frac > 0.0:
        k = int(n_points * planar_frac)
        nrm = np.array([0.1, 1.0, -0.15])
        nrm /= np.linalg.norm(nrm)
        anchor = np.array([0.0, spread * 0.5, np.mean(depth_range)])
        d = -nrm @ anchor
        pts = points[:k]
        points[:k] = pts - ((pts @ nrm + d)[:, None]) * nrm[None, :]

    s = max(patch_size, 17)
    half = s // 2
    tex = rng.uniform(0.0, 255.0, size=(n_points, s, s))
    tex = np.where(tex > 127.5, 165.0, 55.0)
    theta = rng.uniform(0, 2 * np.pi, n_points)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64)
    yc, xc = (yy - half) / half, (xx - half) / half
    ramp = (
        np.cos(theta)[:, None, None] * xc[None]
        + np.sin(theta)[:, None, None] * yc[None]
    )
    patches = np.clip(tex + 35.0 * ramp, 0.0, 255.0)
    r2 = (yy - half) ** 2 + (xx - half) ** 2
    disc = r2 <= 2.5 ** 2
    patches[:, disc] = 250.0
    return Scene(points=points.astype(np.float64),
                 patches=patches.astype(np.float32),
                 patch_half=half)


def _aa_blur(img: np.ndarray, sigma: float = 0.7) -> np.ndarray:
    """Separable 5-tap Gaussian anti-aliasing (camera optics stand-in)."""
    x = np.arange(-2, 3, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    pad = np.pad(img, ((0, 0), (2, 2)), mode="edge")
    img = sum(k[i] * pad[:, i : i + img.shape[1]] for i in range(5))
    pad = np.pad(img, ((2, 2), (0, 0)), mode="edge")
    return sum(k[i] * pad[i : i + img.shape[0], :] for i in range(5)).astype(
        np.float32
    )


def render(
    scene: Scene,
    R_cw: np.ndarray,
    t_cw: np.ndarray,
    cam: CameraConfig,
    background: float = 96.0,
    with_depth: bool = False,
    max_depth: float = np.inf,
):
    """Render image [H, W] float32 from camera pose (world -> camera) of a
    distortion-free pinhole camera. With with_depth=True also returns a
    depth map [H, W] float32: the z of the landmark drawn at each pixel, 0
    where none is (TUM RGB-D's invalid-depth convention). Landmarks beyond
    max_depth are not drawn (an opaque wall for scenes around the camera)."""
    if cam.has_distortion:
        raise ValueError("the port's renderer draws undistorted images only")
    h, w = cam.height, cam.width
    img = np.full((h, w), background, dtype=np.float32)
    depth = np.zeros((h, w), dtype=np.float32)
    pc = scene.points @ R_cw.T + t_cw
    z = pc[:, 2]
    order = np.where((z >= 0.5) & (z <= max_depth))[0]
    order = order[np.argsort(-z[order])]  # far first: near draws on top
    half = scene.patch_half
    s = 2 * half + 1
    for i in order:
        u = cam.fx * pc[i, 0] / z[i] + cam.cx
        v = cam.fy * pc[i, 1] / z[i] + cam.cy
        if not (half + 2 <= u < w - half - 2 and half + 2 <= v < h - half - 2):
            continue
        u0, v0 = int(np.floor(u)), int(np.floor(v))
        fu, fv = u - u0, v - v0
        # Bilinear splat of the patch at subpixel offset (fu, fv).
        p = scene.patches[i]
        top = v0 - half
        left = u0 - half
        block = img[top : top + s + 1, left : left + s + 1]
        w00 = (1 - fu) * (1 - fv)
        w10 = fu * (1 - fv)
        w01 = (1 - fu) * fv
        w11 = fu * fv
        acc = np.zeros((s + 1, s + 1), dtype=np.float32)
        wgt = np.zeros((s + 1, s + 1), dtype=np.float32)
        acc[:s, :s] += w00 * p
        wgt[:s, :s] += w00
        acc[:s, 1:] += w10 * p
        wgt[:s, 1:] += w10
        acc[1:, :s] += w01 * p
        wgt[1:, :s] += w01
        acc[1:, 1:] += w11 * p
        wgt[1:, 1:] += w11
        mask = wgt > 1e-6
        block[mask] = acc[mask] / np.maximum(wgt[mask], 1e-6)
        depth[top : top + s + 1, left : left + s + 1][mask] = z[i]
    img = _aa_blur(img)
    if with_depth:
        return img, depth
    return img


def look_ahead_trajectory(
    n_frames: int,
    step: float = 0.06,
    lateral_amp: float = 0.25,
    yaw_amp: float = 0.02,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Forward-dominant trajectory with gentle sway; camera-from-world
    (R_cw, t_cw) per frame. Camera starts at origin looking +z."""
    poses = []
    for k in range(n_frames):
        c = np.array(
            [
                lateral_amp * np.sin(2.0 * np.pi * k / max(n_frames - 1, 1)),
                0.05 * np.sin(4.0 * np.pi * k / max(n_frames - 1, 1)),
                step * k,
            ]
        )
        yaw = yaw_amp * np.sin(2.0 * np.pi * k / max(n_frames - 1, 1))
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        R_cw = R_wc.T
        t_cw = -R_cw @ c
        poses.append((R_cw, t_cw))
    return poses


def sweep_trajectory(
    n_frames: int,
    amp: float = 0.35,
    z_step: float = 0.005,
    yaw_amp: float = 0.12,
    periods: float = 1.25,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Handheld lateral sweep (TUM fr1/xyz-like): a sinusoid in x with a
    gentle vertical bob, a slow forward drift and a yaw that keeps the
    scene centred; camera-from-world (R_cw, t_cw) per frame."""
    poses = []
    for k in range(n_frames):
        ph = 2.0 * np.pi * periods * k / max(n_frames - 1, 1)
        c = np.array([
            amp * np.sin(ph),
            0.35 * amp * np.sin(2.1 * ph + 0.7),
            z_step * k,
        ])
        yaw = -yaw_amp * np.sin(ph)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        R_cw = R_wc.T
        t_cw = -R_cw @ c
        poses.append((R_cw, t_cw))
    return poses


def render_sequence(
    cam: CameraConfig,
    n_frames: int = 30,
    n_points: int = 500,
    seed: int = 0,
    step: float = 0.06,
    with_depth: bool = False,
    planar_frac: float = 0.0,
    motion: str = "forward",
    depth_range: Tuple[float, float] = (4.0, 12.0),
    spread: float = 6.0,
):
    """Images [T, H, W] float32 + ground-truth (R_cw, t_cw) poses + scene
    (+ depth maps [T, H, W] when with_depth). motion="forward" is the
    forward march; motion="sweep" the lateral sweep, whose peak per-frame
    translation is `step` (use it with depth_range=(1.5, 4.0), spread=2.0,
    the monocular tests' scene)."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n_points=n_points, planar_frac=planar_frac,
                       depth_range=depth_range, spread=spread)
    if motion == "sweep":
        periods = 1.25
        amp = step * (n_frames - 1) / (2.0 * np.pi * periods)
        poses = sweep_trajectory(n_frames, amp=amp, periods=periods)
    elif motion == "forward":
        poses = look_ahead_trajectory(n_frames, step=step)
    else:
        raise ValueError(f"motion: 'forward' or 'sweep', got {motion!r}")
    if with_depth:
        rendered = [render(scene, R, t, cam, with_depth=True) for R, t in poses]
        images = np.stack([r[0] for r in rendered])
        depths = np.stack([r[1] for r in rendered])
        return images, poses, scene, depths
    images = np.stack([render(scene, R, t, cam) for R, t in poses])
    return images, poses, scene


def right_pose(R_cw: np.ndarray, t_cw: np.ndarray, baseline: float):
    """The right camera of a rectified pair: displaced by the baseline
    along the left camera's x-axis (t_right = t_left - [b, 0, 0])."""
    return R_cw, t_cw - np.array([baseline, 0.0, 0.0])


def render_stereo_sequence(
    cam: CameraConfig,
    n_frames: int = 30,
    n_points: int = 500,
    seed: int = 0,
    step: float = 0.06,
):
    """Rectified stereo pairs along the forward trajectory: left images
    [T, H, W], right images [T, H, W], the left camera's poses, scene."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n_points=n_points)
    poses = look_ahead_trajectory(n_frames, step=step)
    lefts = [render(scene, R, t, cam) for R, t in poses]
    rights = [render(scene, *right_pose(R, t, cam.baseline), cam) for R, t in poses]
    return np.stack(lefts), np.stack(rights), poses, scene


def ring_scene(
    rng: np.random.Generator,
    n_points: int = 700,
    center: np.ndarray = None,
    radius_range: Tuple[float, float] = (6.0, 12.0),
    height: float = 2.5,
    patch_size: int = 15,
) -> Scene:
    """A landmark annulus around a closed camera path (KITTI-00-class loop
    geometry): every azimuth at radius_range from `center`, so a camera
    circling inside sees a different sector at every angle and the same
    sector when it returns. Landmarks sit on a jittered (azimuth, height)
    grid, near-evenly spaced, so that the fixed-size sprites do not
    overlap; textures as make_scene's."""
    if center is None:
        center = np.zeros(3)
    n_az = int(np.ceil(np.sqrt(n_points * 8)))
    n_h = -(-n_points // n_az)
    az_idx, h_idx = np.meshgrid(np.arange(n_az), np.arange(n_h))
    az_idx = az_idx.reshape(-1)[:n_points]
    h_idx = h_idx.reshape(-1)[:n_points]
    phi = (az_idx + rng.uniform(0.15, 0.85, n_points)) * (2.0 * np.pi / n_az)
    y_g = (h_idx + rng.uniform(0.15, 0.85, n_points)) / n_h
    rad = rng.uniform(*radius_range, n_points)
    points = np.stack([center[0] + rad * np.sin(phi), center[1] + (2.0 * y_g - 1.0) * height,
                       center[2] + rad * np.cos(phi)], axis=-1)
    proto = make_scene(rng, n_points=n_points, patch_size=patch_size)
    return Scene(points=points.astype(np.float64), patches=proto.patches,
                 patch_half=proto.patch_half)


def loop_trajectory(n_frames: int, radius: float = 2.0,
                    frac: float = 1.25) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A circular survey with tangential heading: from the origin looking
    +z around a circle of `radius` (centre (radius, 0, 0)), and with
    frac > 1 over the first sectors again, revisiting its own keyframes.
    -> (R_cw, t_cw) per frame."""
    poses = []
    for k in range(n_frames):
        th = 2.0 * np.pi * frac * k / max(n_frames - 1, 1)
        c = np.array([radius * (1.0 - np.cos(th)), 0.0, radius * np.sin(th)])
        cy, sy = np.cos(th), np.sin(th)
        R_cw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]).T
        poses.append((R_cw, -R_cw @ c))
    return poses


def render_loop_sequence(
    cam: CameraConfig,
    n_frames: int = 120,
    n_points: int = 900,
    seed: int = 0,
    radius: float = 2.0,
    frac: float = 1.2,
    radius_range: Tuple[float, float] = (7.0, 9.0),
    max_depth: float = 12.0,
):
    """(images [T, H, W], poses, scene) of the loop-closure survey:
    ring_scene around loop_trajectory's circle, the ring's far side
    hidden beyond max_depth as behind an opaque wall."""
    rng = np.random.default_rng(seed)
    scene = ring_scene(rng, n_points=n_points, center=np.array([radius, 0.0, 0.0]),
                       radius_range=radius_range)
    poses = loop_trajectory(n_frames, radius=radius, frac=frac)
    images = np.stack([render(scene, R, t, cam, max_depth=max_depth) for R, t in poses])
    return images, poses, scene
