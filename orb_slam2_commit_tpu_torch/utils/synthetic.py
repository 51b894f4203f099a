"""Synthetic scene rendering (host-side numpy) for the port's examples and
its dataset writers.

A copy of the JAX package's renderer: a cloud of 3D landmarks, each
splatted as a small random-texture patch with bilinear subpixel accuracy
along a known trajectory (`render_sequence`, with or without depth maps;
the forward march or the lateral sweep; `render_stereo_sequence`), through
a distortion-free pinhole or a radial-tangential lens (landmarks drawn at
their distorted pixel, as a real camera images them); the photometric
degradation of a real camera (`Photometry`: read and shot noise, exposure
gain and bias, motion blur); the loop-closure survey
(`render_loop_sequence`: a landmark ring around a circular path that
revisits its start); and the KITTI-class drive (`drive_frames`: a street
canyon along a closed city-block circuit, rendered lazily, left and right
images), and the figure-eight drive (`figure8_frames`: two lobes through
one crossing, a loop to close after each). The same seed gives the same images, depth maps, poses and scene
as the JAX package's renderer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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


def _distort_np(xn: float, yn: float, cam: CameraConfig):
    """Radial-tangential distortion of one normalized coordinate (numpy
    twin of ops/camera.distort_normalized; the OpenCV model the
    reference's settings assume, src/Tracking.cc:53-117)."""
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = xn * radial + 2.0 * cam.p1 * xn * yn + cam.p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + cam.p1 * (r2 + 2.0 * yn * yn) + 2.0 * cam.p2 * xn * yn
    return xd, yd


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


@dataclasses.dataclass
class Photometry:
    """Per-frame photometric degradation of a real camera, whose noise and
    exposure swings the reference's extractor is built to survive (the
    two-threshold FAST fallback, src/ORBextractor.cc:892-915; the blur
    before BRIEF, :1190):

      * read noise: additive Gaussian, `noise_sigma` gray levels;
      * shot noise: Gaussian with sigma = shot_noise * sqrt(I / 255);
      * exposure: a per-frame gain in `gain_range` and bias in
        `bias_range` (gray levels), drawn uniformly;
      * motion blur: a directional blur along the inter-frame image flow,
        motion_blur_frac * |flow| px long, at most motion_blur_max_px.

    Every draw is seeded by the frame's index, so a resumed drive and a
    repeated render see the same degradation."""

    noise_sigma: float = 0.0
    shot_noise: float = 0.0
    gain_range: Tuple[float, float] = (1.0, 1.0)
    bias_range: Tuple[float, float] = (0.0, 0.0)
    motion_blur_frac: float = 0.0
    motion_blur_max_px: float = 6.0


# A moderate real-camera operating point: 3 gray levels of read noise,
# sqrt-scaled shot noise, a +-20% exposure gain swing.
CAMERA_PHOTO = Photometry(
    noise_sigma=3.0, shot_noise=2.0, gain_range=(0.8, 1.2),
    bias_range=(-6.0, 6.0),
)


def _shift_sample(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Bilinear sample of img at (x + dx, y + dy), edge-clamped."""
    h, w = img.shape
    x0 = int(np.floor(dx))
    y0 = int(np.floor(dy))
    fx, fy = dx - x0, dy - y0

    def sh(ix, iy):
        xs = np.clip(np.arange(w) + ix, 0, w - 1)
        ys = np.clip(np.arange(h) + iy, 0, h - 1)
        return img[np.ix_(ys, xs)]

    return ((1 - fx) * (1 - fy) * sh(x0, y0) + fx * (1 - fy) * sh(x0 + 1, y0)
            + (1 - fx) * fy * sh(x0, y0 + 1) + fx * fy * sh(x0 + 1, y0 + 1))


def _motion_blur(img: np.ndarray, flow: np.ndarray, length: float) -> np.ndarray:
    """Directional blur: the mean of samples along the flow's direction
    over `length` pixels (a shutter integrating a uniform flow)."""
    if length < 0.5:
        return img
    n = max(int(np.ceil(length)) + 1, 2)
    d = flow / max(np.linalg.norm(flow), 1e-9)
    offs = np.linspace(-0.5 * length, 0.5 * length, n)
    acc = np.zeros_like(img)
    for o in offs:
        acc += _shift_sample(img, d[0] * o, d[1] * o)
    return (acc / n).astype(np.float32)


def apply_photometry(
    img: np.ndarray,
    photo: Optional[Photometry],
    seed: int,
    frame_idx: int,
    flow_px: Optional[np.ndarray] = None,
    noise_stream: int = 0,
) -> np.ndarray:
    """Degrade one rendered frame. `noise_stream` decorrelates the noise of
    a stereo pair's views while their gain and bias stay shared (a rig
    slaves the right camera's exposure to the left's)."""
    if photo is None:
        return img
    rng = np.random.default_rng([seed, 7919, frame_idx])
    gain = rng.uniform(*photo.gain_range)
    bias = rng.uniform(*photo.bias_range)
    out = img.astype(np.float32)
    if photo.motion_blur_frac > 0.0 and flow_px is not None:
        length = min(photo.motion_blur_frac * float(np.linalg.norm(flow_px)),
                     photo.motion_blur_max_px)
        out = _motion_blur(out, np.asarray(flow_px, np.float64), length)
    out = gain * out + bias
    if photo.noise_sigma > 0.0 or photo.shot_noise > 0.0:
        nrng = np.random.default_rng([seed, 104729, frame_idx, noise_stream])
        sigma = np.sqrt(photo.noise_sigma ** 2
                        + photo.shot_noise ** 2 * np.clip(out, 0.0, 255.0) / 255.0)
        out = out + sigma * nrng.standard_normal(out.shape)
    return np.clip(out, 0.0, 255.0).astype(np.float32)


def _flow_px(
    cam: CameraConfig,
    R_prev: np.ndarray, t_prev: np.ndarray,
    R_cur: np.ndarray, t_cur: np.ndarray,
    depth: float = 9.0,
) -> np.ndarray:
    """Image displacement between the two frames of the point `depth` m
    straight ahead of the previous camera: the blur's direction and length."""
    p_world = R_prev.T @ (np.array([0.0, 0.0, depth]) - t_prev)
    pc = R_cur @ p_world + t_cur
    if pc[2] < 0.1:
        return np.zeros(2)
    u1 = np.array([cam.fx * pc[0] / pc[2] + cam.cx, cam.fy * pc[1] / pc[2] + cam.cy])
    u0 = np.array([cam.fx * 0.0 + cam.cx, cam.fy * 0.0 + cam.cy])
    return u1 - u0


def render(
    scene: Scene,
    R_cw: np.ndarray,
    t_cw: np.ndarray,
    cam: CameraConfig,
    background: float = 96.0,
    with_depth: bool = False,
    max_depth: float = np.inf,
):
    """Render image [H, W] float32 from camera pose (world -> camera). A
    camera with distortion coefficients images each landmark at its
    distorted pixel (the raw image of a real lens, which the pipeline
    undistorts keypoint by keypoint, src/Frame.cc:471-506; the warp within
    a patch is left out). With with_depth=True also returns a depth map
    [H, W] float32: the z of the landmark drawn at each pixel, 0 where none
    is (TUM RGB-D's invalid-depth convention). Landmarks beyond max_depth
    are not drawn (an opaque wall for scenes around the camera)."""
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
        xn, yn = pc[i, 0] / z[i], pc[i, 1] / z[i]
        if cam.has_distortion:
            xn, yn = _distort_np(xn, yn, cam)
        u = cam.fx * xn + cam.cx
        v = cam.fy * yn + cam.cy
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


def mount_rotation(yaw: float = 0.0, pitch: float = 0.0, roll: float = 0.0) -> np.ndarray:
    """Rz(roll) Rx(pitch) Ry(yaw), angles in radians: a raw camera's
    mounting rotation off its rectified frame (x_raw = R @ x_rect), as a
    stereo rig's cameras sit before rectification."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Rz @ Rx @ Ry


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


def drive_path(theta: np.ndarray, r0: float = 40.0, lobe: float = 0.18):
    """A closed city-block circuit, the ring r(th) = r0 (1 + lobe cos 4th):
    four smooth corners of faster yaw (KITTI-00-class loop geometry).
    -> centres [M, 3] in the y = 0 plane."""
    r = r0 * (1.0 + lobe * np.cos(4.0 * theta))
    return np.stack([r * np.sin(theta), np.zeros_like(theta), r * np.cos(theta)], -1)


def drive_scene(
    rng: np.random.Generator,
    n_points: int = 40000,
    r0: float = 40.0,
    lobe: float = 0.18,
    lateral_range: Tuple[float, float] = (4.0, 11.0),
    height: float = 3.0,
    patch_size: int = 11,
) -> Scene:
    """A street canyon along drive_path's circuit: landmarks in bands on
    both sides of the street (the building walls), jittered near-even
    along the arc so the sprites stay distinct; 10^4-10^5 landmarks, the
    map sizes of KITTI-class drives (Examples/Stereo/stereo_kitti.cc)."""
    n_side = n_points // 2
    th = (np.arange(n_side) + rng.uniform(0.1, 0.9, n_side)) * (2.0 * np.pi / n_side)
    centers = drive_path(th, r0, lobe)
    # The radial direction stands in for the path's outward normal.
    nrm = np.stack([np.sin(th), np.zeros_like(th), np.cos(th)], -1)
    out_pts = centers + nrm * rng.uniform(*lateral_range, n_side)[:, None]
    n_in = n_points - n_side
    th2 = (np.arange(n_in) + rng.uniform(0.1, 0.9, n_in)) * (2.0 * np.pi / n_in)
    centers2 = drive_path(th2, r0, lobe)
    nrm2 = np.stack([np.sin(th2), np.zeros_like(th2), np.cos(th2)], -1)
    in_pts = centers2 - nrm2 * rng.uniform(*lateral_range, n_in)[:, None]
    points = np.concatenate([out_pts, in_pts])
    points[:, 1] = rng.uniform(-height, height, n_points)
    proto = make_scene(rng, n_points=n_points, patch_size=patch_size)
    return Scene(points=points.astype(np.float64), patches=proto.patches,
                 patch_half=proto.patch_half)


def drive_trajectory(
    n_frames: int,
    r0: float = 40.0,
    lobe: float = 0.18,
    frac: float = 1.18,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A survey of drive_path heading along its tangent; frac > 1 drives
    the opening sector again, closing the loop at the end of the drive
    (KITTI 00's revisit). -> (R_cw, t_cw) per frame."""
    poses = []
    th = np.linspace(0.0, 2.0 * np.pi * frac, n_frames)
    c = drive_path(th, r0, lobe)
    fwd = np.gradient(c, axis=0)
    for k in range(n_frames):
        f = fwd[k] / max(np.linalg.norm(fwd[k]), 1e-9)
        yaw = np.arctan2(f[0], f[2])
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]).T
        poses.append((R_cw, -R_cw @ c[k]))
    return poses


def drive_frames(
    cam: CameraConfig,
    n_frames: int = 1600,
    n_points: int = 40000,
    seed: int = 0,
    r0: float = 40.0,
    lobe: float = 0.18,
    frac: float = 1.18,
    max_depth: float = 16.0,
    stereo: bool = False,
    photo: Optional[Photometry] = None,
):
    """(frames, poses, scene) of the KITTI-class drive: frames(start=0) is
    a generator of (index, image), or (index, left, right) with
    stereo=True (the right camera cam.baseline to the left camera's
    right), rendered on demand; poses are analytic and the photometric
    draws seeded by frame, so a start past 0 gives the same frames."""
    rng = np.random.default_rng(seed)
    scene = drive_scene(rng, n_points=n_points, r0=r0, lobe=lobe)
    poses = drive_trajectory(n_frames, r0=r0, lobe=lobe, frac=frac)
    b = cam.baseline if stereo else 0.0

    def frames(start=0):
        for k in range(start, len(poses)):
            R, t = poses[k]
            flow = None
            if photo is not None and photo.motion_blur_frac > 0.0 and k > 0:
                flow = _flow_px(cam, *poses[k - 1], *poses[k])
            left = render(scene, R, t, cam, max_depth=max_depth)
            left = apply_photometry(left, photo, seed, k, flow_px=flow)
            if stereo:
                right = render(scene, R, t - np.array([b, 0.0, 0.0]), cam,
                               max_depth=max_depth)
                right = apply_photometry(right, photo, seed, k, flow_px=flow,
                                         noise_stream=1)
                yield k, left, right
            else:
                yield k, left

    return frames, poses, scene


def figure8_path(s: np.ndarray, r: float = 25.0):
    """A figure-eight street circuit in the x-z plane: lobe A the circle of
    radius r centred at (r, 0, 0), lobe B the one centred at (-r, 0, 0);
    both pass through the origin heading +z, so the path crosses itself
    there smoothly. s in [0, 2 pi) runs lobe A, [2 pi, 4 pi) lobe B, and
    past 4 pi lobe A again: each lobe brings the camera back to the
    crossing after a lap of drift (KITTI 00 closes several loops,
    src/KeyFrame.cc:532-543). -> centres [M, 3]."""
    s = np.asarray(s, np.float64) % (4.0 * np.pi)
    on_a = s < 2.0 * np.pi
    u = np.where(on_a, s, s - 2.0 * np.pi)
    x = np.where(on_a, r - r * np.cos(u), -r + r * np.cos(u))
    z = r * np.sin(u)
    return np.stack([x, np.zeros_like(x), z], -1)


def figure8_trajectory(
    n_frames: int,
    r: float = 25.0,
    laps: float = 2.15,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A survey of figure8_path heading along its tangent, `laps` in lobes
    (2.15: lobe A, lobe B and 15% of lobe A again: two returns to the
    crossing, then a revisit to track on after the second closure).
    -> (R_cw, t_cw) per frame."""
    svals = np.linspace(0.0, 2.0 * np.pi * laps, n_frames)
    c = figure8_path(svals, r)
    fwd = np.gradient(c, axis=0)
    poses = []
    for k in range(n_frames):
        f = fwd[k] / max(np.linalg.norm(fwd[k]), 1e-9)
        yaw = np.arctan2(f[0], f[2])
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]).T
        poses.append((R_cw, -R_cw @ c[k]))
    return poses


def figure8_scene(
    rng: np.random.Generator,
    n_points: int = 60000,
    r: float = 25.0,
    lateral_range: Tuple[float, float] = (4.0, 11.0),
    height: float = 3.0,
    patch_size: int = 11,
) -> Scene:
    """A street canyon along both lobes of the figure-eight: bands on each
    side of the path, jittered near-even along the arc (drive_scene's
    design)."""
    n_lobe = n_points // 2
    pts = []
    for sign, n_l in ((1.0, n_lobe), (-1.0, n_points - n_lobe)):
        n_side = n_l // 2
        for side, n_s in ((1.0, n_side), (-1.0, n_l - n_side)):
            u = (np.arange(n_s) + rng.uniform(0.1, 0.9, n_s)) * (2.0 * np.pi / n_s)
            cx = sign * (r - r * np.cos(u))
            cz = sign * r * np.sin(u)
            # The outward radial normal from the lobe's centre (sign r, 0).
            nx = cx - sign * r
            nz = cz
            nn = np.sqrt(nx * nx + nz * nz) + 1e-9
            off = side * rng.uniform(*lateral_range, n_s)
            pts.append(np.stack([cx + off * nx / nn, rng.uniform(-height, height, n_s),
                                 cz + off * nz / nn], -1))
    points = np.concatenate(pts)
    proto = make_scene(rng, n_points=n_points, patch_size=patch_size)
    return Scene(points=points.astype(np.float64), patches=proto.patches,
                 patch_half=proto.patch_half)


def figure8_frames(
    cam: CameraConfig,
    n_frames: int = 1400,
    n_points: int = 60000,
    seed: int = 0,
    r: float = 25.0,
    laps: float = 2.15,
    max_depth: float = 12.0,
    stereo: bool = False,
    photo: Optional[Photometry] = None,
):
    """(frames, poses, scene) of the figure-eight drive, drive_frames'
    contract: frames(start=0) renders on demand, the same frames from any
    start."""
    rng = np.random.default_rng(seed)
    scene = figure8_scene(rng, n_points=n_points, r=r)
    poses = figure8_trajectory(n_frames, r=r, laps=laps)
    b = cam.baseline if stereo else 0.0

    def frames(start=0):
        for k in range(start, len(poses)):
            R, t = poses[k]
            flow = None
            if photo is not None and photo.motion_blur_frac > 0.0 and k > 0:
                flow = _flow_px(cam, *poses[k - 1], *poses[k])
            left = render(scene, R, t, cam, max_depth=max_depth)
            left = apply_photometry(left, photo, seed, k, flow_px=flow)
            if stereo:
                right = render(scene, R, t - np.array([b, 0.0, 0.0]), cam,
                               max_depth=max_depth)
                right = apply_photometry(right, photo, seed, k, flow_px=flow,
                                         noise_stream=1)
                yield k, left, right
            else:
                yield k, left

    return frames, poses, scene
