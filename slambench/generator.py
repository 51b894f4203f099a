"""The benchmark's frames, made from --seed on the device.

A frozen copy of the port's synthetic scene (utils/synthetic.py): landmark
sprites with a bright disc (one strong FAST corner), random blocks
(distinctive BRIEF) and a ramp (a stable orientation), set in bands on both
sides of a path (the KITTI-class street canyon of `drive_scene`; at a
smaller scale, a corridor). The path is data: the port's polar circuit
r(th) = r0 (1 + lobe cos 4 th), or a spline through waypoints, closed or
open, so a figure-eight or a route that crosses itself is a traffic file
and no code. The camera moves along the path's tangent at a fixed step a
frame, optionally with a handheld sway; each frame
is degraded as a real camera degrades it (read and shot noise, exposure
gain and bias, motion blur along the image flow).

What differs from the port's renderer is the cost model: `render` draws
every landmark of a view at once in plain PyTorch (a depth test per pixel
in place of drawing far to near), so a pool of frames is made in set-up on
the card and not inside the measured window. The same seed gives the same
frames; the trajectory does not depend on the seed, so every seed asks the
System for the same motion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SPRITE = 17            # sprite side, px (make_scene's max(patch_size, 17))
BACKGROUND = 96.0      # gray level where no landmark is drawn
MIN_Z = 0.5            # nearest landmark drawn, m


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera with the radial-tangential lens of the reference's
    settings (k1, k2, p1, p2, k3); bf = baseline x fx for a stereo rig."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.bf > 0 else 0.0

    @property
    def distorted(self) -> bool:
        return any(v != 0.0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def camera_from_config(cfg: Dict) -> Camera:
    """The `camera` block of a configuration file -> Camera."""
    keys = {f.name for f in dataclasses.fields(Camera)}
    return Camera(**{k: v for k, v in cfg["camera"].items() if k in keys})


# ---------------------------------------------------------------------------
# Path and trajectory (utils/synthetic.drive_path / drive_trajectory)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Curve:
    """A path in the y = 0 plane, densely sampled: points [M, 3], their arc
    length [M] (m) from the first, and whether the path closes on itself
    (the last point is then the first)."""

    points: np.ndarray
    s: np.ndarray
    closed: bool

    @property
    def length(self) -> float:
        return float(self.s[-1])

    def _wrap(self, s: np.ndarray) -> np.ndarray:
        s = np.asarray(s, np.float64)
        if self.closed:
            return np.mod(s, self.length)
        if s.min() < -1e-9 or s.max() > self.length + 1e-9:
            raise ValueError(f"arc length {s.min():.3f}..{s.max():.3f} m leaves an open "
                             f"path of {self.length:.3f} m")
        return np.clip(s, 0.0, self.length)

    def at(self, s) -> np.ndarray:
        """Points [n, 3] at arc lengths s."""
        s = self._wrap(s)
        return np.stack([np.interp(s, self.s, self.points[:, i]) for i in range(3)], -1)

    def normal(self, s) -> np.ndarray:
        """Unit normals [n, 3] in the plane at arc lengths s, to the left of
        the direction of travel (the side `side = +1` of the scene)."""
        d = self.at(np.asarray(s, np.float64) + 0.05) - self.at(np.asarray(s, np.float64) - 0.05)
        n = np.stack([-d[:, 2], np.zeros(len(d)), d[:, 0]], -1)
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


def path_points(theta: np.ndarray, r0: float, lobe: float) -> np.ndarray:
    """Centres [M, 3] of the closed polar path r(th) = r0 (1 + lobe cos 4 th)
    in the y = 0 plane."""
    r = r0 * (1.0 + lobe * np.cos(4.0 * theta))
    return np.stack([r * np.sin(theta), np.zeros_like(theta), r * np.cos(theta)], -1)


def _catmull_rom(P: np.ndarray, closed: bool, per_segment: int = 400) -> np.ndarray:
    """A uniform Catmull-Rom spline through the waypoints P [K, 2] (x, z)."""
    K = len(P)
    if closed:
        ext = np.concatenate([P[-1:], P, P[:2]])
        segments = K
    else:
        ext = np.concatenate([2.0 * P[:1] - P[1:2], P, 2.0 * P[-1:] - P[-2:-1]])
        segments = K - 1
    u = np.linspace(0.0, 1.0, per_segment, endpoint=False)[:, None]
    out = []
    for i in range(segments):
        p0, p1, p2, p3 = ext[i], ext[i + 1], ext[i + 2], ext[i + 3]
        out.append(0.5 * (2.0 * p1 + (p2 - p0) * u + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * u ** 2
                          + (3.0 * p1 - p0 - 3.0 * p2 + p3) * u ** 3))
    out.append((P[0] if closed else P[-1])[None])
    xz = np.concatenate(out)
    return np.stack([xz[:, 0], np.zeros(len(xz)), xz[:, 1]], -1)


def curve(path: Dict) -> Curve:
    """The traffic's `path` as a Curve. Two kinds, both plain data:
    `{"kind": "polar", "r0", "lobe"}`, the closed circuit
    r(th) = r0 (1 + lobe cos 4 th) of the port's drives, and
    `{"kind": "waypoints", "points": [[x, z], ...], "closed"}`, a spline
    through the points (a figure-eight, a route with a crossing)."""
    kind = path.get("kind", "polar")
    if kind == "polar":
        pts = path_points(np.linspace(0.0, 2.0 * np.pi, 20001), path["r0"], path["lobe"])
        closed = True
    elif kind == "waypoints":
        closed = bool(path.get("closed", True))
        pts = _catmull_rom(np.asarray(path["points"], np.float64), closed)
    else:
        raise ValueError(f"unknown path kind {kind!r}")
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0), axis=1))])
    return Curve(points=pts, s=s, closed=closed)


def step_m(path: Dict) -> float:
    """The path's spacing a frame: `step_m`, or one lap over `lap_frames`
    (a circuit driven again and again, whose last frame leads into its
    first by one step)."""
    if "lap_frames" in path:
        return curve(path).length / path["lap_frames"]
    return path["step_m"]


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def frame_arcs(traffic: Dict, n: int) -> np.ndarray:
    """Arc lengths (m) of n + 1 frames along the path: `start_m` and then
    one step a frame."""
    p = traffic["path"]
    return float(p.get("start_m", 0.0)) + step_m(p) * np.arange(n + 1)


def trajectory(traffic: Dict, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(R_cw, t_cw) of the left (or only) camera for n frames along the
    traffic's path, heading along its tangent, with the handheld sway of
    `sway` (lateral and vertical amplitude, m; yaw and pitch amplitude,
    deg; period, frames) where the traffic has one."""
    c = curve(traffic["path"]).at(frame_arcs(traffic, n))
    sway = traffic.get("sway")
    poses = []
    for k in range(n):
        f = c[k + 1] - c[k]
        yaw = math.atan2(f[0], f[2])
        centre = c[k].copy()
        R_wc = _rot_y(yaw)
        if sway:
            ph = 2.0 * math.pi * k / sway["period_frames"]
            left = R_wc @ np.array([1.0, 0.0, 0.0])
            centre = (centre + sway["lateral_m"] * math.sin(ph) * left
                      + np.array([0.0, sway["vertical_m"] * math.sin(2.0 * ph + 0.7), 0.0]))
            R_wc = (R_wc @ _rot_y(math.radians(sway["yaw_deg"]) * math.sin(ph + 0.3))
                    @ _rot_x(math.radians(sway["pitch_deg"]) * math.sin(1.3 * ph)))
        R_cw = R_wc.T
        poses.append((R_cw, -R_cw @ centre))
    return poses


# ---------------------------------------------------------------------------
# Scene (utils/synthetic.make_scene's textures, drive_scene's bands)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Scene:
    points: torch.Tensor      # [P, 3] float64 world coordinates
    patches: torch.Tensor     # [P, S, S] float32 textures, 0..255


def sprites(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, S, S] float32 landmark textures: random blocks of 55 / 165, a
    directional ramp of +-35, a bright disc of radius 2.5 px at the centre."""
    s, half = SPRITE, SPRITE // 2
    tex = torch.where(torch.rand((n, s, s), generator=gen, device=device) > 0.5, 165.0, 55.0)
    theta = torch.rand(n, generator=gen, device=device) * (2.0 * math.pi)
    yy, xx = torch.meshgrid(torch.arange(s, device=device, dtype=torch.float32),
                            torch.arange(s, device=device, dtype=torch.float32), indexing="ij")
    yc, xc = (yy - half) / half, (xx - half) / half
    ramp = torch.cos(theta)[:, None, None] * xc + torch.sin(theta)[:, None, None] * yc
    patches = torch.clamp(tex + 35.0 * ramp, 0.0, 255.0)
    disc = (yy - half) ** 2 + (xx - half) ** 2 <= 2.5 ** 2
    return torch.where(disc, torch.full_like(patches, 250.0), patches)


def _clear_of_path(pts: torch.Tensor, path: np.ndarray, clear: torch.Tensor) -> torch.Tensor:
    """[P] bool: landmarks at least `clear` (per landmark, m) from every
    point of the path in the ground plane (a bend's inside, a crossing)."""
    ref = torch.as_tensor(path[:, [0, 2]], dtype=torch.float64, device=pts.device)
    keep = torch.empty(pts.shape[0], dtype=torch.bool, device=pts.device)
    for i in range(0, pts.shape[0], 8192):
        d = torch.cdist(pts[i:i + 8192][:, [0, 2]], ref).amin(1)
        keep[i:i + 8192] = d >= clear[i:i + 8192] - 1e-6
    return keep


def scene(traffic: Dict, gen: torch.Generator, device, n_frames: int) -> Scene:
    """Landmark bands on both sides of the path, along the stretch that the
    pool's n_frames cover and a margin beyond it: `per_m` landmarks a
    metre of path on each side, `lateral_m` from the path, heights in
    +-`height_m`, jittered near-even along the arc so the sprites stay
    distinct; none nearer the path than its band's `lateral_m[0]`
    anywhere. An `inner` block ({"per_m", "lateral_m"}) gives the band on
    the right of travel (a circuit's inside) its own density and
    distances (a roundabout's island)."""
    sc = traffic["scene"]
    cv = curve(traffic["path"])
    arcs = frame_arcs(traffic, n_frames)
    lo, hi = float(arcs.min()) - sc["margin_m"], float(arcs.max()) + sc["margin_m"]
    if cv.closed:
        hi = min(hi, lo + cv.length)
    else:
        lo, hi = max(lo, 0.0), min(hi, cv.length)
    length = hi - lo
    span = cv.at(np.linspace(lo, hi, max(int(length / 0.25), 2)))
    pts = []
    for side in (1.0, -1.0):
        band = dict(sc, **sc.get("inner", {})) if side < 0 else sc
        n_side = max(int(length * band["per_m"]), 1)
        u = torch.rand(n_side, generator=gen, device=device, dtype=torch.float64)
        s = lo + (torch.arange(n_side, device=device, dtype=torch.float64) + 0.1 + 0.8 * u) \
            * (length / n_side)
        s_np = s.cpu().numpy()
        centre = torch.as_tensor(cv.at(s_np), device=device)
        normal = torch.as_tensor(cv.normal(s_np), device=device)
        off = band["lateral_m"][0] + (band["lateral_m"][1] - band["lateral_m"][0]) * torch.rand(
            n_side, generator=gen, device=device, dtype=torch.float64)
        y = (2.0 * torch.rand(n_side, generator=gen, device=device, dtype=torch.float64)
             - 1.0) * band["height_m"]
        p = centre + side * off[:, None] * normal
        p[:, 1] = y
        clear = torch.full((n_side,), float(band["lateral_m"][0]), dtype=torch.float64,
                           device=device)
        pts.append(p[_clear_of_path(p, span, clear)])
    points = torch.cat(pts)
    return Scene(points=points, patches=sprites(points.shape[0], gen, device))


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _distort(xn, yn, cam: Camera):
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = xn * radial + 2.0 * cam.p1 * xn * yn + cam.p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + cam.p1 * (r2 + 2.0 * yn * yn) + 2.0 * cam.p2 * xn * yn
    return xd, yd


def _aa_blur(img: torch.Tensor, sigma: float = 0.7) -> torch.Tensor:
    """Separable 5-tap Gaussian, edges replicated (the optics' stand-in)."""
    x = torch.arange(-2, 3, dtype=torch.float32, device=img.device)
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    k = k / k.sum()
    t = F.pad(img[None, None], (2, 2, 2, 2), mode="replicate")
    t = F.conv2d(t, k.view(1, 1, 1, 5))
    t = F.conv2d(t, k.view(1, 1, 5, 1))
    return t[0, 0]


def render(sc: Scene, R_cw: np.ndarray, t_cw: np.ndarray, cam: Camera,
           max_depth: float = math.inf) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image [H, W] float32, depth [H, W] float32) of the view: each
    landmark between MIN_Z and max_depth whose sprite lies inside the image
    is splatted bilinearly at its (distorted) pixel, and at every pixel the
    nearest sprite wins; depth is that sprite's z, 0 where none is (TUM
    RGB-D's invalid depth)."""
    dev = sc.points.device
    h, w = cam.height, cam.width
    half, s = SPRITE // 2, SPRITE
    R = torch.as_tensor(R_cw, dtype=torch.float64, device=dev)
    t = torch.as_tensor(t_cw, dtype=torch.float64, device=dev)
    pc = sc.points @ R.T + t
    z = pc[:, 2]
    keep = (z >= MIN_Z) & (z <= max_depth)
    xn, yn = pc[:, 0] / z, pc[:, 1] / z
    if cam.distorted:
        xn, yn = _distort(xn, yn, cam)
    u = cam.fx * xn + cam.cx
    v = cam.fy * yn + cam.cy
    keep &= (u >= half + 2) & (u < w - half - 2) & (v >= half + 2) & (v < h - half - 2)
    idx = torch.nonzero(keep)[:, 0]
    img = torch.full((h * w,), BACKGROUND, dtype=torch.float32, device=dev)
    depth = torch.zeros(h * w, dtype=torch.float32, device=dev)
    if idx.numel():
        u, v, z = u[idx], v[idx], z[idx].to(torch.float32)
        u0, v0 = torch.floor(u), torch.floor(v)
        fu, fv = (u - u0).to(torch.float32), (v - v0).to(torch.float32)
        m = idx.numel()
        p = F.pad(sc.patches[idx], (1, 1, 1, 1))                  # [m, s+2, s+2]
        one = F.pad(torch.ones((1, s, s), device=dev), (1, 1, 1, 1))
        wts = [((1 - fu) * (1 - fv)), (fu * (1 - fv)), ((1 - fu) * fv), (fu * fv)]
        # Footprint pixel (a, b) takes patch pixel (a - dy, b - dx) with
        # the weight of the corner (dy, dx).
        acc = torch.zeros((m, s + 1, s + 1), device=dev)
        wgt = torch.zeros((m, s + 1, s + 1), device=dev)
        for (dy, dx), wc in zip(((0, 0), (0, 1), (1, 0), (1, 1)), wts):
            acc += wc[:, None, None] * p[:, 1 - dy:s + 2 - dy, 1 - dx:s + 2 - dx]
            wgt += wc[:, None, None] * one[:, 1 - dy:s + 2 - dy, 1 - dx:s + 2 - dx]
        val = acc / torch.clamp_min(wgt, 1e-6)
        top = (v0.long() - half)[:, None, None] + torch.arange(s + 1, device=dev)[None, :, None]
        left = (u0.long() - half)[:, None, None] + torch.arange(s + 1, device=dev)[None, None, :]
        pix = (top * w + left).reshape(-1)
        covered = (wgt > 1e-6).reshape(-1)
        # The nearest sprite at each pixel: z's bits order like z (z > 0),
        # the landmark's rank breaks ties.
        zbits = z.view(torch.int32).to(torch.int64)
        key = ((zbits << 24) | torch.arange(m, device=dev))[:, None, None].expand(
            m, s + 1, s + 1).reshape(-1)
        big = torch.iinfo(torch.int64).max
        key = torch.where(covered, key, torch.full_like(key, big))
        best = torch.full((h * w,), big, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, pix, key, reduce="amin")
        win = covered & (best[pix] == key)
        img[pix[win]] = val.reshape(-1)[win]
        depth[pix[win]] = z[:, None, None].expand(m, s + 1, s + 1).reshape(-1)[win]
    return _aa_blur(img.view(h, w)), depth.view(h, w)


# ---------------------------------------------------------------------------
# Photometry (utils/synthetic.Photometry, apply_photometry)
# ---------------------------------------------------------------------------

def flow_px(cam: Camera, prev, cur, depth: float) -> np.ndarray:
    """Image displacement between two frames of the point `depth` m
    straight ahead of the previous camera: the blur's direction and
    length."""
    (R0, t0), (R1, t1) = prev, cur
    pw = R0.T @ (np.array([0.0, 0.0, depth]) - t0)
    pc = R1 @ pw + t1
    if pc[2] < 0.1:
        return np.zeros(2)
    return np.array([cam.fx * pc[0] / pc[2], cam.fy * pc[1] / pc[2]])


def _shift(img: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Bilinear sample of img at (x + dx, y + dy), edges clamped."""
    h, w = img.shape
    ys = torch.arange(h, device=img.device, dtype=torch.float32) + dy
    xs = torch.arange(w, device=img.device, dtype=torch.float32) + dx
    gy = (2.0 * ys + 1.0) / h - 1.0
    gx = (2.0 * xs + 1.0) / w - 1.0
    grid = torch.stack(torch.meshgrid(gy, gx, indexing="ij")[::-1], -1)[None]
    return F.grid_sample(img[None, None], grid, mode="bilinear", padding_mode="border",
                         align_corners=False)[0, 0]


def degrade(img: torch.Tensor, photo: Dict, gen: torch.Generator,
            gain_bias: Tuple[float, float], flow: Optional[np.ndarray]) -> torch.Tensor:
    """Motion blur along `flow` (motion_blur_frac x its length, at most
    motion_blur_max_px), then gain and bias, then read and shot noise."""
    out = img
    frac = photo.get("motion_blur_frac", 0.0)
    if frac > 0.0 and flow is not None:
        length = min(frac * float(np.linalg.norm(flow)), photo["motion_blur_max_px"])
        if length >= 0.5:
            n = max(int(math.ceil(length)) + 1, 2)
            d = flow / max(float(np.linalg.norm(flow)), 1e-9)
            out = sum(_shift(img, d[0] * o, d[1] * o)
                      for o in np.linspace(-0.5 * length, 0.5 * length, n)) / n
    gain, bias = gain_bias
    out = gain * out + bias
    sigma = torch.sqrt(photo["noise_sigma"] ** 2
                       + photo["shot_noise"] ** 2 * torch.clamp(out, 0.0, 255.0) / 255.0)
    out = out + sigma * torch.randn(out.shape, generator=gen, device=out.device)
    return torch.clamp(out, 0.0, 255.0)


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pool:
    """A traffic's frames on the host, as a camera driver hands them: uint8
    images (the right ones of a stereo rig), uint16 depth maps in the TUM
    convention (depth x depth_map_factor, 0 for none), the left camera's
    ground-truth poses (R_cw, t_cw) and the scene they were rendered from."""

    left: torch.Tensor
    right: Optional[torch.Tensor]
    depth: Optional[torch.Tensor]
    poses: List[Tuple[np.ndarray, np.ndarray]]
    scene: Scene

    def __len__(self) -> int:
        return self.left.shape[0]

    def depth_image(self, k: int) -> np.ndarray:
        """Frame k's depth map as the uint16 array a TUM RGB-D driver reads."""
        return self.depth[k].numpy().view(np.uint16)


def make_pool(traffic: Dict, cfg: Dict, seed: int, device, pin: bool = True) -> Pool:
    """The traffic's pool of `pool_frames` frames for the configuration's
    sensor, rendered on `device` with a generator seeded by `seed`, then
    copied to (pinned) host memory."""
    n = traffic["pool_frames"]
    cam = camera_from_config(cfg)
    sensor = cfg["sensor"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    poses = trajectory(traffic, n)
    sc = scene(traffic, gen, device, n)
    photo = traffic["photometry"]
    max_depth = traffic["scene"]["max_depth_m"]
    factor = cfg["camera"].get("depth_map_factor", 1.0)
    shape = (n, cam.height, cam.width)
    left = torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
    right = torch.empty(shape, dtype=torch.uint8, pin_memory=pin) if sensor == "stereo" else None
    # uint16 depth maps, held as int16 with the same bits (torch has no
    # pinned uint16); Pool.depth_image views them back.
    depth = torch.empty(shape, dtype=torch.int16, pin_memory=pin) if sensor == "rgbd" else None
    gains = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64).cpu().numpy()
    lo_g, hi_g = photo["gain_range"]
    lo_b, hi_b = photo["bias_range"]
    for k, (R, t) in enumerate(poses):
        gb = (lo_g + (hi_g - lo_g) * gains[k, 0], lo_b + (hi_b - lo_b) * gains[k, 1])
        flow = flow_px(cam, poses[k - 1], poses[k], photo["blur_depth_m"]) if k else None
        img, z = render(sc, R, t, cam, max_depth)
        left[k].copy_(torch.round(degrade(img, photo, gen, gb, flow)).to(torch.uint8))
        if right is not None:
            img_r, _ = render(sc, R, t - np.array([cam.baseline, 0.0, 0.0]), cam, max_depth)
            right[k].copy_(torch.round(degrade(img_r, photo, gen, gb, flow)).to(torch.uint8))
        if depth is not None:
            depth[k].copy_(torch.clamp(torch.round(z * factor), 0, 65535).to(torch.int32)
                           .to(torch.int16))
    return Pool(left=left, right=right, depth=depth, poses=poses, scene=sc)
