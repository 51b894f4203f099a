"""Entry points that move state into and out of the port.

- `to_device`, `to_host`: one host array to a tensor on a device (uint32
  descriptors as int32 bits, floats as float32), and a tensor back.
- `map_from_numpy`: the tracking step's inputs as numpy arrays (the JAX
  package's layout: uint32 descriptors) -> tensors on a device.
- `packed_from_numpy`: the fused pair's packed inputs (`pt_f32 [M, 6]`,
  `meta_f32 [13]`, `feat_state [N, 4]`, `cand_f32 [M, 9]`, descriptor
  tables [M, 8], ...) -> tensors on a device, in the JAX package's layouts.
- `local_map_args`: the local-map stage's arguments built on the device
  from the motion stage's packed output, as the tracker's host code builds
  them.
- `features_to_numpy`, `step_to_numpy`, `packed_to_numpy`: the port's
  results -> numpy, with descriptors as uint32 again.
- `make_example`, `make_fused_example`: a synthetic frame pair, and the
  last-frame points and local-map candidates built from frame 0 with the
  port's own extractor: the port's twins of the JAX package's
  `__graft_entry__._make_example`. `make_fused_example` takes the sensor:
  monocular, stereo (frame 1's right image too) or RGB-D (frame 1's depth
  map too).
- `top2_problem`, `TOP2_CASES`: K6 (projection Hamming top-2) problems from
  a seed, in the JAX kernel's argument order; the CPU tests hold the port
  to the JAX package on them and `chip_smoke.py` holds the kernel to its
  plain version on them.
- `band_problem`, `BAND_CASES`, `BAND_MAX_D`, `BAND_SCALES`: K7 stereo-band
  problems from a seed (numpy), one of them built on the band test's exact
  edges, for the same two uses.
- `candidate_problem`, `CANDIDATE_CASES`, `CANDIDATE_CARD_CASES`: K7
  problems under a candidate test (validity flags, a window, the epipolar
  band) from a seed, batched with either side shared and with the tests'
  edges, for the same two uses.
- `patch_edge_yx`: keypoint centres at and past every edge of an image,
  for the patch kernels (K4 and the fused K4 + K5), for the same two uses.
- `map_state_to_numpy` / `map_state_from_numpy`, `frame_to_numpy` /
  `frame_from_numpy`, `tracker_state_to_numpy` / `tracker_state_into`,
  `recent_points_to_numpy` / `recent_points_from_numpy`: a System's host
  state (the map tables, a Frame, the fields a tracker step reads, the
  mapper's recent-point list) as plain numpy arrays and scalars, and
  back into the port's objects. The `_to_numpy` side reads any object with
  the JAX package's attribute names, so a JAX System's state carries
  across into the port's.
- `database_to_numpy` / `database_from_numpy`,
  `loop_closer_state_to_numpy` / `loop_closer_state_into`: a keyframe
  database's sparse rows and a loop closer's host state (its consistent
  groups, last loop keyframe and loop count), the same way.

Every entry point that places tensors takes `device`, "cuda" by default;
without a card that default raises instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.ops import extractor as ext
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import SLAMConfig, synthetic_config


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    return dev


def to_device(a, dev) -> torch.Tensor:
    """numpy -> tensor on dev: uint32 keeps its bits as int32, other
    integers become int32, floats float32, bools stay bool."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def image_to_device(image, dev) -> torch.Tensor:
    """A gray image (numpy) -> tensor on dev: 8-bit images stay uint8, so
    the upload moves 1 byte a pixel (the extraction casts to float32 on
    the device), any other dtype becomes float32."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device -> numpy (waits for the device)."""
    return t.detach().cpu().numpy()


def map_from_numpy(
    image: np.ndarray,
    pt_pos: np.ndarray,
    pt_desc: np.ndarray,
    pt_octave: np.ndarray,
    pt_angle: np.ndarray,
    pt_valid: np.ndarray,
    R_pred: np.ndarray,
    t_pred: np.ndarray,
    device="cuda",
) -> Tuple[torch.Tensor, ...]:
    """Tracking-step inputs as numpy -> the step's tensor arguments
    (image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R_pred, t_pred)
    on `device`. Floats become float32; uint32 descriptors keep their bits
    as int32."""
    dev = resolve_device(device)
    return tuple(to_device(a, dev) for a in (
        image, pt_pos, np.asarray(pt_desc, np.uint32), pt_octave, pt_angle,
        np.asarray(pt_valid, bool), R_pred, t_pred))


def packed_from_numpy(*arrays: np.ndarray, device="cuda") -> Tuple[torch.Tensor, ...]:
    """The fused pair's packed inputs as numpy (image, pt_f32, pt_desc,
    meta_f32 for the motion stage; feat_dev, desc_dev, feat_state,
    cand_f32, cand_desc, meta_f32 for the local-map stage) -> tensors on
    `device`: float matrices as float32, uint32 descriptor tables as int32
    bits."""
    dev = resolve_device(device)
    return tuple(to_device(a, dev) for a in arrays)


def features_to_numpy(feats: ext.Features) -> Dict[str, np.ndarray]:
    out = {k: v.detach().cpu().numpy() for k, v in feats._asdict().items()}
    out["desc"] = out["desc"].view(np.uint32)
    return out


def step_to_numpy(res) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}


def packed_to_numpy(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """A packed result ((meta, feat, desc) of the motion stage, (meta,
    perfeat, visible) of the local-map stage) -> numpy; int32 descriptor
    tables [N, 8] become uint32 again."""
    out = []
    for t in tensors:
        a = t.detach().cpu().numpy()
        if a.dtype == np.int32 and a.ndim == 2 and a.shape[1] == 8:
            a = a.view(np.uint32)
        out.append(a)
    return tuple(out)


def local_map_args(motion_out, pt_f32: torch.Tensor, th: float):
    """The local-map stage's (feat_state [N, 4], meta_f32 [13]) from the
    motion stage's packed output, on its device and without waiting for
    it: a feature stays bound to its last-frame point when the pose BA
    kept it as an inlier (slam/tracking.py:412-419); the pose is the
    motion stage's; th is the search radius."""
    meta, feat, _ = motion_out
    binding = feat[:, 10].to(torch.int64)
    bound = (binding >= 0) & (feat[:, 11] > 0.5)
    feat_state = torch.cat(
        [pt_f32[torch.clamp_min(binding, 0), 0:3],
         bound[:, None].to(torch.float32)], dim=1)
    lm_meta = torch.cat([meta[0:12], torch.full((1,), th, device=meta.device)])
    return feat_state, lm_meta


def _frame0_associations(config: SLAMConfig, image0, pose0, points, dev):
    """Frame 0 through the port's extractor on dev, and each feature's
    nearest landmark projection: (features as numpy, nearest landmark [N],
    pixel distance to it [N], associated [N] = within 4 px and valid)."""
    feats0 = features_to_numpy(ext.extract_features(
        torch.from_numpy(image0).to(dev), config.orb,
        config.camera.height, config.camera.width))
    cam = config.camera
    R0, t0 = pose0
    pc = points @ R0.T + t0
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    d = np.linalg.norm(feats0["xy"][:, None] - uv[None], axis=-1)
    nearest, dmin = d.argmin(1), d.min(1)
    return feats0, nearest, dmin, (dmin < 4.0) & feats0["valid"]


def _scene(width, height, n_features, n_frames, sensor="monocular"):
    config = synthetic_config(width=width, height=height, n_features=n_features,
                              sensor=sensor)
    images, poses, scene = synthetic.render_sequence(
        config.camera, n_frames=n_frames, n_points=200, seed=11, step=0.04)
    return config, images, poses, scene


def _last_frame_points(feats0, nearest, assoc, points, n_points):
    """Up to n_points associated frame-0 features as the last frame's
    points: (pos [M, 3], desc [M, 8] uint32, octave, angle, valid); empty
    rows carry random descriptors and valid = False."""
    rng = np.random.default_rng(0)
    m = n_points
    pt_pos = np.zeros((m, 3))
    pt_desc = rng.integers(0, 2 ** 32, size=(m, 8), dtype=np.uint32)
    pt_octave = np.zeros(m, np.int32)
    pt_angle = np.zeros(m, np.float32)
    pt_valid = np.zeros(m, bool)
    rows = np.where(assoc)[0][:m]
    k = rows.size
    pt_pos[:k] = points[nearest[rows]]
    pt_desc[:k] = feats0["desc"][rows]
    pt_octave[:k] = feats0["octave"][rows]
    pt_angle[:k] = feats0["angle"][rows]
    pt_valid[:k] = True
    return pt_pos, pt_desc, pt_octave, pt_angle, pt_valid


def make_example(
    width: int = 320,
    height: int = 240,
    n_features: int = 400,
    n_points: int = 256,
    device="cuda",
    n_frames: int = 2,
) -> Tuple[SLAMConfig, Tuple[torch.Tensor, ...]]:
    """(config, args) for tracking_forward_step(*args, config).

    Renders a synthetic sequence (seed 11), extracts frame 0 with the
    port's extractor on `device`, binds each valid feature within 4 px of
    a landmark's projection to that landmark, and packs up to n_points of
    them as the local map. args[0] is frame 1 and the pose prediction is
    frame 1's ground truth, as in the JAX package's example. The config is
    the default one: subpixel refinement on."""
    dev = resolve_device(device)
    config, images, poses, scene = _scene(width, height, n_features, n_frames)
    feats0, nearest, _, assoc = _frame0_associations(
        config, images[0], poses[0], scene.points, dev)
    pts = _last_frame_points(feats0, nearest, assoc, scene.points, n_points)
    R_pred, t_pred = poses[1]
    args = map_from_numpy(images[1], *pts, R_pred, t_pred, device=dev)
    return config, args


def fused_example_arrays(
    width: int = 320,
    height: int = 240,
    n_features: int = 400,
    n_points: int = 256,
    n_candidates: int = 512,
    device="cuda",
    sensor: str = "monocular",
) -> Tuple[SLAMConfig, Dict[str, np.ndarray]]:
    """The fused pair's inputs as numpy arrays in the JAX package's
    layouts: image [H, W] (frame 1, the left image of a stereo pair),
    pt_f32 [n_points, 6], pt_desc [n_points, 8] uint32, meta_f32 [13],
    cand_f32 [n_candidates, 9], cand_desc [n_candidates, 8] uint32; for
    sensor "stereo" also image_r [H, W], frame 1's right image (the camera
    displaced by the baseline along its x-axis); for "rgbd" also depth
    [H, W], frame 1's depth map. The prediction in meta_f32 is frame 1's
    ground truth, and meta_f32[12] = tz_rel, the z of frame 1's camera
    centre in frame 0's camera coordinates.

    The last-frame points are make_example's, from the (left) image of
    frame 0. Each landmark with an
    associated frame-0 feature (the nearest of them) is a local-map
    candidate: normal = unit(X - C0) with C0 frame 0's camera centre,
    max_dist = |X - C0| * 1.2^octave, min_dist = max_dist / 1.2^(L-1)
    (MapPoint::UpdateNormalAndDepth), the feature's descriptor. Rows past
    them stay zero with valid = 0, as the tracker pads its table
    (slam/tracking.py:862-870)."""
    dev = resolve_device(device)
    config, images, poses, scene = _scene(width, height, n_features, 2, sensor)
    feats0, nearest, dmin, assoc = _frame0_associations(
        config, images[0], poses[0], scene.points, dev)
    pt_pos, pt_desc, pt_octave, pt_angle, pt_valid = _last_frame_points(
        feats0, nearest, assoc, scene.points, n_points)
    pt_f32 = np.stack([*pt_pos.T, pt_octave, pt_angle, pt_valid], 1).astype(np.float32)
    R0, t0 = poses[0]
    R_pred, t_pred = poses[1]
    tz_rel = (R0 @ (-R_pred.T @ t_pred) + t0)[2]
    meta_f32 = np.concatenate([np.reshape(R_pred, -1), t_pred, [tz_rel]]).astype(np.float32)
    sensor_arrays = {}
    if sensor == "stereo":
        sensor_arrays["image_r"] = synthetic.render(
            scene, *synthetic.right_pose(R_pred, t_pred, config.camera.baseline),
            config.camera)
    elif sensor == "rgbd":
        sensor_arrays["depth"] = synthetic.render(
            scene, R_pred, t_pred, config.camera, with_depth=True)[1]

    orb = config.orb
    center = -np.asarray(R0).T @ np.asarray(t0)
    cand_f32 = np.zeros((n_candidates, 9), np.float32)
    cand_desc = np.zeros((n_candidates, 8), np.uint32)
    row = 0
    for j in range(scene.points.shape[0]):
        feats = np.where(assoc & (nearest == j))[0]
        if feats.size == 0 or row == n_candidates:
            continue
        f = feats[np.argmin(dmin[feats])]
        po = scene.points[j] - center
        dist = np.linalg.norm(po)
        max_dist = dist * orb.scale_factor ** int(feats0["octave"][f])
        cand_f32[row] = [*scene.points[j], *(po / dist),
                         max_dist / orb.scale_factor ** (orb.n_levels - 1), max_dist, 1.0]
        cand_desc[row] = feats0["desc"][f]
        row += 1
    return config, dict(image=images[1], pt_f32=pt_f32, pt_desc=pt_desc,
                        meta_f32=meta_f32, cand_f32=cand_f32, cand_desc=cand_desc,
                        **sensor_arrays)


def make_fused_example(
    width: int = 320,
    height: int = 240,
    n_features: int = 400,
    n_points: int = 256,
    n_candidates: int = 512,
    device="cuda",
    sensor: str = "monocular",
) -> Tuple[SLAMConfig, Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """(config, motion_args, candidates) for the fused pair on `device`:
    the motion stage's packed entry point for the sensor,
    fused_motion_track_packed(*motion_args, config) with motion_args =
    (image, pt_f32, pt_desc, meta_f32), fused_stereo_motion_track_packed
    with (image, image_r, ...) or fused_rgbd_motion_track_packed with
    (image, depth, ...); then fused_local_map_track(feat, desc,
    *local_map_args(...), ...) with candidates = (cand_f32, cand_desc).
    See fused_example_arrays."""
    dev = resolve_device(device)
    config, a = fused_example_arrays(width, height, n_features, n_points,
                                     n_candidates, dev, sensor)
    images = [a["image"]] + [a[k] for k in ("image_r", "depth") if k in a]
    motion = packed_from_numpy(*images, a["pt_f32"], a["pt_desc"],
                               a["meta_f32"], device=dev)
    cands = packed_from_numpy(a["cand_f32"], a["cand_desc"], device=dev)
    return config, motion, cands


# K6 cases: a square-ish one, one past 256 rows and 512 columns, ties,
# masked rows (a row with a single candidate at column 0 among them), one
# column.
TOP2_CASES = {
    "64x200": dict(seed=11, m=64, n=200),
    "257x513": dict(seed=11, m=257, n=513),
    "ties": dict(seed=4, m=96, n=300, ties=True),
    "masked": dict(seed=5, m=40, n=150, masked_rows=8),
    "one_column": dict(seed=6, m=20, n=1),
}


def top2_problem(seed, m, n, ties=False, masked_rows=0):
    """A K6 problem in numpy: (desc_a, proj, radius, oct_lo, oct_hi,
    valid_a, desc_b, xy_b, octave_b, valid_b), descriptors uint32."""
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2 ** 32, size=(m, 8), dtype=np.uint32)
    db = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)
    if ties:
        # Few distinct descriptors: many equal distances per row.
        db = db[rng.integers(0, 4, n)]
        da = da[rng.integers(0, 4, m)]
    proj = rng.uniform(0, 640, (m, 2)).astype(np.float32)
    xy = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    radius = rng.uniform(10, 120, m).astype(np.float32)
    pt_oct = rng.integers(0, 8, m).astype(np.int32)
    octave = rng.integers(0, 8, n).astype(np.int32)
    valid_a = rng.random(m) < 0.9
    valid_b = rng.random(n) < 0.9
    if masked_rows:
        radius[:masked_rows] = 0.25            # at most a lucky candidate
        valid_a[masked_rows:2 * masked_rows] = False
        # one row with a single candidate at column 0
        proj[2 * masked_rows] = xy[0]
        radius[2 * masked_rows] = 0.0
        valid_b[0] = True
        octave[0] = pt_oct[2 * masked_rows]
    return (da, proj, radius, pt_oct - 1, pt_oct + 1, valid_a,
            db, xy, octave, valid_b)


# K7 on the stereo band. BAND_MAX_D is a Python float whose float32 value
# (the one PyTorch compares a float32 disparity with) lies above it;
# BAND_SCALES are the default ORB scale factors 1.2**i in float32.
BAND_MAX_D = 342.8080423874833
BAND_SCALES = np.asarray([1.2 ** i for i in range(8)], np.float32)
BAND_CASES = {
    "300x280": dict(seed=21, n_l=300, n_r=280),
    "edges": dict(seed=22, n_l=64, n_r=48, edges=True),
    "ties": dict(seed=23, n_l=120, n_r=100, ties=True),
    "one_column": dict(seed=24, n_l=30, n_r=1),
}


def band_problem(seed, n_l, n_r, edges=False, ties=False):
    """A K7 band problem in numpy: (desc_l, xy_l, octave_l, valid_l,
    desc_r, xy_r, octave_r, valid_r), descriptors uint32; scale_l is
    BAND_SCALES[clip(octave_l, 0, 7)] and max_d BAND_MAX_D. Keypoints lie
    at y in [100, 160), so a row has a few dozen candidates. With edges
    (n_l >= 8, n_r >= 16), rows 0-7 and columns 0-15 sit on rows of their
    own (no other keypoint within 8 px in y) and test each edge of the
    band: disparities of exactly f32(max_d) and its two float32
    neighbours (row 0), exactly -2 and its neighbours (row 1), |dy| of
    exactly 2 scale_l and its neighbours (row 2, octave 1), right octaves
    at +-1 and +-2 (row 3, octave 3), an invalid row whose one candidate
    column is then a right row with none (row 4), a row with no candidate
    (row 5), and two rows with one candidate each, the same column at the
    same distance (rows 6, 7), beside an invalid column that would match."""
    rng = np.random.default_rng(seed)
    dl = rng.integers(0, 2 ** 32, size=(n_l, 8), dtype=np.uint32)
    dr = rng.integers(0, 2 ** 32, size=(n_r, 8), dtype=np.uint32)
    if ties:
        dl = dl[rng.integers(0, 3, n_l)]
        dr = dl[rng.integers(0, 3, n_r)]
    xy_l = np.stack([rng.uniform(0, 640, n_l), rng.uniform(100, 160, n_l)], 1)
    xy_r = np.stack([rng.uniform(0, 640, n_r), rng.uniform(100, 160, n_r)], 1)
    xy_l, xy_r = xy_l.astype(np.float32), xy_r.astype(np.float32)
    oct_l = rng.choice(8, n_l, p=[.3, .2, .15, .1, .08, .07, .05, .05]).astype(np.int32)
    oct_r = rng.choice(8, n_r, p=[.3, .2, .15, .1, .08, .07, .05, .05]).astype(np.int32)
    valid_l, valid_r = rng.random(n_l) < 0.9, rng.random(n_r) < 0.9
    if not edges:
        return dl, xy_l, oct_l, valid_l, dr, xy_r, oct_r, valid_r
    f32 = np.float32
    up, down = (lambda v: np.nextafter(f32(v), f32(np.inf))), \
        (lambda v: np.nextafter(f32(v), f32(-np.inf)))
    md = f32(BAND_MAX_D)
    s2 = f32(2) * BAND_SCALES[1]
    # (row, x_l, y_l, octave_l, [(column, x_r, y_r, octave_r), ...])
    plan = [
        (0, f32(2) * md, 1000, 0, [(0, md, 1000, 0), (1, f32(2) * md - up(md), 1000, 0),
                                   (2, f32(2) * md - down(md), 1000, 0)]),
        (1, 10, 1100, 0, [(3, 12, 1100, 0), (4, up(12), 1100, 0), (5, down(12), 1100, 0)]),
        (2, 300, f32(2) * s2, 1, [(6, 290, s2, 1), (7, 290, up(s2), 1), (8, 290, down(s2), 1)]),
        (3, 300, 1200, 3, [(9, 290, 1200, 1), (10, 290, 1200, 2), (11, 290, 1200, 4),
                           (12, 290, 1200, 5)]),
        (4, 300, 1300, 0, [(13, 290, 1300, 0)]),
        (5, 300, -5000, 0, []),
        (6, 300, 1400, 2, [(14, 250, 1400, 2), (15, 260, 1400, 2)]),
        (7, 300, 1400, 2, []),
    ]
    for row, x, y, o, cols in plan:
        xy_l[row], oct_l[row], valid_l[row] = (x, y), o, row != 4
        for col, xr, yr, orr in cols:
            xy_r[col], oct_r[col], valid_r[col] = (xr, yr), orr, col != 15
    dl[7] = dl[6]
    return dl, xy_l, oct_l, valid_l, dr, xy_r, oct_r, valid_r


# Distances from an edge that the patch kernels must get right: on it, just
# outside it, and one px either side of each window's half width (15 for
# the 31x31 window, 19 for the 39x39 one).
PATCH_EDGE_OFFSETS = (0, -1, -7, 14, 15, 16, 18, 19, 20)


def patch_edge_yx(h, w):
    """[K, 2] int32 (row, col) centres for an h x w image: each edge
    distance of PATCH_EDGE_OFFSETS from the top, bottom, left and right
    edge (the other coordinate mid-image), the four corners, and the four
    points one px diagonally past them."""
    rows = list(PATCH_EDGE_OFFSETS) + [h - 1 - d for d in PATCH_EDGE_OFFSETS]
    cols = list(PATCH_EDGE_OFFSETS) + [w - 1 - d for d in PATCH_EDGE_OFFSETS]
    yx = [(y, w // 2) for y in rows] + [(h // 2, x) for x in cols]
    yx += [(y, x) for y in (0, h - 1) for x in (0, w - 1)]
    yx += [(y, x) for y in (-1, h) for x in (-1, w)]
    return np.asarray(yx, np.int32)


# K7 under a candidate test (valid_hamming_top2, window_hamming_top2,
# epipolar_hamming_top2): a case per test, one of each batched with the row
# tables and one with the column tables shared, one with ties, one with
# the edges below; and a case past one shared-memory chunk of the kernel
# (1024 columns) for the card (the CPU tests' Pallas reference takes at
# most 4096 columns).
CANDIDATE_TESTS = ("valid", "window", "epipolar")
CANDIDATE_CASES = {
    **{f"{test}_{name}": dict(test=test, **kw) for test in CANDIDATE_TESTS for name, kw in {
        "single": dict(seed=31, m=150, n=230),
        "edges": dict(seed=32, m=40, n=90, edges=True),
        "ties": dict(seed=33, m=96, n=140, ties=True),
        "B4_rows_shared": dict(seed=34, m=70, n=110, b=4, shared="rows", edges=True),
        "B4_cols_shared": dict(seed=35, m=70, n=110, b=4, shared="cols", edges=True),
        "B3": dict(seed=36, m=50, n=60, b=3, ties=True),
    }.items()},
}
CANDIDATE_CARD_CASES = {
    f"{test}_{name}": dict(test=test, **kw) for test in CANDIDATE_TESTS for name, kw in {
        "N5000": dict(seed=37, m=300, n=5000),
        "B8_rows_shared": dict(seed=38, m=2000, n=1000, b=8, shared="rows", edges=True),
        "B8_cols_shared": dict(seed=39, m=2000, n=1000, b=8, shared="cols", edges=True),
    }.items()}
CANDIDATE_RADIUS = 100.0


def _fundamental(rng):
    """A float64 F12 of two views 0.1-0.3 m apart, a few degrees turned,
    through K = (500, 500, 320, 240): image-1 points to image-2 lines."""
    w = rng.normal(0, 0.05, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    t = rng.normal(0, 1, 3)
    t *= rng.uniform(0.1, 0.3) / np.linalg.norm(t)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    Ki = np.linalg.inv(K)
    return Ki.T @ tx @ R @ Ki


def candidate_problem(test, seed, m, n, b=0, shared="", edges=False, ties=False):
    """A K7 problem under `test` ("valid", "window" or "epipolar") in numpy,
    in its wrapper's argument order: (desc_a, desc_b, row_ok, col_ok) and
    for "window" (xy_a, xy_b, CANDIDATE_RADIUS), for "epipolar" (xy_a, xy_b,
    F12, sigma2_b); descriptors uint32, pixels float32 in 640 x 480, NaN
    wherever a flag is clear. b > 0: B problems, every table [B, ...]
    except the row side's (shared="rows") or the column side's
    (shared="cols"), which the problems share; F12 is per problem. edges
    (m >= 8, n >= 16, problem 0's tables, or the shared ones): row 0's flag
    clear; row 1 with its flag set and no candidate (far away for "window",
    NaN coordinates for "epipolar"); "window": row 2 with columns at dx and
    dy of exactly the radius and one float32 step either side, rows 3 and
    4 with one candidate each (column 7, column 0); "epipolar": columns 0-6
    at the distance of row 2's band edge times 1 + k 1e-7 (k = -3..3),
    columns 7 and 0 inside the bands of rows 3 and 4, and with b >= 4:
    problem 1's F12 = 0 (every line degenerate: l0^2 + l1^2 clamped, every
    pair a candidate), problem 2's F12 x 1e-8 (clamped, some pairs) and,
    unless the columns are shared, problem 3's columns at 1e19-1e25 px
    (num^2 overflows); "valid": problem 1 with column 0 its only valid
    one, problem 2 with column n - 1, problem 3 with none (a shared or
    single column table: column 0 its only valid one)."""
    rng = np.random.default_rng(seed)
    bb = max(b, 1)
    rows_b = 1 if shared == "rows" else bb
    cols_b = 1 if shared == "cols" else bb
    da = rng.integers(0, 2 ** 32, size=(rows_b, m, 8), dtype=np.uint32)
    db = rng.integers(0, 2 ** 32, size=(cols_b, n, 8), dtype=np.uint32)
    if ties:
        # Few distinct descriptors: many equal distances per row.
        da = da[:, rng.integers(0, 3, m)]
        db = da[:1, rng.integers(0, 3, n)].repeat(cols_b, 0)
    row_ok = rng.random((rows_b, m)) < 0.8
    col_ok = rng.random((cols_b, n)) < 0.8
    xy_a = np.stack([rng.uniform(0, 640, (rows_b, m)), rng.uniform(0, 480, (rows_b, m))], -1)
    xy_b = np.stack([rng.uniform(0, 640, (cols_b, n)), rng.uniform(0, 480, (cols_b, n))], -1)
    F = np.stack([_fundamental(rng) for _ in range(bb)])
    octave = rng.integers(0, 8, (cols_b, n))
    sigma2 = (np.float32(1.2) ** (2 * octave)).astype(np.float32)
    f32 = np.float32
    if edges:
        row_ok[0, :5] = [False, True, True, True, True]
        col_ok[0, :8] = True
        xy_a[0, 1] = (-9000.0, -9000.0) if test == "window" else (np.nan, np.nan)
        if test == "window":
            r = f32(CANDIDATE_RADIUS)
            x0, y0 = f32(300), f32(200)
            xy_a[0, 2] = (x0, y0)
            up, down = (lambda v: np.nextafter(f32(v), f32(np.inf))), \
                (lambda v: np.nextafter(f32(v), f32(-np.inf)))
            for j, (x, y) in enumerate([(x0 + r, y0), (up(x0 + r), y0), (down(x0 + r), y0),
                                        (x0, y0 - r), (x0, up(y0 - r)), (x0, down(y0 - r))]):
                xy_b[0, 1 + j] = (x, y)
            xy_a[0, 3], xy_b[0, 7] = (-5000.0, -5000.0), (-4950.0, -5040.0)
            xy_a[0, 4], xy_b[0, 0] = (5000.0, 5000.0), (5000.0, 5000.0)
        if test == "epipolar":
            F0 = F[0].astype(f32).astype(np.float64)
            for row, cols in ((2, range(7)), (3, (7,)), (4, (0,))):
                xa = xy_a[0, row].astype(f32).astype(np.float64)
                line = F0 @ np.array([xa[0], xa[1], 1.0])
                nrm = np.hypot(line[0], line[1])
                foot = -line[2] * line[:2] / nrm ** 2 + np.array([-line[1], line[0]]) / nrm \
                    * rng.uniform(-200, 200)
                for k, j in enumerate(cols):
                    dist = np.sqrt(3.84 * float(sigma2[0, j])) * (
                        1 + (k - 3) * 1e-7 if row == 2 else rng.uniform(0, 0.5))
                    xy_b[0, j] = foot + dist * line[:2] / nrm
            if b >= 4:
                F[1] = 0.0
                F[2] *= 1e-8
            if cols_b >= 4:
                big = rng.uniform(19, 25, (n, 2))
                xy_b[3] = np.where(rng.random((n, 1)) < 0.5, 10 ** big, -(10 ** big))
        if test == "valid" and cols_b >= 4:
            col_ok[1] = np.arange(n) == 0
            col_ok[2] = np.arange(n) == n - 1
            col_ok[3] = False
        elif test == "valid":
            col_ok[0] = np.arange(n) == 0
    xy_a = np.where(row_ok[..., None], xy_a, np.nan).astype(f32)
    xy_b = np.where(col_ok[..., None], xy_b, np.nan).astype(f32)
    sigma2 = sigma2.astype(f32)
    F = F.astype(f32)

    def side(a, nb):
        return a[0] if b == 0 or nb == 1 and b > 1 else a

    row_tabs = [side(t, rows_b) for t in (da, row_ok, xy_a)]
    col_tabs = [side(t, cols_b) for t in (db, col_ok, xy_b, sigma2)]
    out = (row_tabs[0], col_tabs[0], row_tabs[1], col_tabs[1])
    if test == "window":
        return out + (row_tabs[2], col_tabs[2], CANDIDATE_RADIUS)
    if test == "epipolar":
        return out + (row_tabs[2], col_tabs[2], F[0] if b == 0 else F, col_tabs[3])
    return out


# ---------------------------------------------------------------------------
# Host state carried across
# ---------------------------------------------------------------------------

MAP_SCALARS = ("n_feat", "next_kf", "next_pt", "big_change_idx")
FRAME_ARRAYS = ("xy", "xy_raw", "octave", "angle", "response", "desc", "valid",
                "depth", "ur", "R", "t", "point_ids", "dev_feat", "dev_desc")
TRACKER_SCALARS = ("ref_kf", "last_kf_frame_id", "last_reloc_frame_id", "n_inliers")


def _copy(a):
    """A host copy of an array of any framework (numpy, a torch tensor on
    any device, a JAX array); None stays None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return to_host(a).copy()
    return np.array(a, copy=True)


def map_state_to_numpy(ms) -> Dict[str, object]:
    """A MapState (the port's or the JAX package's) -> a dict of numpy
    copies of its tables, its counters, its loop edges and its MapConfig
    fields (under "cfg")."""
    import dataclasses

    from orb_slam2_commit_tpu_torch.models.map_state import MapState

    out = {f.name: _copy(getattr(ms, f.name)) for f in dataclasses.fields(MapState)
           if f.name not in ("cfg", "loop_edges", "remove_kf_hooks", "grow_hooks")
           and f.name not in MAP_SCALARS}
    out.update({k: int(getattr(ms, k)) for k in MAP_SCALARS})
    out["loop_edges"] = [tuple(int(v) for v in e) for e in (ms.loop_edges or [])]
    out["cfg"] = {f.name: getattr(ms.cfg, f.name) for f in dataclasses.fields(ms.cfg)}
    return out


def map_state_from_numpy(d: Dict[str, object]):
    """map_state_to_numpy's dict -> the port's MapState (arrays copied)."""
    from orb_slam2_commit_tpu_torch.models.map_state import MapState
    from orb_slam2_commit_tpu_torch.utils.config import MapConfig

    arrays = {k: np.array(v, copy=True) for k, v in d.items()
              if k not in MAP_SCALARS and k not in ("cfg", "loop_edges")}
    return MapState(cfg=MapConfig(**d["cfg"]), loop_edges=list(d["loop_edges"]),
                    **{k: d[k] for k in MAP_SCALARS}, **arrays)


def _entry_to_numpy(e):
    if e is None:
        return None
    return dict(ref_kf=int(e.ref_kf), R_rel=_copy(e.R_rel), t_rel=_copy(e.t_rel),
                timestamp=float(e.timestamp), lost=bool(e.lost))


def frame_to_numpy(frame) -> Dict[str, object]:
    """A Frame (the port's or the JAX package's) -> a dict of numpy copies:
    its features, pose, bindings, its trajectory anchor (a dict) and the
    fused motion stage's packed features left on the device (dev_feat
    [N, 12] float32, dev_desc [N, 8]; None for a staged frame)."""
    out = {k: _copy(getattr(frame, k)) for k in FRAME_ARRAYS}
    if out["dev_desc"] is not None:
        out["dev_desc"] = out["dev_desc"].view(np.uint32)
    out.update(frame_id=int(frame.frame_id), timestamp=float(frame.timestamp),
               anchor=_entry_to_numpy(frame.anchor))
    return out


def frame_from_numpy(d: Dict[str, object], device="cuda"):
    """frame_to_numpy's dict -> the port's Frame, its dev_feat and dev_desc
    on `device`."""
    from orb_slam2_commit_tpu_torch.slam.frame import Frame
    from orb_slam2_commit_tpu_torch.slam.tracking import TrajectoryEntry

    dev = resolve_device(device)
    host = {k: (None if d[k] is None else np.array(d[k], copy=True))
            for k in FRAME_ARRAYS if k not in ("dev_feat", "dev_desc")}
    frame = Frame(frame_id=d["frame_id"], timestamp=d["timestamp"], **host)
    if d["dev_feat"] is not None:
        frame.dev_feat = to_device(d["dev_feat"], dev)
        frame.dev_desc = to_device(np.asarray(d["dev_desc"], np.uint32), dev)
    if d["anchor"] is not None:
        frame.anchor = TrajectoryEntry(**d["anchor"])
    return frame


def tracker_state_to_numpy(tracker) -> Dict[str, object]:
    """The fields a tracker step reads (the port's or the JAX package's
    Tracker): last_frame (a frame dict), velocity ((R, t) or None), state
    (its name), ref_kf, last_kf_frame_id, last_reloc_frame_id, n_inliers."""
    out = {k: int(getattr(tracker, k)) for k in TRACKER_SCALARS}
    out["state"] = tracker.state.name
    out["velocity"] = (None if tracker.velocity is None
                       else tuple(_copy(v) for v in tracker.velocity))
    out["last_frame"] = (None if tracker.last_frame is None
                         else frame_to_numpy(tracker.last_frame))
    return out


def tracker_state_into(tracker, d: Dict[str, object]) -> None:
    """Set a port Tracker's step fields from tracker_state_to_numpy's dict;
    the last frame's device buffers go to the tracker's device."""
    from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState

    for k in TRACKER_SCALARS:
        setattr(tracker, k, d[k])
    tracker.state = TrackingState[d["state"]]
    tracker.velocity = (None if d["velocity"] is None
                        else tuple(np.array(v, copy=True) for v in d["velocity"]))
    tracker.last_frame = (None if d["last_frame"] is None
                          else frame_from_numpy(d["last_frame"], tracker.device))


def recent_points_to_numpy(mapper) -> np.ndarray:
    """A LocalMapper's recent-point list -> [R, 2] int64 (pt_id, first_kf)."""
    return np.asarray([(rp.pt_id, rp.first_kf) for rp in mapper.recent_points],
                      np.int64).reshape(-1, 2)


def recent_points_from_numpy(a: np.ndarray):
    """recent_points_to_numpy's array -> the port's RecentPoint list."""
    from orb_slam2_commit_tpu_torch.slam.local_mapping import RecentPoint

    return [RecentPoint(int(p), int(k)) for p, k in np.asarray(a).reshape(-1, 2)]


LOOP_CLOSER_SCALARS = ("last_loop_kf", "n_loops_closed", "essential_min_weight")


def database_to_numpy(db) -> Dict[str, object]:
    """A KeyFrameDatabase (either package's) -> its rows: present [K],
    word_ids [K, W] and weights [K, W] (None before the first add)."""
    return dict(present=_copy(db.present), word_ids=_copy(db.word_ids),
                weights=_copy(db.weights))


def database_from_numpy(d: Dict[str, object], vocabulary, device="cuda"):
    """database_to_numpy's dict and the port's vocabulary -> the port's
    KeyFrameDatabase, its descents on `device`."""
    from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase

    db = KeyFrameDatabase(vocabulary, d["present"].shape[0], device)
    db.present = np.array(d["present"], copy=True)
    db.word_ids, db.weights = _copy(d["word_ids"]), _copy(d["weights"])
    return db


def loop_closer_state_to_numpy(closer) -> Dict[str, object]:
    """A LoopCloser's host state (either package's): its consistent groups
    as (sorted keyframes, consistency), last_loop_kf, n_loops_closed and
    essential_min_weight."""
    out = {k: int(getattr(closer, k)) for k in LOOP_CLOSER_SCALARS}
    out["groups"] = [(sorted(int(k) for k in g.keyframes), int(g.consistency))
                     for g in closer.consistent_groups]
    return out


def loop_closer_state_into(closer, d: Dict[str, object]) -> None:
    """Set a port LoopCloser's host state from loop_closer_state_to_numpy's
    dict."""
    from orb_slam2_commit_tpu_torch.slam.loop_closing import ConsistentGroup

    for k in LOOP_CLOSER_SCALARS:
        setattr(closer, k, d[k])
    closer.consistent_groups = [ConsistentGroup(set(ks), c) for ks, c in d["groups"]]


# ----------------------------------------------------------------------
# Bundle adjustment problems and partition plans across packages
# ----------------------------------------------------------------------


def camera_params(config) -> Tuple[float, float, float, float, float]:
    """(fx, fy, cx, cy, bf) of a SLAMConfig (or its camera), the
    arguments every BA entry point takes."""
    cam = getattr(config, "camera", config)
    return float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(cam.bf)


def ba_problem_from_numpy(p, device="cuda"):
    """A BA problem whose leaves are numpy arrays or anything np.asarray
    reads (the JAX package's BAProblem and BAObservations, by field name)
    -> the port's BAProblem on `device`, each leaf's dtype kept."""
    from orb_slam2_commit_tpu_torch.optim.ba import BAProblem
    from orb_slam2_commit_tpu_torch.optim.residuals import BAObservations

    dev = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    obs = BAObservations(*(leaf(getattr(p.obs, f)) for f in BAObservations._fields))
    return BAProblem(R=leaf(p.R), t=leaf(p.t), fixed=leaf(p.fixed), points=leaf(p.points),
                     point_valid=leaf(p.point_valid), obs=obs)


def partition_plan_from_numpy(plan):
    """The JAX package's PartitionPlan (or any object with its fields) ->
    the port's parallel.distributed_ba.PartitionPlan."""
    from orb_slam2_commit_tpu_torch.parallel.distributed_ba import PartitionPlan

    return PartitionPlan(perm=np.asarray(plan.perm, np.int64), p_blk=int(plan.p_blk),
                         o_blk=int(plan.o_blk), n_points=int(plan.n_points),
                         n_obs=int(plan.n_obs), n_devices=int(plan.n_devices))
