"""Entry points that move state into and out of the port.

- `map_from_numpy`: the tracking step's inputs as numpy arrays (the JAX
  package's layout: uint32 descriptors) -> tensors on a device.
- `features_to_numpy`, `step_to_numpy`: the port's results -> numpy, with
  descriptors as uint32 again.
- `make_example`: a synthetic frame pair and a local map built with the
  port's own extractor: the port's twin of the JAX package's
  `__graft_entry__._make_example`.

Every entry point that places tensors takes `device`, "cuda" by default;
without a card that default raises instead of falling back to the CPU.
"""

from __future__ import annotations

import dataclasses
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

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return (
        put(image, np.float32), put(pt_pos, np.float32),
        put(np.asarray(pt_desc, np.uint32).view(np.int32), np.int32),
        put(pt_octave, np.int32), put(pt_angle, np.float32),
        put(pt_valid, bool), put(R_pred, np.float32), put(t_pred, np.float32),
    )


def features_to_numpy(feats: ext.Features) -> Dict[str, np.ndarray]:
    out = {k: v.detach().cpu().numpy() for k, v in feats._asdict().items()}
    out["desc"] = out["desc"].view(np.uint32)
    return out


def step_to_numpy(res) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}


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
    frame 1's ground truth, as in the JAX package's example. The config
    runs without subpixel refinement, which the port does not have yet."""
    dev = resolve_device(device)
    config = synthetic_config(width=width, height=height, n_features=n_features)
    config = dataclasses.replace(
        config, orb=dataclasses.replace(config.orb, subpixel_refine=False))
    images, poses, scene = synthetic.render_sequence(
        config.camera, n_frames=n_frames, n_points=200, seed=11, step=0.04
    )
    feats0 = features_to_numpy(ext.extract_features(
        torch.from_numpy(images[0]).to(dev), config.orb,
        config.camera.height, config.camera.width))
    xy0, valid0 = feats0["xy"], feats0["valid"]
    cam = config.camera
    R0, t0 = poses[0]
    pc = scene.points @ R0.T + t0
    uv = np.stack(
        [cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1
    )
    d = np.linalg.norm(xy0[:, None] - uv[None], axis=-1)
    nearest = d.argmin(1)
    assoc = (d.min(1) < 4.0) & valid0

    rng = np.random.default_rng(0)
    m = n_points
    pt_pos = np.zeros((m, 3))
    pt_desc = rng.integers(0, 2 ** 32, size=(m, 8), dtype=np.uint32)
    pt_octave = np.zeros(m, np.int32)
    pt_angle = np.zeros(m, np.float32)
    pt_valid = np.zeros(m, bool)
    rows = np.where(assoc)[0][:m]
    k = rows.size
    pt_pos[:k] = scene.points[nearest[rows]]
    pt_desc[:k] = feats0["desc"][rows]
    pt_octave[:k] = feats0["octave"][rows]
    pt_angle[:k] = feats0["angle"][rows]
    pt_valid[:k] = True
    R_pred, t_pred = poses[1]
    args = map_from_numpy(images[1], pt_pos, pt_desc, pt_octave, pt_angle,
                          pt_valid, R_pred, t_pred, device=dev)
    return config, args
