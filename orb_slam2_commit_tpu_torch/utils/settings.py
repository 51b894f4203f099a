"""Settings-file reader for the reference's per-sequence YAML schema (the
port's copy of utils/settings.py).

The reference reads OpenCV-YAML settings through cv::FileStorage, with
keys such as Camera.fx, ORBextractor.nFeatures and ThDepth (reference:
src/Tracking.cc:53-148, src/Viewer.cc:33-52). This parser reads that
dialect without OpenCV: the `%YAML:1.0` directive, scalars, and the
`!!opencv-matrix` nodes of the EuRoC rectification blocks
(Examples/Stereo/stereo_euroc.cc:55-98).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np

from orb_slam2_commit_tpu_torch.utils.config import CameraConfig, ORBConfig, SLAMConfig


def parse_opencv_yaml(path: str) -> Dict[str, Any]:
    """Scalars (int, float or string) and opencv-matrix nodes (numpy
    [rows, cols] float64), by key."""
    with open(path) as f:
        lines = f.read().splitlines()
    out: Dict[str, Any] = {}
    i = 0
    while i < len(lines):
        line = lines[i].split("#")[0].rstrip()
        i += 1
        if not line or line.startswith("%YAML"):
            continue
        m = re.match(r"^([A-Za-z0-9_.]+):\s*(.*)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("!!opencv-matrix") or val == "":
            # A matrix node: rows, cols, dt and data on the lines below.
            rows = cols = None
            data = []
            while i < len(lines):
                sub = lines[i].split("#")[0].strip()
                if re.match(r"^[A-Za-z0-9_.]+:", sub) and not sub.startswith(
                        ("rows:", "cols:", "dt:", "data:")):
                    break
                i += 1
                if sub.startswith("rows:"):
                    rows = int(sub.split(":")[1])
                elif sub.startswith("cols:"):
                    cols = int(sub.split(":")[1])
                elif sub.startswith("data:"):
                    buf = sub.split(":", 1)[1]
                    while "]" not in buf and i < len(lines):
                        buf += " " + lines[i].strip()
                        i += 1
                    data = [float(x) for x in re.findall(r"[-+0-9.eE]+", buf)]
                elif not sub:
                    break
            if rows and cols and data:
                out[key] = np.asarray(data).reshape(rows, cols)
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val.strip('"')
    return out


def config_from_settings(
    path: str,
    sensor: str = "monocular",
    width: Optional[int] = None,
    height: Optional[int] = None,
) -> SLAMConfig:
    """A SLAMConfig from a reference-style settings YAML.

    The reference's YAMLs do not store the image size (it comes from the
    images), so the drivers pass each dataset's own width and height; a
    Camera.width / Camera.height key in the file wins (the miniature
    datasets of utils/mini_dataset.py carry them)."""
    s = parse_opencv_yaml(path)
    cam = CameraConfig(
        fx=float(s["Camera.fx"]),
        fy=float(s["Camera.fy"]),
        cx=float(s["Camera.cx"]),
        cy=float(s["Camera.cy"]),
        width=int(s.get("Camera.width", width or 640)),
        height=int(s.get("Camera.height", height or 480)),
        fps=float(s.get("Camera.fps", 30.0)),
        k1=float(s.get("Camera.k1", 0.0)),
        k2=float(s.get("Camera.k2", 0.0)),
        p1=float(s.get("Camera.p1", 0.0)),
        p2=float(s.get("Camera.p2", 0.0)),
        k3=float(s.get("Camera.k3", 0.0)),
        bf=float(s.get("Camera.bf", 0.0)),
        th_depth=float(s.get("ThDepth", 35.0)),
        depth_map_factor=float(s.get("DepthMapFactor", 1.0)),
    )
    orb = ORBConfig(
        n_features=int(s.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(s.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(s.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(s.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(s.get("ORBextractor.minThFAST", 7)),
    )
    return SLAMConfig(camera=cam, orb=orb, sensor=sensor)
