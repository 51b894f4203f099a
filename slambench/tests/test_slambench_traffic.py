"""Traffic is data: the path kinds, the scene along them, the paced feed
and the localization mode, each driven from a traffic dict alone."""

import copy
import time

import numpy as np
import pytest
import torch

from slambench import cell, generator, registry, run
from slambench.tests.conftest import tiny

# A figure-eight through waypoints: its two lobes cross at the origin.
EIGHT = {"kind": "waypoints", "closed": True,
         "points": [[0, 0], [30, 30], [60, 0], [30, -30], [0, 0], [-30, 30], [-60, 0],
                    [-30, -30]]}


def _traffic(path, n=120, step=0.9554):
    tr = copy.deepcopy(registry.traffic("street-explore"))
    tr["path"] = dict(path, step_m=step)
    tr["pool_frames"] = n
    return tr


@pytest.mark.parametrize("path", [{"kind": "polar", "r0": 100.0, "lobe": 0.18}, EIGHT],
                         ids=["polar", "figure-eight"])
def test_frames_keep_their_step(path):
    tr = _traffic(path)
    poses = generator.trajectory(tr, tr["pool_frames"])
    centres = np.array([-R.T @ t for R, t in poses])
    steps = np.linalg.norm(np.diff(centres, axis=0), axis=1)
    np.testing.assert_allclose(steps, 0.9554, rtol=2e-3)
    for R, _ in poses:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_figure_eight_crosses_and_its_scene_keeps_clear():
    """The eight passes its crossing twice; no landmark stands in the road
    there or anywhere: every one lies at least its band's inner distance
    from every point of the path."""
    cv = generator.curve(EIGHT)
    near = np.linalg.norm(cv.points[:, [0, 2]], axis=1) < 0.5
    runs = np.flatnonzero(np.diff(near.astype(int)) == 1)
    assert len(runs) + int(near[0]) >= 2
    tr = _traffic(EIGHT, n=int(cv.length / 0.9554) - 1)
    gen = torch.Generator().manual_seed(5)
    sc = generator.scene(tr, gen, "cpu", tr["pool_frames"])
    xz = sc.points[:, [0, 2]].numpy()
    d = np.min(np.linalg.norm(xz[:, None, :] - cv.points[None, ::10, [0, 2]], axis=2), axis=1)
    assert sc.points.shape[0] > 1000 and d.min() >= tr["scene"]["lateral_m"][0] - 0.05


def test_open_path_ends():
    tr = _traffic({"kind": "waypoints", "closed": False, "points": [[0, 0], [0, 50]]}, n=80)
    with pytest.raises(ValueError):
        generator.trajectory(tr, tr["pool_frames"])


def test_paced_feed_drops_late_frames():
    """A paced feed far faster than the System hands over the newest frame
    due and drops the rest."""
    bench, wl, cfg, tr = tiny("tum-rgbd.corridor", pool=200, warmup=15)
    tr["feed"] = {"mode": "paced", "rate_hz": 20.0}
    c = cell.Cell(cfg, tr, 77, device="cpu")
    c.set_up()
    w = c.window(1e9, 0.0, 4)
    assert w.attempted == 4 and not w.exhausted and w.dropped > 0
    assert c.k == 15 + w.attempted + w.dropped


def test_localize_mode():
    """A lap mapped in set-up, then driven again in localization mode: a
    sound run is correct, and one whose pose solve returns its input is
    not."""
    bench, wl, cfg, tr = tiny("kitti-stereo.explore", pool=40, warmup=8)
    tr["mode"] = "localize"
    tr["path"] = {"kind": "polar", "r0": 6.0, "lobe": 0.08, "lap_frames": 40}
    tr["scene"]["inner"] = {"per_m": 25, "lateral_m": [1.5, 3.5]}
    limits = {k: v for k, v in registry.limits(wl["name"]).items()
              if k in ("failed_frames", "pose_gap_sigma", "inlier_gap")}
    result, rows = run.run_cell(bench, wl, cfg, tr, limits, 24681357924680, 1e9, False,
                                device="cpu", t_start=time.perf_counter(), max_frames=20)
    assert result["correct"] is True, rows
