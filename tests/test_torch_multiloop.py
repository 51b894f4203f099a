"""The port's figure-eight drive (utils/synthetic.figure8_*, and the
multi-loop drive's entry point examples/multiloop_drive.py) on the CPU
against the JAX package's: tests/test_multiloop.py's cases.

- The generator: the path, the trajectory and the scene equal the JAX
  package's exactly, and the first rendered frames (left and right, under
  CAMERA_PHOTO) too; the JAX tests' gates hold (each lobe returns to the
  crossing, the lobes lie on opposite sides, near-constant speed and
  smooth yaw, landmarks along both lobes).
- The entry point's command line at 320x240 for 10 stereo frames on the
  CPU: exit 0, a summary with every key scripts/multiloop_drive.py writes
  (read from that script's source), the kidnap probe attempted, and no
  kernel launched.
- The full drive (tests/test_multiloop.py::TestFullFigure8's settings:
  1400 frames, 120,000 landmarks, 1500 features, stereo), opt-in as the
  JAX test is (ORB_RUN_SCALE=1), on the card when there is one, held to
  that test's gates."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu_torch.examples import multiloop_drive
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_scale import reference_summary_keys  # noqa: E402

torch.set_num_threads(1)


def test_returns_to_crossing_each_lobe():
    s = np.array([0.0, 2.0 * np.pi, 4.0 * np.pi, 0.7, 3.1, 9.0])
    c = synthetic.figure8_path(s, 25.0)
    np.testing.assert_array_equal(c, jsynthetic.figure8_path(s, 25.0))
    for ci in c[:3]:
        assert np.linalg.norm(ci) < 1e-6


def test_lobes_are_distinct():
    a = synthetic.figure8_path(np.array([0.5 * np.pi]), 25.0)[0]
    b = synthetic.figure8_path(np.array([2.5 * np.pi]), 25.0)[0]
    assert a[0] > 1.0 and b[0] < -1.0


def test_trajectory_smooth_and_equals_jax():
    poses = synthetic.figure8_trajectory(800, r=25.0, laps=2.15)
    for (R, t), (jR, jt) in zip(poses, jsynthetic.figure8_trajectory(800, r=25.0, laps=2.15)):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)
    c = np.array([-R.T @ t for R, t in poses])
    step = np.linalg.norm(np.diff(c, axis=0), axis=1)
    assert step.max() < 1.5 * step.min()
    fw = np.gradient(c, axis=0)
    yaw = np.unwrap(np.arctan2(fw[:, 0], fw[:, 2]))
    assert np.abs(np.diff(yaw)).max() < np.deg2rad(2.0)


def test_scene_lines_both_lobes_and_equals_jax():
    sc = synthetic.figure8_scene(np.random.default_rng(0), n_points=8000, r=25.0)
    jsc = jsynthetic.figure8_scene(np.random.default_rng(0), n_points=8000, r=25.0)
    np.testing.assert_array_equal(sc.points, jsc.points)
    np.testing.assert_array_equal(sc.patches, jsc.patches)
    assert sc.points.shape == (8000, 3)
    assert (sc.points[:, 0] > 5).sum() > 2000
    assert (sc.points[:, 0] < -5).sum() > 2000


def test_frames_equal_jax():
    cfg = synthetic_config(width=256, height=192, n_features=200, sensor="stereo")
    kw = dict(n_frames=50, n_points=6000, seed=13, stereo=True)
    frames, poses, _ = synthetic.figure8_frames(cfg.camera, photo=synthetic.CAMERA_PHOTO, **kw)
    jframes, jposes, _ = jsynthetic.figure8_frames(cfg.camera, photo=jsynthetic.CAMERA_PHOTO,
                                                   **kw)
    got = [f for _, f in zip(range(2), frames(start=20))]
    for g, w in zip(got, jframes(start=20)):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    assert got[0][1].shape == (192, 256) and got[0][1].std() > 0


def test_command_line_on_the_cpu(tmp_path, capsys):
    before = dict(_build.launches)
    out = tmp_path / "multiloop.json"
    assert multiloop_drive.main(["--stereo", "--frames=10", "--width=320", "--height=240",
                                 "--features=500", "--points=8000", "--device=cpu",
                                 f"--out={out}"]) == 0
    assert _build.launches == before
    d = json.loads(out.read_text())
    assert reference_summary_keys("multiloop_drive.py") <= set(d)
    assert d["n_frames"] == 10 and d["device"] == "cpu"
    assert d["kidnap_reloc"]["attempted"] and "error" not in d["kidnap_reloc"]
    assert not any(d["launches"].values())
    assert '"kidnap_reloc"' in capsys.readouterr().out


@pytest.mark.skipif(os.environ.get("ORB_RUN_SCALE") != "1",
                    reason="full figure-eight drive takes ~1 h; set ORB_RUN_SCALE=1")
def test_full_multiloop_drive(tmp_path):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = tmp_path / "multiloop.json"
    assert multiloop_drive.main(["--frames=1400", "--points=120000", "--features=1500",
                                 "--stereo", f"--device={device}", f"--out={out}"]) == 0
    failed = [g for g in multiloop_drive.gates(json.loads(out.read_text())) if not g[3]]
    assert not failed, failed
