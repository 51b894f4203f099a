"""The port's KITTI-class drive (utils/synthetic.drive_*, and the scale
drive's entry point examples/scale_drive.py) on the CPU against the JAX
package's: tests/test_scale.py's cases.

- The drive generator: its trajectory, scene and first rendered frames
  (left and right) equal the JAX package's exactly, and the JAX tests'
  gates hold (the lap returns home, the street canyon feeds the view, the
  frames come lazily).
- The entry point's command line at 320x240 for 10 stereo frames on the
  CPU: exit 0, a summary with every key scripts/scale_drive.py writes
  (read from that script's source), both global BA routes timed, and no
  kernel launched.
- The full drive (tests/test_scale.py::TestFullDrive's settings: 1600
  frames, 640x480, 1500 features, stereo, 120,000 landmarks, r0 40, depth
  12, seed 7), opt-in as the JAX test is (ORB_RUN_SCALE=1), on the card
  when there is one, held to that test's gates."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu_torch.examples import scale_drive
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_summary_keys(script):
    """The keys of the `summary` dict a JAX driver script writes, read
    from its source."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", script)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "summary" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no summary dict in {script}")


def test_trajectory_closes_loop_and_equals_jax():
    poses = synthetic.drive_trajectory(400, r0=40.0, frac=1.0)
    for (R, t), (jR, jt) in zip(poses, jsynthetic.drive_trajectory(400, r0=40.0, frac=1.0)):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)
    c0 = -poses[0][0].T @ poses[0][1]
    c1 = -poses[-1][0].T @ poses[-1][1]
    assert np.linalg.norm(c1 - c0) < 1.0      # a full lap returns home


def test_scene_scale_visibility_and_equals_jax():
    cfg = synthetic_config(width=512, height=384, n_features=800)
    scene = synthetic.drive_scene(np.random.default_rng(0), n_points=20000, r0=40.0)
    jscene = jsynthetic.drive_scene(np.random.default_rng(0), n_points=20000, r0=40.0)
    np.testing.assert_array_equal(scene.points, jscene.points)
    np.testing.assert_array_equal(scene.patches, jscene.patches)
    assert scene.points.shape == (20000, 3)
    poses = synthetic.drive_trajectory(10, r0=40.0, frac=0.02)
    img = synthetic.render(scene, poses[0][0], poses[0][1], cfg.camera, max_depth=16.0)
    assert img.shape == (384, 512)
    pc = scene.points @ poses[0][0].T + poses[0][1]
    assert ((pc[:, 2] > 0.5) & (pc[:, 2] < 16.0)).sum() > 300


def test_frames_lazy_and_equal_jax():
    cfg = synthetic_config(width=256, height=192, n_features=200, sensor="stereo")
    kw = dict(n_frames=4, n_points=2000, seed=1, frac=0.01, stereo=True,
              photo=synthetic.CAMERA_PHOTO)
    frames, _, _ = synthetic.drive_frames(cfg.camera, **kw)
    jframes, _, _ = jsynthetic.drive_frames(cfg.camera, **dict(kw, photo=jsynthetic.CAMERA_PHOTO))
    out = list(frames(start=1))
    assert len(out) == 3 and out[0][1].shape == (192, 256)
    for got, want in zip(out, jframes(start=1)):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_command_line_on_the_cpu(tmp_path, capsys):
    before = dict(_build.launches)
    out = tmp_path / "scale.json"
    assert scale_drive.main(["--stereo", "--frames=10", "--width=320", "--height=240",
                             "--features=500", "--points=8000", "--device=cpu",
                             f"--out={out}"]) == 0
    assert _build.launches == before
    d = json.loads(out.read_text())
    assert reference_summary_keys("scale_drive.py") <= set(d)
    assert d["n_frames"] == 10 and d["device"] == "cpu" and len(d["dt_med_by_quarter_ms"]) == 4
    assert not any(d["launches"].values())
    assert d["gba_wall_s"] > 0 and d["dist_gba_wall_s"] > 0
    with open(str(out) + ".log") as f:
        assert "gba_error" not in f.read()
    assert '"final_state"' in capsys.readouterr().out


@pytest.mark.skipif(os.environ.get("ORB_RUN_SCALE") != "1",
                    reason="full-scale drive takes hours on the CPU; set ORB_RUN_SCALE=1")
def test_full_drive(tmp_path):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = tmp_path / "scale.json"
    assert scale_drive.main(["--stereo", "--frames=1600", "--points=120000",
                             "--features=1500", "--r0=40", "--max-depth=12",
                             f"--device={device}", f"--out={out}"]) == 0
    failed = [g for g in scale_drive.gates(json.loads(out.read_text())) if not g[3]]
    assert not failed, failed
