"""The port's dataset driver with a saved map, on the CPU: `--map=`,
`--localization` and `--vocab=`.

tests/test_torch_localization.py's session through the driver: the driver
maps frames 0-8 of the RGB-D sequence (400x300, 1000 features, 400
landmarks, seed 5, 0.05 a frame) from a TUM RGB-D layout with the bundled
vocabulary named by `--vocab=` (through a directory whose name holds an
"=", so the flag's value is read whole), and the map is saved; then the
driver loads that map (`--map=`) and tracks frames 4-13 in the
localization-only mode. Held: the map after the localization run equal to
the saved one in every table but the points' visible/found counters
(localization reads the map and counts its matches, as the reference's
Tracking::TrackLocalMap does), every point slot past the saved allocation
cursor free (the one-frame temporal VO points of a depth sensor are
written there and freed), the three trajectory files written with
one line per frame, and the frames relocalized in the loaded map and
tracked from there. Nothing launches a kernel on the CPU.
"""

import os

import numpy as np
import torch

from orb_slam2_commit_tpu_torch.examples import run_dataset
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models import serialization
from orb_slam2_commit_tpu_torch.models.vocabulary import DEFAULT_VOC_PATH
from orb_slam2_commit_tpu_torch.utils import mini_dataset, synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

MAPPED, LOCALIZED = range(0, 9), range(4, 14)
MIN_TRACKED = 8     # of the 10 localized frames


def _run(argv):
    before = dict(_build.launches)
    out = run_dataset.run(argv + ["--sync", "--device=cpu"])
    assert _build.launches == before, "a kernel launched on the CPU"
    assert out is not None
    return out


def test_parse_keeps_the_whole_value():
    args, flags = run_dataset._parse(["tum-mono", "seq", "--vocab=/data/a=b.npz", "--sync"])
    assert args == ["tum-mono", "seq"]
    assert flags == {"--vocab": "/data/a=b.npz", "--sync": True}


def test_localization_against_a_saved_map(tmp_path):
    cfg = synthetic_config(width=400, height=300, n_features=1000, sensor="rgbd")
    images, _, _, depths = synthetic.render_sequence(
        cfg.camera, n_frames=max(LOCALIZED) + 1, n_points=400, seed=5, step=0.05,
        with_depth=True)
    yaml = mini_dataset.write_settings_yaml(str(tmp_path / "RGBD.yaml"), cfg,
                                            depth_map_factor=5000.0)
    voc_dir = tmp_path / "voc=bundled"
    voc_dir.mkdir()
    vocab = voc_dir / "default_voc.npz"
    vocab.symlink_to(DEFAULT_VOC_PATH)

    seqs = {}
    for name, frames in (("mapped", MAPPED), ("localized", LOCALIZED)):
        root = str(tmp_path / name)
        assoc = mini_dataset.write_tum_rgbd(root, images[list(frames)], depths[list(frames)],
                                            [i / cfg.camera.fps for i in frames])
        seqs[name] = ["tum-rgbd", root, assoc, yaml]

    mapped = _run(seqs["mapped"] + [str(tmp_path / "mapped"), f"--vocab={vocab}"])
    assert mapped.system.vocabulary is not None
    assert mapped.system.map.n_keyframes() >= 2
    map_path = str(tmp_path / "map.npz")
    mapped.system.save_map(map_path)

    out = str(tmp_path / "loc")
    loc = _run(seqs["localized"] + [out, f"--map={map_path}", "--localization",
                                    f"--vocab={vocab}"])
    assert loc.system.vocabulary is not None
    assert loc.system.tracker.localization_only
    after = str(tmp_path / "after.npz")
    serialization.save_map(loc.system.map, after)
    saved, now = np.load(map_path), np.load(after)
    assert sorted(saved.files) == sorted(now.files)
    next_pt = int(saved["_meta"][1])
    for key in saved.files:
        if key in ("pt_visible", "pt_found"):
            continue
        # Past the allocation cursor lie the freed slots of the temporal
        # VO points, which live one frame each.
        rows = slice(0, next_pt) if key.startswith("pt_") else slice(None)
        np.testing.assert_array_equal(saved[key][rows], now[key][rows], err_msg=key)
    assert not now["pt_valid"][next_pt:].any()

    tracked = [s.name == "OK" for s in loc.states]
    assert sum(tracked) >= MIN_TRACKED, [s.name for s in loc.states]
    for suffix in ("_tum.txt", "_kf_tum.txt", "_kitti.txt"):
        assert os.path.getsize(out + suffix) > 0, suffix
    lines = open(out + "_tum.txt").read().splitlines()
    assert len(lines) == sum(tracked)
