"""The port's settings reader and dataset loaders against the JAX
package's.

tests/test_settings_datasets.py's cases run through the port
(utils/settings.py, utils/datasets.py); then both packages read the same
files: the parsed YAML dicts are equal, the configurations equal field by
field (`tum_fr1_config` too, and KITTI00-02.yaml's and EuRoC.yaml's
values written by the port's writer), the loaders give the same timestamps and
paths, `_load_gray` gives the same values and dtype on PNG files the JAX
package's writers (PIL) wrote, and `rectify_maps` and `remap_bilinear`
(uint8 and float32 images) are exactly equal to JAX's at EuRoC's published
calibration. Every comparison is exact: the code is the same numpy.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from orb_slam2_commit_tpu.utils import config as jconfig
from orb_slam2_commit_tpu.utils import datasets as jdatasets
from orb_slam2_commit_tpu.utils import mini_dataset as jmini
from orb_slam2_commit_tpu.utils import settings as jsettings
from orb_slam2_commit_tpu_torch.utils import config, datasets, mini_dataset, settings, synthetic

torch.set_num_threads(1)

TUM1_YAML = """%YAML:1.0

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989

Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314

Camera.fps: 30.0
Camera.bf: 40.0
ThDepth: 40.0
DepthMapFactor: 5000.0

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

EUROC_MATRIX_YAML = """%YAML:1.0
Camera.fx: 435.2
Camera.fy: 435.2
Camera.cx: 367.4
Camera.cy: 252.2
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
"""

# Examples/Stereo/EuRoC.yaml's raw cameras and rectified projection.
EUROC_K = {side: np.array([[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1.0]])
           for side, (k, _) in config.EUROC_RAW_CAMERAS.items()}
EUROC_D = {side: np.array(d) for side, (_, d) in config.EUROC_RAW_CAMERAS.items()}
EUROC_P = np.array(config.euroc_stereo_config().camera.k_matrix)
PUBLISHED = {"kitti_00-02": config.kitti_00_02_config, "euroc": config.euroc_stereo_config}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


# --- tests/test_settings_datasets.py's cases, through the port -------------


def test_tum_yaml(tmp_path):
    cfg = settings.config_from_settings(_write(tmp_path, "TUM1.yaml", TUM1_YAML), sensor="rgbd")
    assert cfg.camera.fx == pytest.approx(517.306408)
    assert cfg.camera.k1 == pytest.approx(0.262383)
    assert cfg.camera.depth_map_factor == pytest.approx(5000.0)
    assert cfg.orb.n_features == 1000
    assert cfg.orb.ini_th_fast == 20
    assert cfg.sensor == "rgbd"


def test_opencv_matrix_nodes(tmp_path):
    s = settings.parse_opencv_yaml(_write(tmp_path, "EuRoC.yaml", EUROC_MATRIX_YAML))
    assert s["LEFT.K"].shape == (3, 3)
    assert s["LEFT.K"][0, 0] == pytest.approx(458.654)
    assert s["LEFT.D"].shape == (1, 5)
    assert s["LEFT.D"][0, 3] == pytest.approx(1.76187114e-05)


def test_tum_mono_listing(tmp_path):
    (tmp_path / "rgb").mkdir()
    (tmp_path / "rgb.txt").write_text("\n".join(["# comment", "1.0 rgb/a.png", "1.033 rgb/b.png"]))
    seq = datasets.load_tum_mono(str(tmp_path))
    assert len(seq) == 2
    assert seq.timestamps[1] == pytest.approx(1.033)
    assert seq.rgb_paths[0].endswith("rgb/a.png")


def test_tum_rgbd_associations(tmp_path):
    assoc = _write(tmp_path, "assoc.txt", "1.0 rgb/a.png 1.001 depth/a.png\n")
    seq = datasets.load_tum_rgbd(str(tmp_path), assoc)
    assert len(seq) == 1
    assert seq.depth_paths[0].endswith("depth/a.png")


def test_kitti_listing(tmp_path):
    (tmp_path / "times.txt").write_text("0.0\n0.1\n0.2\n")
    seq = datasets.load_kitti(str(tmp_path), stereo=True)
    assert len(seq) == 3
    assert seq.rgb_paths[2].endswith("image_0/000002.png")
    assert seq.right_paths[2].endswith("image_1/000002.png")


def test_euroc_listing(tmp_path):
    cam0 = tmp_path / "mav0" / "cam0"
    cam0.mkdir(parents=True)
    (cam0 / "data.csv").write_text("#timestamp,filename\n1403636579763555584,x\n")
    seq = datasets.load_euroc(str(tmp_path), stereo=True)
    assert len(seq) == 1
    assert abs(seq.timestamps[0] - 1403636579.763555584) < 1e-5
    assert "cam1" in seq.right_paths[0]


def test_identity_rectification_is_noop():
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    mx, my = datasets.rectify_maps(K, np.zeros(5), np.eye(3), K, 320, 240)
    ys, xs = np.mgrid[0:240, 0:320]
    np.testing.assert_allclose(mx, xs, atol=1e-3)
    np.testing.assert_allclose(my, ys, atol=1e-3)


def test_remap_identity():
    img = np.random.default_rng(0).uniform(0, 255, (40, 50)).astype(np.float32)
    ys, xs = np.mgrid[0:40, 0:50].astype(np.float32)
    out = datasets.remap_bilinear(img, xs, ys)
    np.testing.assert_allclose(out[:-1, :-1], img[:-1, :-1], atol=1e-3)


# --- both packages on the same files ----------------------------------------


@pytest.mark.parametrize("text", [TUM1_YAML, EUROC_MATRIX_YAML], ids=["tum1", "euroc"])
def test_parsed_yaml_equals_jax(tmp_path, text):
    path = _write(tmp_path, "s.yaml", text)
    _dicts_equal(settings.parse_opencv_yaml(path), jsettings.parse_opencv_yaml(path))


@pytest.mark.parametrize("sensor", ["monocular", "stereo", "rgbd"])
def test_configs_equal_jax(tmp_path, sensor):
    path = _write(tmp_path, "TUM1.yaml", TUM1_YAML)
    for size in ((None, None), (1241, 376)):
        assert dataclasses.asdict(settings.config_from_settings(path, sensor, *size)) == \
            dataclasses.asdict(jsettings.config_from_settings(path, sensor, *size))
    assert dataclasses.asdict(config.tum_fr1_config(sensor, 1200)) == \
        dataclasses.asdict(jconfig.tum_fr1_config(sensor, 1200))
    # The JAX writer's YAML, read back by both.
    cfg = jconfig.tum_fr1_config(sensor)
    written = jmini.write_settings_yaml(str(tmp_path / "w.yaml"), cfg, depth_map_factor=5000.0)
    assert dataclasses.asdict(settings.config_from_settings(written, sensor)) == \
        dataclasses.asdict(jsettings.config_from_settings(written, sensor))


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_configs_round_trip(tmp_path, name):
    """KITTI00-02.yaml's and EuRoC.yaml's values, through the port's
    writer, read back equal by both packages' readers."""
    cfg = PUBLISHED[name]()
    written = mini_dataset.write_settings_yaml(str(tmp_path / f"{name}.yaml"), cfg)
    for read in (settings.config_from_settings, jsettings.config_from_settings):
        got = read(written, "stereo")
        assert dataclasses.asdict(got.camera) == dataclasses.asdict(cfg.camera)
        assert dataclasses.asdict(got.orb) == dataclasses.asdict(cfg.orb)


def test_loaders_equal_jax(tmp_path):
    (tmp_path / "rgb.txt").write_text("# c\n1.0 rgb/a.png\n1.033 rgb/b.png\n")
    assoc = _write(tmp_path, "assoc.txt", "1.0 rgb/a.png 1.001 depth/a.png\n"
                   "1.5 rgb/b.png 1.499 depth/b.png\n")
    (tmp_path / "times.txt").write_text("0.000000e+00\n1.036000e-01\n")
    cam0 = tmp_path / "mav0" / "cam0"
    cam0.mkdir(parents=True)
    (cam0 / "data.csv").write_text("#timestamp [ns],filename\n1403636579763555584,a\n"
                                   "1403636579813555456,b\n")
    root = str(tmp_path)
    pairs = [(datasets.load_tum_mono(root), jdatasets.load_tum_mono(root)),
             (datasets.load_tum_rgbd(root, assoc), jdatasets.load_tum_rgbd(root, assoc))]
    for stereo in (False, True):
        pairs.append((datasets.load_kitti(root, stereo), jdatasets.load_kitti(root, stereo)))
        pairs.append((datasets.load_euroc(root, stereo=stereo),
                      jdatasets.load_euroc(root, stereo=stereo)))
    for ours, theirs in pairs:
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "depth16"])
def test_load_gray_equals_jax(tmp_path, kind):
    rng = np.random.default_rng(3)
    path = str(tmp_path / f"{kind}.png")
    if kind == "gray8":
        jmini._save_png8(path, rng.uniform(0, 255, (30, 47)))
    elif kind == "depth16":
        jmini._save_png16(path, rng.uniform(0, 8, (30, 47)), 5000.0)
    else:
        shape = (30, 47, 3 if kind == "rgb8" else 4)
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8),
                        mode="RGB" if kind == "rgb8" else "RGBA").save(path)
    ours, theirs = datasets._load_gray(path), jdatasets._load_gray(path)
    assert ours.dtype == theirs.dtype == (np.float32 if kind == "depth16" else np.uint8)
    np.testing.assert_array_equal(ours, theirs)


def test_rectification_equals_jax():
    w, h = 752, 480
    rots = {"LEFT": synthetic.mount_rotation(yaw=0.012, pitch=-0.004),
            "RIGHT": synthetic.mount_rotation(yaw=-0.009, roll=0.006)}
    rng = np.random.default_rng(4)
    img8 = rng.integers(0, 256, (h, w)).astype(np.uint8)
    img32 = rng.uniform(0, 255, (h, w)).astype(np.float32)
    for side in ("LEFT", "RIGHT"):
        args = (EUROC_K[side], EUROC_D[side], rots[side], EUROC_P, w, h)
        ours, theirs = datasets.rectify_maps(*args), jdatasets.rectify_maps(*args)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        for img in (img8, img32):
            a = datasets.remap_bilinear(img, *ours)
            b = jdatasets.remap_bilinear(img, *theirs)
            assert a.dtype == b.dtype == img.dtype
            np.testing.assert_array_equal(a, b)
