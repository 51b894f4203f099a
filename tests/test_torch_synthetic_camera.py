"""The port's real-camera renderer and dataset writers against the JAX
package's.

Held exactly equal to the JAX package (tolerance 0: the code is the same
numpy): `render` through a distorted lens (TUM1's coefficients, EuRoC's
raw left camera), with depth maps; `apply_photometry` under CAMERA_PHOTO
and with motion blur, against JAX's `render_sequence(photo=)`; the first three
stereo frames of the KITTI-class drive (`drive_frames` at KITTI 00-02's
calibration, 1241x376, with CAMERA_PHOTO). Then the port's mini-dataset
writers lay out TUM mono, TUM RGB-D, KITTI stereo and EuRoC stereo
sequences and settings files, and the JAX package's loaders, image reader
and settings parser read them back equal to what was written.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.utils import config as jconfig
from orb_slam2_commit_tpu.utils import datasets as jdatasets
from orb_slam2_commit_tpu.utils import settings as jsettings
from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu_torch.utils import config, datasets, mini_dataset, synthetic

torch.set_num_threads(1)

KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241, height=376,
                 fps=10.0, bf=386.1448, th_depth=35.0)
EUROC_RAW = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480,
                 k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)


def _cams(**fields):
    """The same camera in both packages' CameraConfig."""
    return jconfig.CameraConfig(**fields), config.CameraConfig(**fields)


def _pose(k):
    yaw = 0.05 * k
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    return R, np.array([0.1 * k, -0.05, 0.2 * k])


@pytest.mark.parametrize("lens", ["tum1", "euroc_left"])
def test_distorted_render_equals_jax(lens):
    if lens == "tum1":
        jcam, pcam = jconfig.tum_fr1_config().camera, config.tum_fr1_config().camera
    else:
        jcam, pcam = _cams(**EUROC_RAW)
    assert pcam.has_distortion
    rng_args = dict(n_points=400, depth_range=(1.5, 6.0), spread=2.5)
    jscene = jsynthetic.make_scene(np.random.default_rng(6), **rng_args)
    pscene = synthetic.make_scene(np.random.default_rng(6), **rng_args)
    for k in range(3):
        R, t = _pose(k)
        j_img, j_depth = jsynthetic.render(jscene, R, t, jcam, with_depth=True)
        p_img, p_depth = synthetic.render(pscene, R, t, pcam, with_depth=True)
        np.testing.assert_array_equal(p_img, j_img)
        np.testing.assert_array_equal(p_depth, j_depth)
    # The lens moves the image: the undistorted render differs.
    plain = dataclasses.replace(pcam, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    assert not np.array_equal(synthetic.render(pscene, R, t, plain), p_img)


@pytest.mark.parametrize("blur", [0.0, 0.6])
def test_photometry_equals_jax(blur):
    jcam, pcam = _cams(fx=320.0, fy=320.0, cx=200.0, cy=150.0, width=400, height=300)
    jphoto = dataclasses.replace(jsynthetic.CAMERA_PHOTO, motion_blur_frac=blur)
    pphoto = dataclasses.replace(synthetic.CAMERA_PHOTO, motion_blur_frac=blur)
    assert dataclasses.asdict(pphoto) == dataclasses.asdict(jphoto)
    # JAX's render_sequence(photo=) degrades frame k with the flow from
    # frame k - 1 at the scene's mean depth; the port's parts do the same.
    seq = dict(n_frames=4, n_points=300, seed=3, step=0.06)
    j_img = jsynthetic.render_sequence(jcam, photo=jphoto, **seq)[0]
    clean, poses, _ = synthetic.render_sequence(pcam, **seq)
    for k in range(len(poses)):
        flow = synthetic._flow_px(pcam, *poses[k - 1], *poses[k], depth=8.0) if k else None
        if k:
            np.testing.assert_array_equal(
                flow, jsynthetic._flow_px(jcam, *poses[k - 1], *poses[k], depth=8.0))
        got = synthetic.apply_photometry(clean[k], pphoto, seq["seed"], k, flow_px=flow)
        np.testing.assert_array_equal(got, j_img[k])
        assert not np.array_equal(got, clean[k])
    # The right view's noise stream, with a flow of its own.
    flow = synthetic._flow_px(pcam, *_pose(0), *_pose(1))
    np.testing.assert_array_equal(flow, jsynthetic._flow_px(jcam, *_pose(0), *_pose(1)))
    for stream in (0, 1):
        np.testing.assert_array_equal(
            synthetic.apply_photometry(clean[1], pphoto, 9, 1, flow, stream),
            jsynthetic.apply_photometry(clean[1], jphoto, 9, 1, flow, stream))


def test_drive_frames_equal_jax():
    jcam, pcam = _cams(**KITTI_CAM)
    args = dict(n_frames=1600, stereo=True, seed=7)
    j_frames, j_poses, j_scene = jsynthetic.drive_frames(jcam, photo=jsynthetic.CAMERA_PHOTO,
                                                         **args)
    p_frames, p_poses, p_scene = synthetic.drive_frames(pcam, photo=synthetic.CAMERA_PHOTO,
                                                        **args)
    np.testing.assert_array_equal(p_scene.points, j_scene.points)
    np.testing.assert_array_equal(np.asarray([t for _, t in p_poses]),
                                  np.asarray([t for _, t in j_poses]))
    for (jk, jl, jr), (pk, pl, pr) in zip(j_frames(), p_frames()):
        assert pk == jk
        assert pl.shape == (376, 1241)
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_array_equal(pr, jr)
        if pk == 2:
            break
    # Resumed from frame 1: the same frame 1.
    _, l1, r1 = next(p_frames(start=1))
    np.testing.assert_array_equal(l1, next(j_frames(start=1))[1])


def _written(img):
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def test_jax_reads_port_datasets(tmp_path):
    cam = config.tum_fr1_config("rgbd").camera
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 255, (3, 48, 64))
    rights = rng.uniform(0, 255, (3, 48, 64))
    depths = rng.uniform(0.0, 9.0, (3, 48, 64))
    depths[:, :4] = 0.0
    stamps = [1305031102.175304 + i / cam.fps for i in range(3)]

    assoc = mini_dataset.write_tum_rgbd(str(tmp_path / "tum"), images, depths, stamps)
    kitti = mini_dataset.write_kitti(str(tmp_path / "kitti"), images, stamps, rights=rights)
    euroc = mini_dataset.write_euroc(str(tmp_path / "euroc"), images, stamps, rights=rights)
    seqs = [(jdatasets.load_tum_mono(str(tmp_path / "tum")),
             datasets.load_tum_mono(str(tmp_path / "tum")), None),
            (jdatasets.load_tum_rgbd(str(tmp_path / "tum"), assoc),
             datasets.load_tum_rgbd(str(tmp_path / "tum"), assoc), depths),
            (jdatasets.load_kitti(kitti, stereo=True), datasets.load_kitti(kitti, stereo=True),
             rights),
            (jdatasets.load_euroc(euroc, stereo=True), datasets.load_euroc(euroc, stereo=True),
             rights)]
    for jseq, pseq, aux_in in seqs:
        assert dataclasses.asdict(pseq) == dataclasses.asdict(jseq)
        np.testing.assert_allclose(jseq.timestamps, stamps, atol=1e-6)
        for i, ((jt, jimg, jaux), (pt, pimg, paux)) in enumerate(zip(jseq.frames(),
                                                                    pseq.frames())):
            assert pt == jt
            assert jimg.dtype == pimg.dtype == np.uint8
            np.testing.assert_array_equal(jimg, _written(images[i]))
            np.testing.assert_array_equal(pimg, jimg)
            if aux_in is None:
                assert jaux is None and paux is None
            elif aux_in is depths:
                assert jaux.dtype == paux.dtype == np.float32
                np.testing.assert_array_equal(paux, jaux)
                np.testing.assert_array_equal(jaux, np.round(depths[i] * 5000.0))
            else:
                np.testing.assert_array_equal(jaux, _written(rights[i]))
                np.testing.assert_array_equal(paux, jaux)

    yaml = mini_dataset.write_settings_yaml(str(tmp_path / "s.yaml"), config.tum_fr1_config(
        "stereo"), depth_map_factor=5000.0)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    D = np.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3])
    R = np.array([[0.9999, -0.0141, 0.0], [0.0141, 0.9999, 0.0], [0.0, 0.0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    mini_dataset.append_euroc_stereo_blocks(yaml, K, D, R, P, K, D, R.T, P)
    parsed = jsettings.parse_opencv_yaml(yaml)
    np.testing.assert_array_equal(parsed["RIGHT.R"], R.T)
    np.testing.assert_array_equal(parsed["LEFT.D"], D[None])
    assert dataclasses.asdict(jsettings.config_from_settings(yaml, "stereo")) == \
        dataclasses.asdict(jconfig.tum_fr1_config("stereo"))
    assert os.path.getsize(yaml) > 0
