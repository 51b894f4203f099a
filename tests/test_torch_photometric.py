"""tests/test_photometric.py against the port, on the CPU.

TestExtractionRepeatability: the port's extractor re-detects the same
corners on two independent noisy, exposure-shifted captures of one view,
and its two-threshold FAST fallback keeps a usable feature set on a dim,
low-contrast capture, at that test's gates. The captures are the JAX
package's, equal bit for bit (utils/synthetic.apply_photometry in numpy
in both packages). Each gate on the packed route (the default) and on the
per-level gather route (ORB_TPU_FORCE_PACKED=0).

The three renderers with a Photometry (read and shot noise, exposure gain
and bias, motion blur along the flow from the previous pose): the port's
render_sequence (the sweep, with and without depth maps),
render_loop_sequence and render_stereo_sequence give the JAX package's
images bit for bit for the same seed.

TestNoisyMonoPipeline: the port's System alone (synchronous, one thread,
the bundled vocabulary as the JAX test's System has it) on the 60-frame
sweep rendered by the port's render_sequence under the moderate camera
model with motion blur: tracking OK at the end, tracked >= 40 and ATE
under 2.5% of the span. The JAX package's own test runs its System."""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.ops import extractor
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils import trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def views():
    cfg = synthetic_config(width=400, height=300, n_features=600)
    images, _, _ = synthetic.render_sequence(cfg.camera, n_frames=1, n_points=250, seed=11)
    clean = images[0]
    phs = (synthetic.Photometry(noise_sigma=4.0, shot_noise=2.0, gain_range=(0.8, 0.8),
                                bias_range=(4.0, 4.0)),
           synthetic.Photometry(noise_sigma=4.0, shot_noise=2.0, gain_range=(1.2, 1.2),
                                bias_range=(-4.0, -4.0)),
           synthetic.Photometry(noise_sigma=2.0, gain_range=(0.45, 0.45)))
    out = [synthetic.apply_photometry(clean, ph, seed=s, frame_idx=0)
           for ph, s in zip(phs, (1, 2, 3))]
    for ph, s, got in zip(phs, (1, 2, 3), out):
        jph = jsynthetic.Photometry(**vars(ph))
        np.testing.assert_array_equal(got, jsynthetic.apply_photometry(clean, jph, seed=s,
                                                                       frame_idx=0))
    return cfg, clean, *out


@pytest.fixture(params=["packed", "per-level"])
def extract(request, monkeypatch):
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1" if request.param == "packed" else "0")
    monkeypatch.setenv("ORB_TPU_FORCE_PATCHES", "0")

    def run(img, cfg):
        f = extractor.extract_features(torch.from_numpy(np.asarray(img, np.float32)), cfg.orb,
                                       cfg.camera.height, cfg.camera.width)
        v = f.valid.numpy()
        return f.xy.numpy()[v], f.desc.numpy().view(np.uint32)[v]

    return run


def test_detection_survives_noise(views, extract):
    cfg, clean, n1, _, _ = views
    xy_c, _ = extract(clean, cfg)
    xy_1, _ = extract(n1, cfg)
    assert xy_1.shape[0] >= 0.7 * xy_c.shape[0], (xy_1.shape[0], xy_c.shape[0])


def test_repeatability_across_noisy_captures(views, extract):
    cfg, _, n1, n2, _ = views
    xy_1, d_1 = extract(n1, cfg)
    xy_2, d_2 = extract(n2, cfg)
    dist = np.linalg.norm(xy_1[:, None] - xy_2[None, :], axis=-1)
    nearest = dist.min(axis=1)
    repeat = float((nearest < 2.0).mean())
    assert repeat > 0.6, repeat
    # Hamming distance of the repeated corners' descriptors well under the
    # matcher's TH_LOW = 50.
    ok = nearest < 2.0
    x = d_1[ok] ^ d_2[dist.argmin(axis=1)[ok]]
    ham = np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)
    assert np.median(ham) < 40.0, np.median(ham)


def test_low_contrast_fallback(views, extract):
    """Dim, low-contrast capture (gain 0.45): the min-threshold FAST fallback
    (reference src/ORBextractor.cc:892-915) still gives a usable set."""
    cfg, clean, _, _, dim = views
    xy_c, _ = extract(clean, cfg)
    xy_d, _ = extract(dim, cfg)
    assert xy_d.shape[0] >= 0.5 * xy_c.shape[0], (xy_d.shape[0], xy_c.shape[0])


MODERATE = dict(noise_sigma=3.0, shot_noise=2.0, gain_range=(0.8, 1.2), bias_range=(-6.0, 6.0),
                motion_blur_frac=0.5, motion_blur_max_px=4.0)

# Each case: the renderer, its arguments, how many of its outputs lead
# with images (the stereo pair's two).
RENDERERS = {
    "sweep": ("render_sequence", dict(n_frames=4, n_points=80, seed=3, step=0.05,
                                      motion="sweep", depth_range=(1.5, 4.0), spread=2.0), 1),
    "sweep_depth": ("render_sequence", dict(n_frames=3, n_points=80, seed=5, step=0.06,
                                            with_depth=True), 1),
    "loop": ("render_loop_sequence", dict(n_frames=4, n_points=200, seed=4, frac=0.6), 1),
    "stereo": ("render_stereo_sequence", dict(n_frames=3, n_points=80, seed=6, step=0.08), 2),
}


@pytest.mark.parametrize("case", sorted(RENDERERS))
def test_renderers_with_photometry_equal_jax(case):
    name, kw, n_images = RENDERERS[case]
    cam = synthetic_config(width=160, height=120, n_features=200).camera
    jcam = j_synthetic_config(width=160, height=120, n_features=200).camera
    got = getattr(synthetic, name)(cam, photo=synthetic.Photometry(**MODERATE), **kw)
    want = getattr(jsynthetic, name)(jcam, photo=jsynthetic.Photometry(**MODERATE), **kw)
    clean = getattr(synthetic, name)(cam, **kw)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    for a, c in zip(got[:n_images], clean[:n_images]):
        assert not np.array_equal(a, c)


@pytest.fixture(scope="module")
def noisy_run():
    cfg = synthetic_config(width=400, height=300, n_features=1000)
    images, poses_gt, _ = synthetic.render_sequence(
        cfg.camera, n_frames=60, n_points=500, seed=3, step=0.025, motion="sweep",
        depth_range=(1.5, 4.0), spread=2.0, photo=synthetic.Photometry(**MODERATE))
    before = dict(_build.launches)
    sys_ = System(cfg, async_mapping=False, device="cpu")
    poses = [sys_.track_monocular(images[i], i / 30.0) for i in range(images.shape[0])]
    assert _build.launches == before, "a kernel launched on the CPU"
    return sys_, poses, poses_gt


def test_tracks_through_noise(noisy_run):
    sys_, poses, _ = noisy_run
    assert sys_.tracking_state() == TrackingState.OK
    tracked = sum(p is not None for p in poses)
    assert tracked >= 40, tracked


def test_noisy_ate_within_bound(noisy_run):
    sys_, _, poses_gt = noisy_run
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    rmse = traj.ate_rmse(est[~lost], gt[len(gt) - len(est):][~lost], align_scale=True)
    span = np.linalg.norm(gt[-1] - gt[0])
    assert rmse < 0.025 * span, (rmse, span)
