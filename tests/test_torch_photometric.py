"""tests/test_photometric.py::TestExtractionRepeatability against the port:
the port's extractor re-detects the same corners on two independent noisy,
exposure-shifted captures of one view, and its two-threshold FAST
fallback keeps a usable feature set on a dim, low-contrast capture, at
that test's gates. The captures are the JAX package's, equal bit for bit
(utils/synthetic.apply_photometry in numpy in both packages). Each gate
on the packed route (the default) and on the per-level gather route
(ORB_TPU_FORCE_PACKED=0). On the CPU."""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.utils import synthetic as jsynthetic
from orb_slam2_commit_tpu_torch.ops import extractor
from orb_slam2_commit_tpu_torch.utils import synthetic
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
