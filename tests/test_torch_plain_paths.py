"""The CPU forms of four plain computations, held to what they replace:

- `ops/fast.fast_scores_multi` (K1's plain FAST scores: the segment test
  and the V-score only at the candidate pixels, where two compass points
  pass the lowest threshold) against `fast_scores_padded` (every pixel)
  at each threshold, bit for bit, and `two_threshold_score_maps` against
  the dense circle stack;
- `ops/fast.topk_iterative` on the CPU (from torch.topk's values) against
  its k rounds (`topk_rounds`), values and indices equal, ties included;
- `models/map_state.MapState.refresh_point_stats` (the representative
  descriptors by groups of one observation count) against the JAX
  package's on a map of 40 keyframes whose points are seen 1-20 times;
- `optim/pose_opt.pose_optimization_plain` on the CPU (its LM loop ends
  and its rounds are skipped once every later update would be masked
  out) against its masked loops (`stops_early` made False, as on the
  card), bit for bit, on the three sensors' motion-stage problems.
"""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models import map_state as jms
from orb_slam2_commit_tpu.utils.config import MapConfig as JMapConfig
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import level
from orb_slam2_commit_tpu_torch.models import map_state as pms
from orb_slam2_commit_tpu_torch.ops import fast
from orb_slam2_commit_tpu_torch.ops import packed_extractor as pe
from orb_slam2_commit_tpu_torch.optim import pose_opt
from orb_slam2_commit_tpu_torch.slam import jit_frontend
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import MapConfig, synthetic_config

torch.set_num_threads(1)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _image(kind):
    """[240, 320] float32 test images."""
    rng = np.random.default_rng(3)
    if kind == "synthetic":
        cfg = synthetic_config(width=320, height=240, n_features=400)
        images, _, _ = synthetic.render_sequence(cfg.camera, n_frames=2, n_points=300, seed=5,
                                                 step=0.05)
        return torch.from_numpy(images[1])
    if kind == "noise":
        return torch.from_numpy(rng.uniform(0, 255, (240, 320)).astype(np.float32))
    if kind == "integer noise":
        return torch.from_numpy(np.round(rng.uniform(0, 60, (240, 320))).astype(np.float32))
    if kind == "checker":
        y, x = np.mgrid[:240, :320]
        return torch.from_numpy((((y // 7) + (x // 5)) % 2 * 200.0).astype(np.float32))
    return torch.full((240, 320), 96.0)


KINDS = ("synthetic", "noise", "integer noise", "checker", "flat")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("thresholds", ((20.0, 7.0), (7.0,), (40.0, 0.5, 1.0)))
def test_fast_candidates_equal_every_pixel(kind, thresholds):
    cfg = synthetic_config(width=320, height=240, n_features=400)
    canvas = pe.build_canvas(_image(kind), pe.make_plan(cfg.orb, 240, 320))
    padded, hp, wp = level.pad_level(canvas)
    got = fast.fast_scores_multi(padded, hp, wp, thresholds)
    assert len(got) == len(thresholds)
    for (corner, score), t in zip(got, thresholds):
        want_corner, want_score = fast.fast_scores_padded(padded, hp, wp, t)
        assert torch.equal(corner, want_corner)
        assert torch.equal(_bits(score), _bits(want_score))
    if kind == "synthetic":
        assert int(got[0][0].sum()) > 100


@pytest.mark.parametrize("kind", KINDS)
def test_two_threshold_score_maps_equal_the_circle_stack(kind):
    image = _image(kind)[:101, :133]
    d = fast._circle_stack(image) - image[None]
    want = fast._score_from_diffs(d, 20.0)[1], fast._score_from_diffs(d, 7.0)[1]
    got = fast.two_threshold_score_maps(image, 20.0, 7.0)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("shape,k,levels", (((600, 900), 8, 40), ((37, 64), 8, 3),
                                            ((5, 7, 16), 4, 2), ((300, 8), 8, 4),
                                            ((10, 3), 3, 1), ((50, 100), 5, None)))
def test_topk_iterative_equals_its_rounds(shape, k, levels):
    g = torch.Generator().manual_seed(0)
    if levels is None:
        x = torch.randn(shape, generator=g)
    else:
        x = torch.randint(0, levels, shape, generator=g).float() * (
            torch.rand(shape, generator=g) < 0.3)
    for y in (x, x - 1.0, x.double()):
        got, want = fast.topk_iterative(y, k), fast.topk_rounds(y, k)
        assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype == torch.int32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_topk_iterative_on_entries_the_rounds_keep():
    """-inf, NaN and -0.0 take the rounds themselves."""
    x = torch.zeros(4, 6)
    x[0, 2:] = float("-inf")
    x[1, 0] = float("nan")
    x[2] = -0.0
    x[3, 1] = -0.0
    got, want = fast.topk_iterative(x, 5), fast.topk_rounds(x, 5)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def _observed_map(side):
    """40 keyframes of 200 features over 600 points, each point seen by
    1-20 keyframes, its descriptors a few flipped bits from one another
    (many equal medians)."""
    cls, cfg = {"jax": (jms.MapState, JMapConfig), "port": (pms.MapState, MapConfig)}[side]
    rng = np.random.default_rng(11)
    m = cls.create(cfg(max_keyframes=48, max_points=1024), 200)
    ids = m.add_points(rng.normal(0, 1, (600, 3)) + [0, 0, 5], first_kf=0)
    base = rng.integers(0, 2 ** 32, (600, 8), dtype=np.uint32)
    seen = rng.integers(1, 21, 600)
    for k in range(40):
        pts = np.flatnonzero(rng.random(600) < seen / 40.0)[:200]
        desc = base[pts] ^ (rng.integers(0, 4, (pts.size, 8), dtype=np.uint32)
                            << rng.integers(0, 30, (pts.size, 1)).astype(np.uint32))
        n = m.n_feat
        pi = np.full(n, -1, np.int32)
        pi[:pts.size] = ids[pts]
        valid = np.arange(n) < pts.size
        d = np.zeros((n, 8), np.uint32)
        d[:pts.size] = desc
        m.add_keyframe(np.eye(3), rng.normal(0, 0.3, 3), rng.uniform(0, 400, (n, 2)),
                       rng.integers(0, 8, n).astype(np.int32), np.zeros(n, np.float32), d,
                       valid, pi, frame_id=k, timestamp=float(k))
    m.refresh_point_stats()
    m.refresh_point_stats(ids[::3])
    return m


def test_refresh_point_stats_matches_jax_on_a_larger_map():
    got = interop.map_state_to_numpy(_observed_map("port"))
    want = interop.map_state_to_numpy(_observed_map("jax"))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k
    counts = np.bincount(got["kf_point_idx"][got["kf_valid"]].ravel() + 1)[1:]
    assert counts.max() >= 10 and (counts == 1).any()


@pytest.mark.parametrize("sensor", ("monocular", "stereo", "rgbd"))
def test_pose_optimization_stops_early_with_the_same_bits(monkeypatch, sensor):
    calls = []
    plain = pose_opt.pose_optimization_plain

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return plain(*args, **kwargs)

    cfg, motion, _ = interop.make_fused_example(320, 240, 400, 256, 512, "cpu", sensor=sensor)
    name = "fused_motion_track_packed" if sensor == "monocular" else \
        f"fused_{sensor}_motion_track_packed"
    with monkeypatch.context() as m:
        m.setattr(pose_opt, "pose_optimization_plain", spy)
        getattr(jit_frontend, name)(*motion, cfg)
    assert calls
    for args, kwargs in calls:
        got = plain(*args, **kwargs)
        with monkeypatch.context() as m:
            m.setattr(pose_opt, "stops_early", lambda t: False)
            want = plain(*args, **kwargs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
