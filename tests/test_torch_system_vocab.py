"""The port's System with the bundled vocabulary, on the CPU.

- RGB-D: tests/test_torch_system.py's sequence (tests/test_pipeline.py::
  TestRGBDPipeline: 400x300, 1000 features, 20 frames, 400 landmarks,
  seed 5) through System(cfg, device="cpu") with the default vocabulary
  and through System(cfg, vocabulary=None): every keyframe is in the
  database, with the BoW rows the JAX package's vocabulary gives its
  descriptors; no loop can fire (the closer waits for more than 10
  keyframes and 10 since the last loop), so the two trajectories, maps and
  keyframes are equal. The loop closer ran on every mapped keyframe.
- Stereo and monocular: a short run of each sensor's sequence constructs
  and tracks with the vocabulary; the monocular map's initial keyframes
  go into the database when the map is created.
- Reset clears the database and the loop closer's state.
- ORB_TPU_STAGED_MAPPER=1 no longer raises (the staged mapper maps the
  RGB-D sequence's first keyframes, each into the database and through
  the loop closer), nor does ORB_DISTRIBUTED_GBA=1 (the loop closer
  shards its global BA).
- A map saved by the port loads in the JAX package and the other way
  round (models/serialization.py), and System.load_map rebuilds the
  database from the loaded keyframes.
Nothing launches a kernel here."""

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.models import serialization as jserialization
from orb_slam2_commit_tpu.models.vocabulary import default_vocabulary as j_default_vocabulary
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.models import serialization
from orb_slam2_commit_tpu_torch.models.vocabulary import default_vocabulary
from orb_slam2_commit_tpu_torch.slam.loop_closing import use_distributed_gba
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState
from orb_slam2_commit_tpu_torch.utils import synthetic
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT, N_FRAMES = 400, 300, 1000, 20
SEQ = dict(n_frames=N_FRAMES, n_points=400, seed=5, step=0.05, with_depth=True)
STEREO_FRAMES = 6
STAGED_FRAMES = 8
MONO_FRAMES = 14
MONO_SEQ = dict(n_frames=MONO_FRAMES, n_points=500, seed=3, step=0.025, motion="sweep",
                depth_range=(1.5, 4.0), spread=2.0)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = dict(_build.launches)
    yield
    assert _build.launches == before, "a kernel launched on the CPU"


def _run_rgbd(**kwargs):
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    images, _, _, depths = synthetic.render_sequence(cfg.camera, **SEQ)
    sys_ = System(cfg, async_mapping=False, device="cpu", **kwargs)
    poses = [sys_.track_rgbd(images[i], depths[i], i / 30.0) for i in range(N_FRAMES)]
    return sys_, poses


@pytest.fixture(scope="module")
def rgbd_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_TPU_FUSED_TRACK", "1")
        return _run_rgbd(), _run_rgbd(vocabulary=None)


def test_rgbd_keyframes_in_database(rgbd_runs):
    (sys_, _), _ = rgbd_runs
    assert sys_.vocabulary is default_vocabulary() and sys_.loop_closer is not None
    m, db = sys_.map, sys_.kf_database
    kfs = np.where(m.kf_valid)[0]
    assert kfs.size >= 4
    np.testing.assert_array_equal(db.present[:m.next_kf], m.kf_valid[:m.next_kf])
    # The rows are the JAX package's sparse BoW of the same descriptors.
    jvoc = j_default_vocabulary()
    for k in kfs:
        words, _ = jvoc.transform(m.kf_desc[k], m.kf_feat_valid[k])
        uw, wt = jvoc.sparse_bow(np.asarray(words))
        got_uw, got_wt = db.kf_bow(int(k))
        np.testing.assert_array_equal(got_uw, uw)
        np.testing.assert_allclose(got_wt, wt, atol=1e-6, rtol=0)
    timings = sys_.timings()
    assert timings["loop_closing"]["count"] == timings["local_mapping"]["count"] >= 3
    assert sys_.loop_closer.n_loops_closed == 0 and "loop_sim3" not in timings


def test_rgbd_trajectory_equals_vocabulary_free_run(rgbd_runs):
    (with_voc, poses_v), (without, poses_n) = rgbd_runs
    assert all(p is not None for p in poses_v)
    for a, b in zip(poses_v, poses_n):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(with_voc.trajectory_positions(),
                                  without.trajectory_positions())
    got, want = interop.map_state_to_numpy(with_voc.map), interop.map_state_to_numpy(without.map)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_stereo_tracks_with_vocabulary():
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="stereo")
    lefts, rights, _, _ = synthetic.render_stereo_sequence(
        cfg.camera, n_frames=STEREO_FRAMES, n_points=400, seed=5, step=0.05)
    sys_ = System(cfg, async_mapping=False, device="cpu")
    for i in range(STEREO_FRAMES):
        assert sys_.track_stereo(lefts[i], rights[i], i / 30.0) is not None
    assert sys_.tracking_state() == TrackingState.OK
    assert sys_.kf_database.present[:sys_.map.next_kf].all()


def test_monocular_registers_initial_keyframes():
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT)
    images, _, _ = synthetic.render_sequence(cfg.camera, **MONO_SEQ)
    sys_ = System(cfg, async_mapping=False, device="cpu")
    for i in range(MONO_FRAMES):
        was = sys_.tracking_state()
        sys_.track_monocular(images[i], i / 30.0)
        if was != TrackingState.OK and sys_.tracking_state() == TrackingState.OK:
            # The map was just created: both keyframes registered.
            assert sys_.map.next_kf == 2
            assert sys_.kf_database.present[:2].all()
    assert sys_.tracking_state() == TrackingState.OK
    np.testing.assert_array_equal(sys_.kf_database.present[:sys_.map.next_kf],
                                  sys_.map.kf_valid[:sys_.map.next_kf])

    sys_.loop_closer.n_loops_closed = 3
    sys_.reset()
    assert not sys_.kf_database.present.any()
    assert sys_.loop_closer.n_loops_closed == 0 and sys_.loop_closer.map is sys_.map
    assert sys_.tracker.kf_database is sys_.kf_database
    assert sys_.map.remove_kf_hooks == [sys_.kf_database.erase]


@pytest.mark.parametrize("switch", ["ORB_TPU_STAGED_MAPPER", "ORB_DISTRIBUTED_GBA"])
def test_routes_still_to_come_raise(switch, monkeypatch):
    """With the vocabulary, neither switch raises any more. The staged
    mapper route (ORB_TPU_STAGED_MAPPER=1): the RGB-D sequence's first
    STAGED_FRAMES frames track OK, their keyframes are mapped through
    _create_new_points_staged (with at least one neighbour pair and new
    points), and each goes into the database and through the loop closer.
    Global BA sharded over the process group (ORB_DISTRIBUTED_GBA=1): the
    System and its loop closer build, and the closer takes the sharded
    route (tests/test_torch_multihost.py runs it). (Asynchronous mapping
    no longer raises: tests/test_torch_async_pipeline.py.)"""
    monkeypatch.setenv(switch, "1")
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd")
    if switch == "ORB_DISTRIBUTED_GBA":
        sys_ = System(cfg, async_mapping=False, device="cpu")
        assert sys_.loop_closer is not None and use_distributed_gba()
        return
    images, _, _, depths = synthetic.render_sequence(cfg.camera, **SEQ)
    sys_ = System(cfg, async_mapping=False, device="cpu")
    staged, made = sys_.mapper._create_new_points_staged, []

    def spy(kf):
        before, pairs = sys_.map.next_pt, sys_.mapper._neighbor_pairs(kf)[1]
        staged(kf)
        made.append((len(pairs), sys_.map.next_pt - before))

    monkeypatch.setattr(sys_.mapper, "_create_new_points_staged", spy)
    for i in range(STAGED_FRAMES):
        sys_.track_rgbd(images[i], depths[i], i / 30.0)
        assert sys_.tracking_state() == TrackingState.OK, i
    m, timings = sys_.map, sys_.timings()
    assert len(made) == timings["local_mapping"]["count"] >= 2
    assert any(pairs and n > 0 for pairs, n in made), made
    np.testing.assert_array_equal(sys_.kf_database.present[:m.next_kf], m.kf_valid[:m.next_kf])
    assert timings["loop_closing"]["count"] == len(made)


def test_serialization_across_packages(rgbd_runs, tmp_path):
    (sys_, _), _ = rgbd_runs
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    sys_.map.loop_edges = [(0, 2)]
    try:
        sys_.save_map(port_file)
        want = interop.map_state_to_numpy(sys_.map)
    finally:
        sys_.map.loop_edges = []
    jm = jserialization.load_map(port_file)
    jserialization.save_map(jm, jax_file)
    for got in (interop.map_state_to_numpy(jm),
                interop.map_state_to_numpy(serialization.load_map(jax_file))):
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k

    fresh = System(sys_.config, async_mapping=False, device="cpu")
    fresh.load_map(jax_file)
    assert fresh.tracking_state() == TrackingState.LOST
    assert fresh.map.loop_edges == [(0, 2)]
    assert fresh.tracker.ref_kf == int(np.where(sys_.map.kf_valid)[0][-1])
    for f in ("present", "word_ids", "weights"):
        np.testing.assert_array_equal(getattr(fresh.kf_database, f),
                                      getattr(sys_.kf_database, f), err_msg=f)
    assert fresh.loop_closer.map is fresh.map and fresh.tracker.kf_database is fresh.kf_database
