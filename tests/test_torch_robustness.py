"""tests/test_robustness.py::TestLocalWindowSpanningTree against the port:
UpdateLocalKeyFrames adds the spanning-tree children and parent of the
covisibility window (reference src/Tracking.cc:1573-1621), the escape
hatch when covisibility alone starves. The same hand-made map (a keyframe
whose only link to the frame's points is below the covisibility
threshold, one that shares nothing) goes through the port's Tracker and
the JAX package's, and both give the same local window, holding the
child and the parent. On the CPU."""

import types

import numpy as np
import pytest

from orb_slam2_commit_tpu.models.map_state import MapState as JMapState
from orb_slam2_commit_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_commit_tpu.utils.config import MapConfig as JMapConfig
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch.models.map_state import INVALID, MapState
from orb_slam2_commit_tpu_torch.slam.tracking import Tracker
from orb_slam2_commit_tpu_torch.utils.config import MapConfig, synthetic_config

N = 32


def _map(map_cls, map_cfg):
    m = map_cls.create(map_cfg(max_keyframes=8, max_points=256), N)

    def add_kf(bound_pids):
        fvalid = np.zeros(N, bool)
        binding = np.full(N, INVALID, np.int32)
        fvalid[:len(bound_pids)] = True
        binding[:len(bound_pids)] = bound_pids
        return m.add_keyframe(
            np.eye(3), np.zeros(3), np.zeros((N, 2)), np.zeros(N, np.int32),
            np.zeros(N, np.float32), np.zeros((N, 8), np.uint32), fvalid, binding,
            frame_id=m.next_kf, timestamp=float(m.next_kf))

    # KF0 observes points 0-19; KF1 shares only 5 with KF0 (below the
    # covisibility threshold 15) but is KF0's spanning-tree child; KF2 is
    # KF0's parent, sharing nothing.
    pids = m.add_points(np.random.default_rng(0).uniform(-1, 1, (40, 3)) + [0, 0, 5],
                        first_kf=0)
    kf0 = add_kf(pids[:20])
    kf1 = add_kf(pids[15:20].tolist() + pids[20:35].tolist())
    kf2 = add_kf(pids[35:40])
    m.kf_parent[kf1] = kf0
    m.kf_parent[kf0] = kf2
    return m, pids, (kf0, kf1, kf2)


@pytest.mark.parametrize("sensor", ["monocular", "rgbd"])
def test_tree_links_expand_starved_window(sensor):
    m, pids, (kf0, kf1, kf2) = _map(MapState, MapConfig)
    jm, _, _ = _map(JMapState, JMapConfig)
    frame = types.SimpleNamespace(point_ids=np.asarray(pids[:15], np.int32))
    cfg = synthetic_config(width=320, height=240, n_features=N, sensor=sensor)
    jcfg = j_synthetic_config(width=320, height=240, n_features=N, sensor=sensor)
    local = Tracker(cfg, m, device="cpu")._local_keyframes(frame)
    want = JTracker(jcfg, jm)._local_keyframes(frame)
    np.testing.assert_array_equal(local, np.asarray(want))
    assert {kf0, kf1, kf2} <= set(local.tolist())
