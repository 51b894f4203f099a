"""The port's staged mapper route (ORB_TPU_STAGED_MAPPER=1) on the CPU.

One keyframe's mapping on a shared map snapshot, against the JAX
package's staged route: the port's System runs the RGB-D sequence of
tests/test_pipeline.py::TestRGBDPipeline (400x300, 1000 features, seed 5;
12 frames here) on the staged route, and the map is recorded just before
the mapper takes keyframe MAPPED_KF. From that snapshot both packages run
`_create_new_points_staged` (the JAX side in 32-bit mode, the port's
precision): the integer tables (bindings, validity, first keyframes) are
equal, and the new points, raw DLT triangulations from float32
eigensolves, agree to RAW_TRI_RTOL. From the JAX side's map after that
step both run the staged `_fuse_neighbors` (the forward pass one target
at a time, then the reverse pass): every table equal and the positions
bit for bit (a fuse moves no point).

Then the whole sequence on the staged route against the batched route in
the port: every frame OK in both, the same keyframes, point counts within
POINTS_RTOL (the batched route gates in float32 on the device, the staged
one in float64 on the host, so a point near a gate's edge can go either
way), and both under the 0.015 x span ATE gate with no scale alignment.
On the CPU nothing launches.
"""

import jax
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam.local_mapping import LocalMapper as JLocalMapper
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam2_commit_tpu_torch.slam.system import System
from orb_slam2_commit_tpu_torch.utils import synthetic, trajectory as traj
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT, N_FRAMES = 400, 300, 1000, 12
SEQ = dict(n_frames=N_FRAMES, n_points=400, seed=5, step=0.05, with_depth=True)
MAPPED_KF = 3
RAW_TRI_RTOL = 5e-4      # float32 eigensolves of A^T A in both packages
POINTS_RTOL = 0.02


def _configs():
    return (synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd"),
            j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor="rgbd"))


def _jax_map(d):
    """map_state_to_numpy's dict -> a JAX package MapState."""
    from orb_slam2_commit_tpu.models.map_state import MapState as JMapState
    from orb_slam2_commit_tpu.utils.config import MapConfig as JMapConfig

    arrays = {k: np.array(v, copy=True) for k, v in d.items()
              if k not in interop.MAP_SCALARS and k not in ("cfg", "loop_edges")}
    return JMapState(cfg=JMapConfig(**d["cfg"]), loop_edges=list(d["loop_edges"]),
                     **{k: d[k] for k in interop.MAP_SCALARS}, **arrays)


def _run(staged, record=None):
    cfg, _ = _configs()
    images, poses_gt, _, depths = synthetic.render_sequence(cfg.camera, **SEQ)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORB_TPU_STAGED_MAPPER", "1" if staged else "0")
        sys_ = System(cfg, vocabulary=None, async_mapping=False, device="cpu")
        if record is not None:
            process = sys_.mapper.process_keyframe

            def spy(kf):
                if kf == MAPPED_KF:
                    record["map"] = interop.map_state_to_numpy(sys_.map)
                process(kf)

            mp.setattr(sys_.mapper, "process_keyframe", spy)
        states = []
        for i in range(N_FRAMES):
            sys_.track_rgbd(images[i], depths[i], i / 30.0)
            states.append(sys_.tracking_state().name)
    return sys_, states, poses_gt


@pytest.fixture(scope="module")
def runs():
    before = dict(_build.launches)
    record = {}
    staged = _run(True, record)
    batched = _run(False)
    assert _build.launches == before, "a kernel launched on the CPU"
    assert "map" in record
    return staged, batched, record


def _mapper_step(d, step):
    """(the port's map dict, the JAX package's) after `step` of the staged
    route on the snapshot d."""
    cfg, jcfg = _configs()
    ms = interop.map_state_from_numpy(d)
    jms = _jax_map(d)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setenv("ORB_TPU_STAGED_MAPPER", "1")
        getattr(LocalMapper(cfg, ms, device="cpu"), step)(MAPPED_KF)
        getattr(JLocalMapper(jcfg, jms), step)(MAPPED_KF)
    return interop.map_state_to_numpy(ms), interop.map_state_to_numpy(jms)


def _tables_equal(got, want):
    for k, w in want.items():
        if isinstance(w, np.ndarray) and w.dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        elif not isinstance(w, np.ndarray):
            assert got[k] == w, k


def test_staged_triangulation_and_fuse_match_jax(runs):
    _, _, record = runs
    d0 = record["map"]
    got, want = _mapper_step(d0, "_create_new_points_staged")
    made = want["next_pt"] - d0["next_pt"]
    assert made > 0
    _tables_equal(got, want)
    new = slice(d0["next_pt"], want["next_pt"])
    np.testing.assert_allclose(got["pt_pos"][new], want["pt_pos"][new], rtol=RAW_TRI_RTOL)

    d1 = want
    got, want = _mapper_step(d1, "_fuse_neighbors")
    assert not np.array_equal(want["kf_point_idx"], d1["kf_point_idx"])   # it fused
    _tables_equal(got, want)
    np.testing.assert_array_equal(got["pt_pos"], want["pt_pos"])


def test_staged_system_run_against_batched(runs):
    (s_sys, s_states, poses_gt), (b_sys, b_states, _), _ = runs
    assert all(st == "OK" for st in s_states + b_states), (s_states, b_states)
    a, b = s_sys.map, b_sys.map
    assert a.next_kf == b.next_kf >= 4
    np.testing.assert_array_equal(a.kf_frame_id[:a.next_kf], b.kf_frame_id[:b.next_kf])
    assert abs(a.next_pt - b.next_pt) <= POINTS_RTOL * b.next_pt
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    span = np.linalg.norm(gt[-1] - gt[0])
    for sys_ in (s_sys, b_sys):
        rmse = traj.ate_rmse(sys_.trajectory_positions(), gt, align_scale=False)
        assert rmse < 0.015 * span, (rmse, span)
