"""The tracker's eight single-dispatch forms (slam/jit_frontend.py's
`*_jit`) and the CUDA graph module behind them (utils/cuda_graph.py), on
the CPU:

- each form's parameters are its JAX namesake's, by name and in order;
- on CPU tensors each form calls its eager function on its arguments
  and returns that result itself, and makes no graph
  (torch.cuda.CUDAGraph raises if touched), at the sizes of
  tests/test_torch_fused.py (320x240, 400 features, 256 last-frame
  points, 512 candidates);
- the four forms that no other test holds to their JAX namesakes
  (`tracking_forward_step_jit` and the non-packed motion forms) against
  them on the same numpy inputs (interop's seeded examples), at
  tests/test_torch_frontend.py's and tests/test_torch_fused_sensors.py's
  tolerances, each JAX namesake compiled once;
- the graph module's key, its launch bookkeeping and `release`, in pure
  Python.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.slam import jit_frontend as jjf
from orb_slam2_commit_tpu.utils.config import synthetic_config as j_synthetic_config
from orb_slam2_commit_tpu_torch import interop
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.slam import jit_frontend
from orb_slam2_commit_tpu_torch.utils import cuda_graph
from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

torch.set_num_threads(1)

W, H, N_FEAT, N_PTS, N_CAND = 320, 240, 400, 256, 512
LM_TH = 3.0          # config.tracker.search_radius_local_map
FORMS = ("tracking_forward_step", "fused_motion_track", "fused_stereo_motion_track",
         "fused_rgbd_motion_track", "fused_motion_track_packed",
         "fused_stereo_motion_track_packed", "fused_rgbd_motion_track_packed",
         "fused_local_map_track")
SECOND = {"stereo": "image_r", "rgbd": "depth"}


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """One thread; on the CPU nothing launches and no graph is made."""
    torch.set_num_threads(1)

    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    monkeypatch.setenv("ORB_TPU_FORCE_PACKED", "1")
    before, graphs = dict(_build.launches), dict(cuda_graph.graphs)
    yield
    assert _build.launches == before
    assert cuda_graph.graphs == graphs


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def _unpacked(a, sensor):
    """The non-packed motion form's numpy arguments after its images."""
    pt, meta = a["pt_f32"], a["meta_f32"]
    tail = [pt[:, 0:3], a["pt_desc"], pt[:, 3].astype(np.int32), pt[:, 4], pt[:, 5] > 0.5,
            meta[0:9].reshape(3, 3), meta[9:12]]
    return tail + ([np.float32(meta[12])] if sensor != "monocular" else [])


@pytest.fixture(scope="module")
def inputs():
    """form -> (port config, JAX config, numpy arguments) at the small size."""
    out = {}
    config, args = interop.make_example(W, H, N_FEAT, N_PTS, device="cpu")
    arrays = [a.numpy() for a in args]
    arrays[2] = arrays[2].view(np.uint32)
    out["tracking_forward_step"] = (
        config, j_synthetic_config(width=W, height=H, n_features=N_FEAT), arrays)
    for sensor in ("monocular", "stereo", "rgbd"):
        cfg, a = interop.fused_example_arrays(W, H, N_FEAT, N_PTS, N_CAND, device="cpu",
                                              sensor=sensor)
        jcfg = j_synthetic_config(width=W, height=H, n_features=N_FEAT, sensor=sensor)
        images = [a["image"]] + ([a[SECOND[sensor]]] if sensor in SECOND else [])
        packed = "fused_motion_track_packed" if sensor == "monocular" else \
            f"fused_{sensor}_motion_track_packed"
        out[packed] = (cfg, jcfg, images + [a["pt_f32"], a["pt_desc"], a["meta_f32"]])
        out[packed.replace("_packed", "")] = (cfg, jcfg, images + _unpacked(a, sensor))
        if sensor == "monocular":
            motion = jit_frontend.fused_motion_track_packed(
                *interop.packed_from_numpy(*out[packed][2], device="cpu"), cfg)
            feat_state, lm_meta = interop.local_map_args(
                motion, torch.from_numpy(a["pt_f32"]), LM_TH)
            out["fused_local_map_track"] = (cfg, jcfg, [
                motion[1].numpy(), motion[2].numpy(), feat_state.numpy(), a["cand_f32"],
                a["cand_desc"], lm_meta.numpy()])
    return out


def _torch_args(arrays):
    """numpy arguments -> CPU tensors, uint32 descriptors as int32 bits."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x).view(np.int32)
                                  if x.dtype == np.uint32 else np.ascontiguousarray(x))
                 if isinstance(x, np.ndarray) else torch.tensor(x) for x in arrays)


@pytest.fixture(scope="module")
def forms(inputs):
    """form -> its `*_jit` result on its inputs, each computed once."""
    cache = {}

    def result(name):
        if name not in cache:
            cfg, _, arrays = inputs[name]
            cache[name] = getattr(jit_frontend, f"{name}_jit")(*_torch_args(arrays), cfg)
        return cache[name]

    return result


@pytest.mark.parametrize("name", FORMS)
def test_parameters_are_the_jax_namesakes(name):
    port = list(inspect.signature(getattr(jit_frontend, f"{name}_jit")).parameters)
    jax_ = list(inspect.signature(getattr(jjf, f"{name}_jit")).parameters)
    assert port == jax_ and port[-1] == "config"


@pytest.mark.parametrize("name", FORMS)
def test_cpu_form_is_the_eager_function(inputs, monkeypatch, name):
    """On CPU tensors a form calls its eager function once, on the very
    arguments it was given, and returns that call's result itself (so it
    equals the eager function bit for bit)."""
    cfg, _, arrays = inputs[name]
    args = _torch_args(arrays)
    calls, result = [], object()

    def eager(*a):
        calls.append(a)
        return result

    monkeypatch.setattr(jit_frontend, name, eager)
    assert getattr(jit_frontend, f"{name}_jit")(*args, cfg) is result
    assert len(calls) == 1 and len(calls[0]) == len(args) + 1
    assert all(a is b for a, b in zip(calls[0], args)) and calls[0][-1] is cfg


def test_tracking_forward_step_jit_matches_jax(inputs, forms):
    _, jcfg, arrays = inputs["tracking_forward_step"]
    with jax.enable_x64(False):
        ref = jjf.tracking_forward_step_jit(*(jnp.asarray(x) for x in arrays), jcfg)
        ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = interop.step_to_numpy(forms("tracking_forward_step"))
    assert int(got["n_matches"]) == int(ref["n_matches"]) > 50
    assert int(got["n_inliers"]) == int(ref["n_inliers"])
    assert rot_angle(got["R"], ref["R"]) < 0.05
    assert np.linalg.norm(got["t"] - ref["t"]) < 2e-3
    np.testing.assert_allclose(got["feat_xy"], ref["feat_xy"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("sensor", ("monocular", "stereo", "rgbd"))
def test_motion_track_jit_matches_jax(inputs, forms, sensor):
    name = "fused_motion_track" if sensor == "monocular" else f"fused_{sensor}_motion_track"
    _, jcfg, arrays = inputs[name]
    with jax.enable_x64(False):
        ref = getattr(jjf, f"{name}_jit")(*(jnp.asarray(x) for x in arrays), jcfg)
        ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: v.numpy() for k, v in forms(name)._asdict().items()}
    for key in ("octave", "valid", "binding"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert int(got["n_matches"]) == int(ref["n_matches"]) > 50
    assert abs(int(got["n_inliers"]) - int(ref["n_inliers"])) <= 0.01 * int(ref["n_inliers"])
    assert rot_angle(got["R"], ref["R"]) < 0.05
    assert np.linalg.norm(got["t"] - ref["t"]) < 2e-3
    np.testing.assert_allclose(got["xy_raw"], ref["xy_raw"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["xy_und"], ref["xy_und"], atol=1e-4, rtol=0)
    assert np.mean(np.any(got["desc"] != ref["desc"].view(np.int32), axis=1)) <= 0.01
    if sensor == "rgbd":
        np.testing.assert_array_equal(got["depth"], ref["depth"])
        np.testing.assert_allclose(got["ur"], ref["ur"], atol=1e-4, rtol=0)
    elif sensor == "stereo":
        np.testing.assert_array_equal(got["ur"] >= 0, ref["ur"] >= 0)
        np.testing.assert_allclose(got["ur"], ref["ur"], atol=1e-3, rtol=0)


def test_key_holds_function_config_shapes_dtypes_and_device():
    cfg = synthetic_config(width=W, height=H, n_features=N_FEAT)
    a, b = torch.zeros(4, 3), torch.zeros(5)
    k = cuda_graph.key(jit_frontend.fused_motion_track, (a, b), cfg)
    assert k == cuda_graph.key(jit_frontend.fused_motion_track, (a + 1, b), cfg)
    assert hash(k) == hash(cuda_graph.key(jit_frontend.fused_motion_track,
                                          (torch.ones(4, 3), b), cfg))
    for other in (
            cuda_graph.key(jit_frontend.fused_rgbd_motion_track, (a, b), cfg),
            cuda_graph.key(jit_frontend.fused_motion_track, (a, b),
                           synthetic_config(width=W, height=H, n_features=N_FEAT + 1)),
            cuda_graph.key(jit_frontend.fused_motion_track, (torch.zeros(5, 3), b), cfg),
            cuda_graph.key(jit_frontend.fused_motion_track, (a.double(), b), cfg),
            cuda_graph.key(jit_frontend.fused_motion_track, (a, b), cfg, static=(False, None)),
            cuda_graph.key(jit_frontend.fused_motion_track, (a.to("meta"), b), cfg)):
        assert other != k


def test_replays_add_the_captured_launches(monkeypatch):
    """The capture's launches go to its tally, not to the counters; each
    replay adds the tally once; another thread counts as before."""
    import threading

    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: None)
    saved = dict(_build.launches)
    _build.reset_launches()
    with _build.recorded_launches() as tally:
        _build.count_launch("level_preprocess")
        _build.count_launch("pose_lm")
        _build.count_launch("pose_lm")
        other = threading.Thread(target=_build.count_launch, args=("combine_nms",))
        other.start()
        other.join()
    assert tally == {"level_preprocess": 1, "pose_lm": 2}
    assert {k: v for k, v in _build.launches.items() if v} == {"combine_nms": 1}
    g = cuda_graph.Graph(None, torch.device("cpu"), (), (), dict(tally), None)
    replayed = dict(cuda_graph.replayed_launches)
    for n in (1, 2, 3):
        g.replayed()
        assert g.replays == n
        assert _build.launches["pose_lm"] == 2 * n
        assert _build.launches["level_preprocess"] == n
        assert cuda_graph.replayed_launches["pose_lm"] == replayed.get("pose_lm", 0) + 2 * n
    _build.count_launch("pose_lm")
    assert _build.launches["pose_lm"] == 7
    _build.launches.update(saved)


def test_release_drops_the_graphs_of_a_configuration(monkeypatch):
    a, b, c = (synthetic_config(width=W, height=H, n_features=n) for n in (100, 200, 300))
    x = (torch.zeros(2),)
    keys = [cuda_graph.key(jit_frontend.fused_motion_track, x, cfg) for cfg in (a, b, c)]
    monkeypatch.setattr(cuda_graph, "graphs", {k: object() for k in keys})
    assert cuda_graph.release(a, b) == 2
    assert list(cuda_graph.graphs) == keys[2:]
    assert cuda_graph.release(a) == 0
    assert cuda_graph.release() == 1 and not cuda_graph.graphs


def test_arguments_on_two_devices_or_not_tensors_raise(inputs):
    cfg = inputs["fused_motion_track_packed"][0]
    with pytest.raises(ValueError):
        cuda_graph.call(jit_frontend.fused_motion_track_packed,
                        (torch.zeros(2), torch.zeros(2, device="meta")), cfg)
    with pytest.raises(ValueError):
        cuda_graph.call(jit_frontend.fused_motion_track_packed,
                        (torch.zeros(2, device="meta"),), cfg)
