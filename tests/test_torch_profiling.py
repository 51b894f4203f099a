"""The port's device_trace (utils/profiling.py) against the JAX
package's contract (tests/test_profiling.py): it never raises, yields
False when disabled, and yields whether it traces. On this machine (no
card) it traces the host's operators, and the trace is a Chrome trace
file; a second trace while one runs yields False and leaves the first
intact. The port's Profiler keeps the JAX Profiler's summary."""

import json
import os

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.utils.profiling import Profiler as JaxProfiler
from orb_slam2_commit_tpu.utils.profiling import device_trace as jax_device_trace
from orb_slam2_commit_tpu_torch.utils.profiling import Profiler, device_trace

torch.set_num_threads(1)


def _traces(path):
    return sorted(p for p in os.listdir(path) if p.startswith("trace_"))


def test_disabled_yields_false(tmp_path):
    for trace in (device_trace, jax_device_trace):
        with trace(str(tmp_path), enabled=False) as active:
            assert active is False
    assert _traces(tmp_path) == []


def test_enabled_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as active:
        assert active is True
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = _traces(tmp_path)
    assert len(names) == 1
    with open(tmp_path / names[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # A second trace in the same directory gets a file of its own.
    with device_trace(str(tmp_path)) as active:
        assert active is True
    assert len(_traces(tmp_path)) == 2


def test_nested_trace_is_a_no_op(tmp_path):
    outer, inner = tmp_path / "outer", tmp_path / "inner"
    with device_trace(str(outer)) as a:
        with device_trace(str(inner)) as b:
            assert (a, b) == (True, False)
        torch.ones(8) + 1
    assert len(_traces(outer)) == 1 and not inner.exists()
    # Under a torch.profiler session started elsewhere: no trace, no raise.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with device_trace(str(inner)) as b:
            assert b is False
    assert not inner.exists()


@pytest.mark.parametrize("dts", [(0.01, 0.02, 0.03), (0.004, 0.001)])
def test_profiler_summary_equals_jax(dts):
    port, ref = Profiler(), JaxProfiler()
    for dt in dts:
        port.record("stage", dt)
        ref.record("stage", dt)
    a, b = port.summary()["stage"], ref.summary()["stage"]
    assert a.keys() == b.keys()
    np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a], rtol=0, atol=1e-12)
