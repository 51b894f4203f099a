"""The port's online entry points as a user calls them, on the CPU
(--device=cpu): the live driver's --sim stream, the AR demo and the
synthetic monocular demo, each a few frames; without --device they run on
the CUDA card and refuse here. The live driver's flag parser is the JAX
driver's. Nothing launches a kernel on the CPU."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu_torch.examples import run_ar, run_live, run_synthetic_mono
from orb_slam2_commit_tpu_torch.kernels import _build
from orb_slam2_commit_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_launch():
    before = dict(_build.launches)
    yield
    assert _build.launches == before


def test_live_sim_on_the_cpu(capsys):
    assert run_live.main(["--sim", "--frames", "3", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "stream done: 3 frames in" in out


def test_live_usage_and_flags(capsys):
    assert run_live.main([]) == 1
    assert "--listen" in capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "jax_run_live", os.path.join(REPO, "examples", "run_live.py"))
    jrl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jrl)
    for argv in (["--sim", "--frames", "5", "--viewer"], ["--listen=7007", "--sensor", "rgbd"],
                 ["--connect", "host:1", "--viewer-dir", "d", "--device=cpu"]):
        assert run_live.parse_flags(argv) == jrl.parse_flags(argv)
    with pytest.raises(SystemExit, match="--listen requires a value"):
        run_live.value_of(run_live.parse_flags(["--listen"]), "--listen")
    with pytest.raises(SystemExit, match="positional"):
        run_live.parse_flags(["7007"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_live.main(["--sim", "--frames", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ar.main(["1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_synthetic_mono.main(["1"])


def test_ar_demo_writes_rgb_pngs(tmp_path):
    out = str(tmp_path / "ar")
    r = run_ar.run(3, out, device="cpu")
    assert len(r.pngs) == 3 and r.overlaid == [False] * 3   # no map yet: no cube
    for path in r.pngs:
        image = read_png(path)
        assert image.shape == (300, 400, 3) and image.dtype == np.uint8
    assert run_ar.main(["2", "--out", out, "--device=cpu"]) == 0


def test_synthetic_mono_demo(capsys):
    assert run_synthetic_mono.main(["3", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "tracked" in out and "extract_frame" in out
