"""The port's trajectory writers, evaluation and stage profiler on the CPU
against the JAX package's, on the same seeded trajectories: the TUM and
KITTI files byte for byte (the quaternion in float64 on both sides, x64
being on in the suite), umeyama_alignment, ate_rmse and rpe_stats to
1e-12, and the Profiler's counts and ordering on a scripted clock."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_commit_tpu.ops import lie as jlie
from orb_slam2_commit_tpu.utils import profiling as jprofiling
from orb_slam2_commit_tpu.utils import trajectory as jtraj
from orb_slam2_commit_tpu_torch.utils import profiling, trajectory as traj

torch.set_num_threads(1)


def _poses(seed, n=25, noise=0.0):
    rng = np.random.default_rng(seed)
    w = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0) + rng.normal(0, noise, (n, 3))
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    t = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    return [(R[i], t[i]) for i in range(n)]


@pytest.mark.parametrize("writer", ["write_tum", "write_kitti"])
def test_writers_match_jax(tmp_path, writer):
    entries = [(i / 30.0, R, t) for i, (R, t) in enumerate(_poses(1))]
    getattr(jtraj, writer)(str(tmp_path / "jax.txt"), entries)
    getattr(traj, writer)(str(tmp_path / "port.txt"), entries)
    want = (tmp_path / "jax.txt").read_text()
    assert (tmp_path / "port.txt").read_text() == want
    assert len(want.splitlines()) == len(entries)


@pytest.mark.parametrize("with_scale", [True, False])
def test_alignment_and_ate_match_jax(with_scale):
    rng = np.random.default_rng(2)
    gt = np.cumsum(rng.normal(0, 0.1, (40, 3)), axis=0)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.1])))
    est = (0.7 * gt @ R.T + [1.0, 2.0, -0.5]) + rng.normal(0, 0.01, gt.shape)
    for got, want in zip(traj.umeyama_alignment(est, gt, with_scale),
                         jtraj.umeyama_alignment(est, gt, with_scale)):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert traj.ate_rmse(est, gt, with_scale) == pytest.approx(
        jtraj.ate_rmse(est, gt, with_scale), abs=1e-12)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_jax(delta):
    est, gt = _poses(3, noise=0.01), _poses(3)
    got, want = traj.rpe_stats(est, gt, delta), jtraj.rpe_stats(est, gt, delta)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_profiler_matches_jax(monkeypatch):
    """The same stages with the same scripted durations give the same
    summary (counts, mean, EMA, min, max, total) and report."""
    durations = [0.004, 0.010, 0.002, 0.007, 0.001]
    stages = ("track", "map", "track", "track", "map")
    out = []
    for mod in (jprofiling, profiling):
        clock = {"t": 0.0}
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock["t"])
        p = mod.Profiler()
        for stage, dt in zip(stages, durations):
            with p.timed(stage):
                clock["t"] += dt
        p.record("extract", 0.25)
        out.append((p.summary(), p.report()))
        p.reset()
        assert p.summary() == {}
    (want, want_report), (got, got_report) = out
    assert got.keys() == want.keys()
    for stage, stats in want.items():
        for k, v in stats.items():
            assert got[stage][k] == pytest.approx(v, abs=1e-12), (stage, k)
    assert got_report == want_report
