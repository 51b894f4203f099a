"""The check that decides `correct`, driven through a whole run on the CPU
at a size a test holds (the harness's look for a card skipped): sound runs
pass every limit, the control (the reference's solve in bfloat16 in the
program's place) fails every limit that the configuration does not state
itself, and a run whose timed path is broken underneath comes out not
correct: a pose solve or a local BA that returns its state unchanged, a
pose solved from half its matches (the mean over the rest), and an answer
(a pose, a stereo right coordinate, a depth, an undistorted keypoint)
altered where it is produced."""

import time

import pytest
import torch

from slambench import cell, registry, run
from slambench.tests.conftest import tiny

SIZES = {"kitti-stereo.explore": dict(pool=45, warmup=12),
         "tum-rgbd.corridor": dict(pool=60, warmup=15)}
# Frames a test window feeds (a CPU window is counted, not timed).
FRAMES = {"kitti-stereo.explore": 30, "tum-rgbd.corridor": 40}
# Limits the configuration states itself: the control need not fail them.
STATED = {"failed_frames"}
# The control's drift is bfloat16's rounding of a pose, which grows with
# the distance from the map's origin: a test window does not drive far
# enough for it to fail (on the card it reads 1.9% and more, and a
# stereo matcher a pixel off reads 4.7% here).
FAR = {"drift_pct"}


def drive(workload):
    bench, wl, cfg, tr = tiny(workload, **SIZES[workload])
    limits = registry.limits(workload)
    result, rows = run.run_cell(bench, wl, cfg, tr, limits, 987654321987, 1e9, False,
                                device="cpu", t_start=time.perf_counter(),
                                max_frames=FRAMES[workload])
    return result, rows, (bench, wl, cfg, tr, limits)


@pytest.mark.parametrize("workload,fused", [("kitti-stereo.explore", "0"),
                                            ("tum-rgbd.corridor", "0"),
                                            ("tum-rgbd.corridor", "1")])
def test_sound_run_passes_and_control_fails(workload, fused, monkeypatch):
    """On the CPU's staged path, and on the card's fused stages run eagerly
    (where the inlier test reads the fused local-map stage's output)."""
    monkeypatch.setenv("ORB_TPU_FUSED_TRACK", fused)
    bench, wl, cfg, tr = tiny(workload, **SIZES[workload])
    limits = registry.limits(workload)
    c = cell.Cell(cfg, tr, 123456789123, device="cpu")
    c.set_up()
    c.window(1e9, float(tr["check"]["frame_share"]), FRAMES[workload])
    program = c.numbers()
    control = c.numbers(dtype=torch.bfloat16)
    print(workload, "program", program, "control", control)
    assert c.frame_answers and c.kf_answers
    assert all(a.matches is not None for a in c.frame_answers)
    for name, limit in limits.items():
        assert program[name] is not None and program[name] <= limit, (name, program)
        if name not in STATED | FAR:
            assert control[name] > limit, (name, control)


def _pose_unchanged(monkeypatch):
    from orb_slam2_commit_tpu_torch.optim import pose_opt

    solve = pose_opt.pose_optimization_jit

    def unchanged(R0, t0, *args, **kwargs):
        return solve(R0, t0, *args, **kwargs)._replace(R=R0.clone(), t=t0.clone())

    monkeypatch.setattr(pose_opt, "pose_optimization_jit", unchanged)


def _pose_altered(monkeypatch):
    from orb_slam2_commit_tpu_torch.optim import pose_opt

    solve = pose_opt.pose_optimization_jit

    def altered(*args, **kwargs):
        res = solve(*args, **kwargs)
        return res._replace(t=res.t + 0.02)

    monkeypatch.setattr(pose_opt, "pose_optimization_jit", altered)


def _pose_half(monkeypatch):
    """The pose solve over every other match alone (the mean over the
    rest): the matches left out come back as outliers."""
    from orb_slam2_commit_tpu_torch.optim import pose_opt

    solve = pose_opt.pose_optimization_jit

    def half(R0, t0, points, obs, *args, **kwargs):
        keep = obs.valid.clone()
        keep[1::2] = False
        return solve(R0, t0, points, obs._replace(valid=keep), *args, **kwargs)

    monkeypatch.setattr(pose_opt, "pose_optimization_jit", half)


def _stereo_shifted(monkeypatch):
    """Every stereo match's right coordinate one pixel to the right, its
    depth from that disparity (a stereo matcher off by a pixel)."""
    from orb_slam2_commit_tpu_torch.ops import stereo as stereo_ops

    front = stereo_ops.stereo_frontend_jit

    def shifted(*args, **kwargs):
        feats, levels, m = front(*args, **kwargs)
        ok = (m.depth > 0) & (m.u_right >= 0)
        bf = float(args[5]) if len(args) > 5 else float(kwargs["bf"])
        disparity = bf / torch.where(ok, m.depth, torch.ones_like(m.depth))
        ok = ok & (disparity > 2.0)
        depth = torch.where(ok, bf / (disparity - 1.0), m.depth)
        return feats, levels, m._replace(u_right=torch.where(ok, m.u_right + 1.0, m.u_right),
                                         depth=depth)

    monkeypatch.setattr(stereo_ops, "stereo_frontend_jit", shifted)


def _lba_unchanged(monkeypatch):
    from orb_slam2_commit_tpu_torch.optim import ba

    solve = ba.local_bundle_adjust

    def unchanged(problem, *args, **kwargs):
        _, result = solve(problem, *args, **kwargs)
        return problem, result

    monkeypatch.setattr(ba, "local_bundle_adjust", unchanged)


def _depth_altered(monkeypatch):
    from orb_slam2_commit_tpu_torch.slam import frame as frame_mod
    from orb_slam2_commit_tpu_torch.slam import system

    make = frame_mod.make_frame

    def altered(*args, **kwargs):
        f = make(*args, **kwargs)
        f.depth = (f.depth * (f.depth > 0) * 1.0005 + (f.depth <= 0) * f.depth).astype(
            f.depth.dtype)
        return f

    monkeypatch.setattr(system, "make_frame", altered)


def _lens_altered(monkeypatch):
    from orb_slam2_commit_tpu_torch.slam import frame as frame_mod
    from orb_slam2_commit_tpu_torch.slam import system

    make = frame_mod.make_frame

    def altered(*args, **kwargs):
        f = make(*args, **kwargs)
        f.xy = f.xy + 0.2
        return f

    monkeypatch.setattr(system, "make_frame", altered)


FAULTS = [("kitti-stereo.explore", _pose_unchanged), ("kitti-stereo.explore", _pose_altered),
          ("kitti-stereo.explore", _pose_half), ("kitti-stereo.explore", _stereo_shifted),
          ("kitti-stereo.explore", _lba_unchanged), ("tum-rgbd.corridor", _pose_unchanged),
          ("tum-rgbd.corridor", _lba_unchanged), ("tum-rgbd.corridor", _pose_half),
          ("tum-rgbd.corridor", _depth_altered), ("tum-rgbd.corridor", _lens_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, rows, _ = drive(workload)
    print(workload, fault.__name__, rows)
    assert result["correct"] is False, rows
