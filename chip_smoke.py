#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card: name, count, torch/CUDA versions, nvidia-smi name + power limit;
  2. build every kernel of the tracking step from csrc/ (one nvcc per
     source, all at once) and print nvcc's register and shared-memory lines;
  3. each kernel against its plain PyTorch version on the card, on the
     tensors the main path gives it at 640x480 / 1000 features;
  4. the main path: the tracking step at that width through the port's
     entry points, with the kernels' launch counts read around it, and
     its result held against the same step on the CPU;
  5. timing: step throughput by the bench recipe; per stage of the step
     its synchronised wall time and device time, and under torch.profiler
     the device's busy time, idle share and operations per step; per
     kernel its time, its plain version's time, one library call's time
     where one exists, and the least time the card could take (its bound).
Then a `kernels` JSON line, the nvidia-smi line, and last the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

try:
    from orb_slam2_commit_tpu_torch import interop
    from orb_slam2_commit_tpu_torch.kernels import _build, level, patches, select
    from orb_slam2_commit_tpu_torch.ops import extractor
    from orb_slam2_commit_tpu_torch.ops import packed_extractor as pe
    from orb_slam2_commit_tpu_torch.optim import pose_opt
    from orb_slam2_commit_tpu_torch.slam import matchers
    from orb_slam2_commit_tpu_torch.slam.jit_frontend import (
        pose_inputs, tracking_forward_step)
    from orb_slam2_commit_tpu_torch.utils.config import synthetic_config
except ImportError as e:   # the script was copied away from its repository
    raise SystemExit(f"chip_smoke: run it from the repository root ({e})")

# The H100 SXM's published rates (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

WIDTH, HEIGHT, N_FEATURES, N_POINTS = 640, 480, 1000, 1024
# Pose bounds of the port's tests (rotation in degrees, translation).
ROT_DEG_TOL, T_TOL = 0.05, 2e-3
# Steps traced by torch.profiler for the device's busy time and idle share.
PROFILE_STEPS = 5


def log(*parts):
    print(*parts, flush=True)


def rot_angle_deg(Ra, Rb):
    Ra, Rb = np.asarray(Ra, np.float64), np.asarray(Rb, np.float64)
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def gpu_time_ms(fn, iters, warmup=3):
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"device: {name} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, count, smi


def phase_build():

    t0 = time.perf_counter()
    results = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(results)} "
        f"(one nvcc per source, in parallel)")
    for name, (seconds, text) in sorted(results.items()):
        log(f"  {name}.cu: {seconds:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())


def main_path_inputs(image):
    """The tensors the tracking step hands each kernel, on the card."""
    config = synthetic_config(width=WIDTH, height=HEIGHT, n_features=N_FEATURES)
    orb = config.orb
    plan = pe.make_plan(orb, HEIGHT, WIDTH)
    canvas = pe.build_canvas(image, plan)
    blur_c, hi_c, lo_c = level.level_preprocess(
        canvas, float(orb.ini_th_fast), float(orb.min_th_fast))
    bounds = torch.from_numpy(pe._bounds_np(plan, hi_c.shape[0])).to(image.device)
    score = level.combine_nms(hi_c, lo_c, bounds)
    cells = pe.cell_matrix(score, orb.cell_size)
    yx, _, _ = pe.select_flat(score, plan, orb)
    return dict(canvas=canvas, blur=blur_c, hi=hi_c, lo=lo_c, bounds=bounds,
                cells=cells, k=orb.cell_top_k, yx=yx, ths=(
                    float(orb.ini_th_fast), float(orb.min_th_fast)))


def phase_kernels(x):
    """Each kernel against its plain version on the card (not counted as
    main-path launches: the counts are reset before the main path)."""

    rows = {}
    th_hi, th_lo = x["ths"]
    canvas = x["canvas"]

    got = level.level_preprocess(canvas, th_hi, th_lo)
    padded, hp, wp = level.pad_level(canvas)
    want = level.level_preprocess_plain(padded, hp, wp, th_hi, th_lo)
    torch.cuda.synchronize()
    err = max(max_abs(g, w) for g, w in zip(got, want))
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"K1 level_preprocess {tuple(canvas.shape)} -> 3x{tuple(got[0].shape)}: "
        f"max|d| = {err:g} (bit-exact: {exact})")
    if not err <= 1e-4:
        raise AssertionError(f"K1 differs from its plain version by {err}")
    rows["level_preprocess"] = err

    got = level.combine_nms(x["hi"], x["lo"], x["bounds"])
    want = level.combine_nms_plain(x["hi"], x["lo"], x["bounds"])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K2 differs: max|d| = {max_abs(got, want)}")
    log(f"K2 combine_nms {tuple(x['hi'].shape)}: exact "
        f"({int((got > 0).sum())} maxima)")
    rows["combine_nms"] = 0.0

    gv, ga = select.cell_topk(x["cells"], x["k"])
    wv, wa = select.cell_topk_plain(x["cells"], x["k"])
    torch.cuda.synchronize()
    if not (torch.equal(gv, wv) and torch.equal(ga, wa)):
        raise AssertionError(
            f"K3 differs: vals {max_abs(gv, wv)}, args {max_abs(ga, wa)}")
    log(f"K3 cell_topk {tuple(x['cells'].shape)} k={x['k']}: exact")
    rows["cell_topk"] = 0.0

    err = 0.0
    for img, p in ((canvas, 31), (x["blur"], 39)):
        got = patches.extract_patches(img, x["yx"], p)
        want = patches.extract_patches_plain(img, x["yx"], p)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 P={p} differs: {max_abs(got, want)}")
        log(f"K4 extract_patches K={x['yx'].shape[0]} P={p}: exact")
    rows["extract_patches"] = err
    return rows


def phase_main_path(config, args):
    """One tracking step on the card through the entry points, the launch
    counts read around it, and the same step on the CPU."""
    _build.reset_launches()
    res = tracking_forward_step(*args, config)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"main path launches: {counts}")
    want = {"level_preprocess": 1, "combine_nms": 1, "cell_topk": 1,
            "extract_patches": 2}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")

    R, t, xy = res.R.cpu().numpy(), res.t.cpu().numpy(), res.feat_xy.cpu()
    n_m, n_i = int(res.n_matches), int(res.n_inliers)
    if not (np.isfinite(R).all() and np.isfinite(t).all()
            and res.feat_xy.shape == (N_FEATURES, 2)):
        raise AssertionError("non-finite pose or wrong feature shape")
    R_gt, t_gt = args[6].cpu().numpy(), args[7].cpu().numpy()
    log(f"card: n_matches={n_m} n_inliers={n_i}; vs ground truth of frame 1: "
        f"rot {rot_angle_deg(R, R_gt):.4f} deg, |dt| {np.linalg.norm(t - t_gt):.5f}")

    cpu = tracking_forward_step(*(a.cpu() for a in args), config)
    c_m, c_i = int(cpu.n_matches), int(cpu.n_inliers)
    d_rot = rot_angle_deg(R, cpu.R.numpy())
    d_t = float(np.linalg.norm(t - cpu.t.numpy()))
    xy_differ = int((xy != cpu.feat_xy).any(dim=1).sum())
    log(f"cpu:  n_matches={c_m} n_inliers={c_i}; card vs cpu: rot {d_rot:.5f} "
        f"deg, |dt| {d_t:.6f}, keypoints that differ {xy_differ}")
    # K1-K4 are exact and every product runs in full float32, so the
    # keypoints must agree bit for bit.
    if xy_differ:
        raise AssertionError(f"{xy_differ} keypoints differ between card and CPU")
    if abs(n_m - c_m) > 0.01 * c_m or abs(n_i - c_i) > 0.01 * c_i:
        raise AssertionError("card and CPU counts differ by more than 1%")
    if not (d_rot < ROT_DEG_TOL and d_t < T_TOL):
        raise AssertionError("card and CPU poses differ beyond the bounds")
    if n_m < 100 or n_i < 0.8 * n_m:
        raise AssertionError("too few matches or inliers on the card")
    return counts


def phase_fps(config, args, power):
    """Frames/s by bench.py's recipe: 8 distinct noisy frames, frame i fed
    frame i-2's inlier count, a value fetch ending each block of 64, best
    of 5 blocks."""
    image, rest = args[0], args[1:]
    gen = torch.Generator(device=image.device).manual_seed(0)
    images = [image + 0.5 * torch.randn(image.shape, generator=gen,
                                        device=image.device)
              for _ in range(8)]
    pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t = rest

    def step(im, fb):
        return tracking_forward_step(im, pt_pos, pt_desc, pt_octave, pt_angle,
                                     pt_valid, R, t + 0.0 * fb, config)

    fb1 = fb2 = torch.zeros((), device=image.device)
    for i in range(16):
        out = step(images[i % 8], fb2)
        fb2, fb1 = fb1, out.n_inliers.to(torch.float32)
    _ = float(fb1) + float(fb2)
    fps_blocks = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(64):
            out = step(images[i % 8], fb2)
            fb2, fb1 = fb1, out.n_inliers.to(torch.float32)
        final = float(fb1) + float(fb2)
        fps_blocks.append(64 / (time.perf_counter() - t0))
        if not final >= 0:
            raise AssertionError("bad inlier chain")
    log(f"tracking step {WIDTH}x{HEIGHT}/{N_FEATURES} feat/{N_POINTS} pts: "
        f"{max(fps_blocks):.2f} frames/s best of 5x64 "
        f"(blocks {[round(f, 2) for f in fps_blocks]}) on {power}")


def phase_stages(config, args, power):
    """Where the step's time goes. Per stage: host wall time per call with
    a synchronise after each call, and device time per call by CUDA events
    over calls in a row. Then, under torch.profiler over PROFILE_STEPS
    steps: the device's busy time per step, its idle share of the wall
    time, and the device operations per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t = args
    cam, orb = config.camera, config.orb

    def extract():
        return extractor.extract_features(image, orb, cam.height, cam.width)

    feats = extract()

    def match():
        return matchers.match_projection_last_frame(
            pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t,
            feats.xy, feats.desc, feats.angle, feats.octave, feats.valid,
            cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width),
            float(cam.height), th=15.0, n_levels=orb.n_levels,
            scale=orb.scale_factor)

    pts, obs, _ = pose_inputs(feats, match().idx, pt_pos, config)

    def pose():
        return pose_opt.pose_optimization(
            R, t, pts, obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    def step():
        return tracking_forward_step(*args, config)

    reps = 10
    for name, fn in (("extraction", extract), ("matching", match),
                     ("pose_lm", pose), ("step", step)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
        log(f"stage {name}: {wall:.3f} ms synced wall, "
            f"{gpu_time_ms(fn, reps):.3f} ms device events, per call, on {power}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / PROFILE_STEPS
    if not ops:
        raise AssertionError("the profiler saw no device operation")
    log(f"profiled step ({PROFILE_STEPS} steps): {wall:.3f} ms wall, {busy:.3f} ms "
        f"device busy, idle share {1.0 - busy / wall:.4f}, "
        f"{len(ops) / PROFILE_STEPS:.0f} device operations per step, on {power}")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))


def phase_timing(x, errs, counts, power):

    th_hi, th_lo = x["ths"]
    canvas, blur = x["canvas"], x["blur"]
    padded, hp, wp = level.pad_level(canvas)
    yx = x["yx"]
    kernels = []

    def row(name, src, replaces, fn, plain, library, n_bytes, n_ops, iters=100):
        ms = gpu_time_ms(fn, iters)
        plain_ms = gpu_time_ms(plain, max(iters // 10, 5))
        lib_ms = gpu_time_ms(library, iters) if library is not None else None
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
        })
        log(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {b_by}; {n_bytes / 1e6:.2f} MB) on {power}")

    # K1 (the function the main path calls) reads the canvas once and
    # writes three maps; ~300 float operations per pixel (26 for the blur,
    # 17 per circle bit x 16).
    n_px = hp * wp
    row("level_preprocess", "orb_slam2_commit_tpu_torch/csrc/level.cu",
        "orb_slam2_commit_tpu/ops/pallas_level.py:143",
        lambda: level.level_preprocess(canvas, th_hi, th_lo),
        lambda: level.level_preprocess_plain(padded, hp, wp, th_hi, th_lo),
        None, canvas.numel() * 4 + 3 * n_px * 4, 300 * n_px)
    # K2 reads two maps and the two bound columns it uses, writes one map.
    hi, lo, bounds = x["hi"], x["lo"], x["bounds"]
    row("combine_nms", "orb_slam2_commit_tpu_torch/csrc/level.cu",
        "orb_slam2_commit_tpu/ops/pallas_level.py:327",
        lambda: level.combine_nms(hi, lo, bounds),
        lambda: level.combine_nms_plain(hi, lo, bounds),
        None, 3 * hi.numel() * 4 + bounds.shape[0] * 2 * 4, 20 * hi.numel())
    # K3 reads the cell matrix once, writes k values and indices per row;
    # k rounds of one compare per entry.
    cells, k = x["cells"], x["k"]
    row("cell_topk", "orb_slam2_commit_tpu_torch/csrc/select.cu",
        "orb_slam2_commit_tpu/ops/pallas_select.py:64",
        lambda: select.cell_topk(cells, k),
        lambda: select.cell_topk_plain(cells, k),
        lambda: torch.topk(cells, k, dim=1),
        cells.numel() * 4 + 2 * cells.shape[0] * k * 4, k * cells.numel())

    # K4 (both launches of a frame): the distinct image pixels the windows
    # cover, the centres, and the windows written.
    def covered(img, p):
        h, w = img.shape
        half = p // 2
        d = torch.arange(-half, half + 1, device=img.device)
        ys = (yx[:, 0:1].long() + d).clamp(0, h - 1)
        xs = (yx[:, 1:2].long() + d).clamp(0, w - 1)
        mask = torch.zeros(h * w, dtype=torch.bool, device=img.device)
        mask[(ys[:, :, None] * w + xs[:, None, :]).reshape(-1)] = True
        return int(mask.sum())

    n_k = yx.shape[0]
    k4_bytes = sum(covered(img, p) * 4 + n_k * 8 + n_k * p * p * 4
                   for img, p in ((canvas, 31), (blur, 39)))

    def both(fn):
        return lambda: (fn(canvas, yx, 31), fn(blur, yx, 39))

    row("extract_patches", "orb_slam2_commit_tpu_torch/csrc/patches.cu",
        "orb_slam2_commit_tpu/ops/pallas_patches.py:81",
        both(patches.extract_patches), both(patches.extract_patches_plain),
        None, k4_bytes, 0)
    return kernels


def main() -> int:
    name, count, smi = phase_device()
    power = smi

    phase_build()

    t0 = time.perf_counter()
    config, args = interop.make_example(WIDTH, HEIGHT, N_FEATURES, N_POINTS, "cuda")
    torch.cuda.synchronize()
    log(f"make_example {WIDTH}x{HEIGHT}, {N_FEATURES} features, {N_POINTS} "
        f"points: {time.perf_counter() - t0:.1f} s, "
        f"{int(args[5].sum())} bound map points")

    x = main_path_inputs(args[0])
    errs = phase_kernels(x)
    counts = phase_main_path(config, args)
    phase_fps(config, args, power)
    phase_stages(config, args, power)
    kernels = phase_timing(x, errs, counts, power)

    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
