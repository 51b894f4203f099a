"""KITTI-class scale drive: the whole System over a 1000+-frame synthetic
city-block circuit (300+ keyframes, 10^4-10^5 map points, the loop closed
at the end of the lap), the port's counterpart of scripts/scale_drive.py.

The reference's operating envelope is this regime
(Examples/Stereo/stereo_kitti.cc:29-166: thousands of frames, hundreds of
keyframes, 10^5 points). The drive prints and writes per-frame wall times,
the stage times as the map grows, the final ATE after loop closure, and a
global BA on the real final map by both routes (sharded over the process
group, ORB_DISTRIBUTED_GBA=1, and plain).

Usage:
  python -m orb_slam2_commit_tpu_torch.examples.scale_drive \\
      [--frames=1600] [--points=40000] [--features=1500] [--width=640] \\
      [--height=480] [--stereo] [--async] [--r0=40] [--frac=1.18] \\
      [--max-depth=16] [--ckpt-every=200] [--resume] [--device=cpu] \\
      [--out=scale_drive.json]

On the CUDA card unless --device=cpu. Progress goes to OUT.log (a JSON line
every 100 frames) and OUT.partial; every --ckpt-every frames the map
(models/serialization) and the drive's state go to OUT.ckpt.npz / .pkl, and
--resume continues from them (the tracker relocalizes into the loaded map).
The summary JSON (OUT) has scripts/scale_drive.py's keys, plus the device
and the kernels' launch counts over the run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys
import time

import numpy as np


def parse_flags(argv):
    flags = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            flags[k] = v
        else:
            flags[a] = True
    return flags


def synced(device):
    """A wall clock read after the device's queued work (the card's
    stream), so a frame's time includes it."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def global_ba_routes(sys_, log):
    """Global BA on the real final map, sharded (ORB_DISTRIBUTED_GBA=1)
    then plain (=0), 5 iterations each -> (sharded s, plain s); -1.0 for a
    route that raised (logged)."""
    walls = {"1": -1.0, "0": -1.0}
    before = os.environ.get("ORB_DISTRIBUTED_GBA")
    try:
        for route in ("1", "0"):
            os.environ["ORB_DISTRIBUTED_GBA"] = route
            t0 = synced(sys_.device)
            sys_.loop_closer.run_global_ba(anchor_kf=0, n_iters=5)
            walls[route] = synced(sys_.device) - t0
    except Exception as e:  # noqa: BLE001 — record, do not lose the run
        log.write(json.dumps({"gba_error": repr(e)}) + "\n")
    finally:
        if before is None:
            os.environ.pop("ORB_DISTRIBUTED_GBA", None)
        else:
            os.environ["ORB_DISTRIBUTED_GBA"] = before
    return walls["1"], walls["0"]


def gates(summary, min_keyframes=300, min_points=15000):
    """tests/test_scale.py::TestFullDrive's gates on a summary (the 330 m
    stereo circuit's counts by default) -> [(name, value, limit, ok)]."""
    q = summary["dt_med_by_quarter_ms"]
    return [("final state OK", summary["final_state"], "OK", summary["final_state"] == "OK"),
            ("keyframes", summary["n_keyframes"], min_keyframes,
             summary["n_keyframes"] >= min_keyframes),
            ("points", summary["n_points"], min_points, summary["n_points"] >= min_points),
            ("loops closed", summary["n_loops_closed"], 1, summary["n_loops_closed"] >= 1),
            ("ATE % of path", summary["ate_pct_of_path"], 1.5,
             summary["ate_pct_of_path"] < 1.5),
            ("last quarter's median frame / first's", q[3] / q[0], 3.0, q[3] < 3.0 * q[0])]


def main(argv) -> int:
    flags = parse_flags(argv)
    n_frames = int(flags.get("--frames", 1600))
    n_points = int(flags.get("--points", 40000))
    n_features = int(flags.get("--features", 1500))
    width = int(flags.get("--width", 640))
    height = int(flags.get("--height", 480))
    use_async = "--async" in flags
    stereo = "--stereo" in flags
    r0 = float(flags.get("--r0", 40.0))
    frac = float(flags.get("--frac", 1.18))
    max_depth = float(flags.get("--max-depth", 16.0))
    out_path = flags.get("--out", "scale_drive.json")
    ckpt_every = int(flags.get("--ckpt-every", 200))
    resume = "--resume" in flags
    device = flags.get("--device", "cuda")

    from orb_slam2_commit_tpu_torch.kernels import _build
    from orb_slam2_commit_tpu_torch.slam.system import System
    from orb_slam2_commit_tpu_torch.utils import synthetic
    from orb_slam2_commit_tpu_torch.utils import trajectory as traj
    from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

    cfg = synthetic_config(width=width, height=height, n_features=n_features,
                           sensor="stereo" if stereo else "monocular")
    # The drive's keyframe policy: ~0.7 m apart at ~9 m median depth, the
    # corners' rotations caught by the view angle.
    cfg = dataclasses.replace(
        cfg,
        tracker=dataclasses.replace(cfg.tracker, kf_baseline_depth_ratio=0.08,
                                    kf_view_angle_deg=8.0),
        system=dataclasses.replace(cfg.system, async_mapping=use_async))
    frames, poses_gt, _ = synthetic.drive_frames(
        cfg.camera, n_frames=n_frames, n_points=n_points, seed=7, r0=r0, frac=frac,
        max_depth=max_depth, stereo=stereo)

    # Checkpoints: the map through models/serialization (keyframes, points,
    # covisibility, loop edges), the trajectory entries verbatim (they
    # resolve against the live map, so later loop corrections still apply
    # to them); after --resume the tracker relocalizes into the loaded map.
    ckpt_map = out_path + ".ckpt.npz"
    ckpt_aux = out_path + ".ckpt.pkl"
    sys_ = System(cfg, async_mapping=use_async, device=device)
    frame_dt = np.zeros(n_frames)
    kf_count = np.zeros(n_frames, np.int32)
    pt_count = np.zeros(n_frames, np.int32)
    start_frame = 0
    prev_wall = 0.0
    render_s = 0.0
    _build.reset_launches()
    if resume and os.path.exists(ckpt_map) and os.path.exists(ckpt_aux):
        with open(ckpt_aux, "rb") as f:
            aux = pickle.load(f)
        start_frame = aux["frame"] + 1
        sys_.load_map(ckpt_map)
        sys_.tracker.trajectory = aux["trajectory"]
        if sys_.loop_closer is not None:
            sys_.loop_closer.n_loops_closed = aux["n_loops_closed"]
        n_prev = min(start_frame, n_frames)
        frame_dt[:n_prev] = aux["frame_dt"][:n_prev]
        kf_count[:n_prev] = aux["kf_count"][:n_prev]
        pt_count[:n_prev] = aux["pt_count"][:n_prev]
        prev_wall = aux["track_wall_s"]
        render_s = aux["render_wall_s"]
        print(f"[resume] frame {start_frame}, {sys_.map.n_keyframes()} KFs, "
              f"{int(sys_.map.pt_valid.sum())} points", flush=True)

    def n_loops():
        return sys_.loop_closer.n_loops_closed if sys_.loop_closer else 0

    def write_ckpt(k):
        sys_.save_map(ckpt_map + ".tmp.npz")
        os.replace(ckpt_map + ".tmp.npz", ckpt_map)
        aux = {"frame": k, "trajectory": sys_.tracker.trajectory, "n_loops_closed": n_loops(),
               "frame_dt": frame_dt[:k + 1], "kf_count": kf_count[:k + 1],
               "pt_count": pt_count[:k + 1],
               "track_wall_s": prev_wall + time.perf_counter() - t_start,
               "render_wall_s": render_s}
        with open(ckpt_aux + ".tmp", "wb") as f:
            pickle.dump(aux, f)
        os.replace(ckpt_aux + ".tmp", ckpt_aux)

    log = open(out_path + ".log", "a" if start_frame else "w")
    t_start = time.perf_counter()
    t_r0 = time.perf_counter()
    for item in frames(start=start_frame):
        t0 = time.perf_counter()
        render_s += t0 - t_r0
        if stereo:
            k, left, right = item
            sys_.track_stereo(left, right, k / 30.0)
        else:
            k, img = item
            sys_.track_monocular(img, k / 30.0)
        frame_dt[k] = synced(sys_.device) - t0
        kf_count[k] = sys_.map.n_keyframes()
        pt_count[k] = int(sys_.map.pt_valid.sum())
        if (k + 1) % 100 == 0:
            partial = {"partial_at_frame": k + 1, "n_keyframes": int(kf_count[k]),
                       "n_points": int(pt_count[k]), "n_loops_closed": n_loops(),
                       "state": sys_.tracking_state().name, "stages": sys_.timings()}
            with open(out_path + ".partial", "w") as f:
                json.dump(partial, f, indent=1)
            window = frame_dt[max(k - 99, 0):k + 1]
            rec = {"frame": k + 1, "state": sys_.tracking_state().name,
                   "kfs": int(kf_count[k]), "pts": int(pt_count[k]), "loops": n_loops(),
                   "dt_med_last100": float(np.median(window)),
                   "dt_p95_last100": float(np.percentile(window, 95)),
                   "elapsed_s": prev_wall + time.perf_counter() - t_start,
                   "stages": {n: {"count": v["count"], "mean_ms": v["mean_ms"],
                                  "ema_ms": v["ema_ms"]}
                              for n, v in sys_.timings().items()}}
            log.write(json.dumps(rec) + "\n")
            log.flush()
            print(f"[{k + 1:5d}] {rec['state']:5s} kfs={rec['kfs']:4d} pts={rec['pts']:6d} "
                  f"loops={rec['loops']} dt_med={rec['dt_med_last100'] * 1e3:7.1f}ms "
                  f"p95={rec['dt_p95_last100'] * 1e3:7.1f}ms", flush=True)
        if ckpt_every > 0 and (k + 1) % ckpt_every == 0:
            write_ckpt(k)
        t_r0 = time.perf_counter()

    track_wall = prev_wall + time.perf_counter() - t_start
    sys_.shutdown()
    launches = dict(_build.launches)

    # Accuracy: the scale-aligned ATE over the tracked frames; the span is
    # the path length (KITTI's convention: the circuit closes).
    est = np.atleast_2d(sys_.trajectory_positions())
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    if est.shape[0] >= 10 and est.shape[-1] == 3:
        offset = len(poses_gt) - len(est)
        ok = ~lost
        rmse = traj.ate_rmse(est[ok], gt[offset:][ok], align_scale=True)
    else:
        rmse = float("nan")
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())

    n_kf_final = sys_.map.n_keyframes()
    n_pt_final = int(sys_.map.pt_valid.sum())
    dist_gba_wall, gba_wall = global_ba_routes(sys_, log)

    summary = {
        "n_frames": n_frames,
        "image": [width, height],
        "n_features": n_features,
        "async": use_async,
        "final_state": sys_.tracking_state().name,
        "n_keyframes": n_kf_final,
        "n_points": n_pt_final,
        "n_loops_closed": n_loops(),
        "corrections": list(sys_.loop_closer.correction_stats if sys_.loop_closer else []),
        "lost_frames": int(lost.sum()),
        "ate_rmse": float(rmse),
        "path_len": path_len,
        "ate_pct_of_path": float(100.0 * rmse / path_len),
        "track_wall_s": track_wall,
        "render_wall_s": render_s,
        "frame_dt_med_ms": float(np.median(frame_dt) * 1e3),
        "frame_dt_p95_ms": float(np.percentile(frame_dt, 95) * 1e3),
        # Growth: the median frame time of each quarter of the run.
        "dt_med_by_quarter_ms": [
            float(np.median(frame_dt[i * n_frames // 4:(i + 1) * n_frames // 4]) * 1e3)
            for i in range(4)],
        "gba_wall_s": gba_wall,
        "dist_gba_wall_s": dist_gba_wall,
        "stages": sys_.timings(),
        "worker_dropped": sys_.mapping_worker.dropped if sys_.mapping_worker else 0,
        "device": str(sys_.device),
        "launches": launches,
    }
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "stages"}, indent=1))
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
