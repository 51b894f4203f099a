"""Figure-eight multi-loop drive: the whole System over a two-lobe street
circuit that returns to its crossing after every lobe, so one run closes
two or more loops, the second on a map already corrected; the port's
counterpart of scripts/multiloop_drive.py.

The reference keeps a set of loop edges per keyframe
(src/KeyFrame.cc:532-543) and every later essential graph takes all of
them (src/Optimizer.cc:966-987). The drive records each closure (frame,
keyframes, the loop edges so far, the scale-aligned ATE after it), then
relocalizes a kidnapped tracker against the final map.

Usage:
  python -m orb_slam2_commit_tpu_torch.examples.multiloop_drive \\
      [--frames=1400] [--points=60000] [--features=1500] [--r=25] \\
      [--laps=2.15] [--max-depth=12] [--stereo] [--noise] \\
      [--ckpt-every=200] [--resume] [--device=cpu] [--out=multiloop_drive.json]

On the CUDA card unless --device=cpu. The summary JSON (OUT) has
scripts/multiloop_drive.py's keys, plus the device and the kernels'
launch counts over the run; the loop events and a line every 100 frames
go to OUT.log.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys
import time

import numpy as np

from orb_slam2_commit_tpu_torch.examples.scale_drive import parse_flags, synced


def ate_so_far(sys_, poses_gt):
    """The scale-aligned ATE over the frames tracked so far, resolved
    against the live map (a closure corrects the segments before it)."""
    from orb_slam2_commit_tpu_torch.utils import trajectory as traj

    est = np.atleast_2d(sys_.trajectory_positions())
    if est.shape[0] < 10 or est.shape[-1] != 3:
        return float("nan")
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    # The common prefix: the kidnap probe adds an entry past the sequence.
    n = min(est.shape[0], len(poses_gt), lost.shape[0])
    est, lost = est[:n], lost[:n]
    gt = np.asarray([-R.T @ t for R, t in poses_gt[:n]])
    ok = ~lost
    return float(traj.ate_rmse(est[ok], gt[ok], align_scale=True))


def kidnap_probe(sys_, scene, cfg, n_frames, r, laps, max_depth, stereo, photo):
    """A view from deep inside lobe A (mapped on the first lap, far from
    the end), tracked in localization mode from LOST with no last frame
    (Tracking::Relocalization, src/Tracking.cc:1653-1884)."""
    from orb_slam2_commit_tpu_torch.slam.tracking import TrackingState
    from orb_slam2_commit_tpu_torch.utils import synthetic

    kidnap = {"attempted": False, "relocalized": False}
    try:
        sys_.activate_localization_mode()
        sys_.tracker.state = TrackingState.LOST
        sys_.tracker.last_frame = None
        sys_.tracker.velocity = None
        poses = synthetic.figure8_trajectory(n_frames, r=r, laps=laps)
        # 55% around lobe A; a run shorter than that probes the view of its
        # middle frame (mapped early, far from the end) instead of indexing
        # past its poses.
        Rp, tp = poses[int(min(0.55 / laps, 0.5) * (n_frames - 1))]
        img = synthetic.render(scene, Rp, tp, cfg.camera, max_depth=max_depth)
        if photo is not None:
            img = synthetic.apply_photometry(img, photo, 13, 0)
        kidnap["attempted"] = True
        if stereo:
            img_r = synthetic.render(scene, Rp, tp - np.array([cfg.camera.baseline, 0.0, 0.0]),
                                     cfg.camera, max_depth=max_depth)
            sys_.track_stereo(img, img_r, 9999.0)
        else:
            sys_.track_monocular(img, 9999.0)
        if sys_.tracking_state() == TrackingState.OK:
            f = sys_.tracker.last_frame
            kidnap["relocalized"] = True
            kidnap["position_error_m"] = float(np.linalg.norm(-f.R.T @ f.t - (-Rp.T @ tp)))
    except Exception as e:  # noqa: BLE001 — record, do not lose the run
        kidnap["error"] = repr(e)
    return kidnap


def gates(summary):
    """tests/test_multiloop.py::TestFullFigure8's gates on a summary ->
    [(name, value, limit, ok)]."""
    last_edges = len(summary["loop_events"][-1]["loop_edges"]) if summary["loop_events"] else 0
    return [("final state OK", summary["final_state"], "OK", summary["final_state"] == "OK"),
            ("loops closed", summary["n_loops_closed"], 2, summary["n_loops_closed"] >= 2),
            ("loop edges", len(summary["loop_edges_final"]), 2,
             len(summary["loop_edges_final"]) >= 2),
            ("loop edges seen by the last closure", last_edges, 2, last_edges >= 2),
            ("ATE % of path", summary["ate_pct_of_path"], 1.5,
             summary["ate_pct_of_path"] < 1.5),
            ("kidnap relocalized", summary["kidnap_reloc"]["relocalized"], True,
             bool(summary["kidnap_reloc"]["relocalized"]))]


def main(argv) -> int:
    flags = parse_flags(argv)
    n_frames = int(flags.get("--frames", 1400))
    n_points = int(flags.get("--points", 60000))
    n_features = int(flags.get("--features", 1500))
    width = int(flags.get("--width", 640))
    height = int(flags.get("--height", 480))
    stereo = "--stereo" in flags
    noise = "--noise" in flags
    r = float(flags.get("--r", 25.0))
    laps = float(flags.get("--laps", 2.15))
    max_depth = float(flags.get("--max-depth", 12.0))
    out_path = flags.get("--out", "multiloop_drive.json")
    ckpt_every = int(flags.get("--ckpt-every", 200))
    resume = "--resume" in flags
    device = flags.get("--device", "cuda")

    from orb_slam2_commit_tpu_torch.kernels import _build
    from orb_slam2_commit_tpu_torch.slam.system import System
    from orb_slam2_commit_tpu_torch.utils import synthetic
    from orb_slam2_commit_tpu_torch.utils.config import synthetic_config

    cfg = synthetic_config(width=width, height=height, n_features=n_features,
                           sensor="stereo" if stereo else "monocular")
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, kf_baseline_depth_ratio=0.08, kf_view_angle_deg=8.0))
    photo = synthetic.CAMERA_PHOTO if noise else None
    frames, poses_gt, scene = synthetic.figure8_frames(
        cfg.camera, n_frames=n_frames, n_points=n_points, seed=13, r=r, laps=laps,
        max_depth=max_depth, stereo=stereo, photo=photo)

    ckpt_map = out_path + ".ckpt.npz"
    ckpt_aux = out_path + ".ckpt.pkl"
    sys_ = System(cfg, device=device)
    frame_dt = np.zeros(n_frames)
    loop_events = []
    start_frame = 0
    prev_wall = 0.0
    _build.reset_launches()
    if resume and os.path.exists(ckpt_map) and os.path.exists(ckpt_aux):
        with open(ckpt_aux, "rb") as f:
            aux = pickle.load(f)
        start_frame = aux["frame"] + 1
        sys_.load_map(ckpt_map)
        sys_.tracker.trajectory = aux["trajectory"]
        if sys_.loop_closer is not None:
            sys_.loop_closer.n_loops_closed = aux["n_loops_closed"]
        loop_events = aux["loop_events"]
        n_prev = min(start_frame, n_frames)
        frame_dt[:n_prev] = aux["frame_dt"][:n_prev]
        prev_wall = aux["track_wall_s"]
        print(f"[resume] frame {start_frame}, {sys_.map.n_keyframes()} KFs", flush=True)

    def n_loops_closed():
        return sys_.loop_closer.n_loops_closed if sys_.loop_closer else 0

    log = open(out_path + ".log", "a" if start_frame else "w")
    t_start = time.perf_counter()
    n_loops_prev = n_loops_closed()
    for item in frames(start=start_frame):
        if stereo:
            k, left, right = item
        else:
            k, left = item
        t0 = time.perf_counter()
        if stereo:
            sys_.track_stereo(left, right, k / 30.0)
        else:
            sys_.track_monocular(left, k / 30.0)
        frame_dt[k] = synced(sys_.device) - t0

        n_loops = n_loops_closed()
        if n_loops > n_loops_prev:
            ev = {"closure": n_loops, "frame": k, "n_keyframes": int(sys_.map.n_keyframes()),
                  "n_points": int(sys_.map.pt_valid.sum()),
                  "loop_edges": list(map(list, sys_.map.loop_edges or [])),
                  "ate_after": ate_so_far(sys_, poses_gt)}
            loop_events.append(ev)
            log.write(json.dumps({"loop_event": ev}) + "\n")
            log.flush()
            print(f"[loop {n_loops}] frame {k} kfs={ev['n_keyframes']} "
                  f"edges={len(ev['loop_edges'])} ate={ev['ate_after']:.3f}", flush=True)
            n_loops_prev = n_loops

        if (k + 1) % 100 == 0:
            rec = {"frame": k + 1, "state": sys_.tracking_state().name,
                   "kfs": int(sys_.map.n_keyframes()), "pts": int(sys_.map.pt_valid.sum()),
                   "loops": n_loops,
                   "dt_med_last100": float(np.median(frame_dt[max(k - 99, 0):k + 1])),
                   "elapsed_s": prev_wall + time.perf_counter() - t_start}
            log.write(json.dumps(rec) + "\n")
            log.flush()
            print(f"[{k + 1:5d}] {rec['state']:5s} kfs={rec['kfs']:4d} pts={rec['pts']:6d} "
                  f"loops={rec['loops']} dt_med={rec['dt_med_last100'] * 1e3:7.1f}ms",
                  flush=True)
        if ckpt_every > 0 and (k + 1) % ckpt_every == 0:
            sys_.save_map(ckpt_map + ".tmp.npz")
            os.replace(ckpt_map + ".tmp.npz", ckpt_map)
            aux = {"frame": k, "trajectory": sys_.tracker.trajectory,
                   "n_loops_closed": n_loops, "loop_events": loop_events,
                   "frame_dt": frame_dt[:k + 1],
                   "track_wall_s": prev_wall + time.perf_counter() - t_start}
            with open(ckpt_aux + ".tmp", "wb") as f:
                pickle.dump(aux, f)
            os.replace(ckpt_aux + ".tmp", ckpt_aux)

    track_wall = prev_wall + time.perf_counter() - t_start
    sys_.shutdown()
    launches = dict(_build.launches)

    kidnap = kidnap_probe(sys_, scene, cfg, n_frames, r, laps, max_depth, stereo, photo)
    final_ate = ate_so_far(sys_, poses_gt)
    gt = np.asarray([-R.T @ t for R, t in poses_gt])
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory[:n_frames]], bool)
    summary = {
        "n_frames": n_frames,
        "image": [width, height],
        "n_features": n_features,
        "stereo": stereo,
        "noise": noise,
        "final_state": sys_.tracking_state().name,
        "n_keyframes": int(sys_.map.n_keyframes()),
        "n_points": int(sys_.map.pt_valid.sum()),
        "n_loops_closed": n_loops_closed(),
        "loop_events": loop_events,
        "corrections": list(sys_.loop_closer.correction_stats if sys_.loop_closer else []),
        "loop_edges_final": list(map(list, sys_.map.loop_edges or [])),
        "lost_frames": int(lost.sum()),
        "ate_rmse": final_ate,
        "path_len": path_len,
        "ate_pct_of_path": float(100.0 * final_ate / path_len),
        "track_wall_s": track_wall,
        "frame_dt_med_ms": float(np.median(frame_dt) * 1e3),
        "kidnap_reloc": kidnap,
        "stages": sys_.timings(),
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
