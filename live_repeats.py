"""Repeat chip_smoke.py's live RGB-D runs at 30 frames/s after its earlier
phases, in one process, and count the runs that miss its ATE gate.

    python3 live_repeats.py [TREE] [REPEATS]

TREE is a checkout of the repo (default: this file's directory); its own
chip_smoke.py and port are imported. The script runs that chip_smoke's
phases in their order, through its online phase (whose live runs count
too), then calls the online phase's live runs REPEATS more times (default
8) at 30 frames/s only, each call its four turns (viewer off, on, on, off).
A run that misses a gate of check_live_run is recorded, not raised: its
message, the frames the drop policy fed, the states, the keyframes' frames,
each tracked centre's error and the System resets it made. The phases
after the online one are not run. The last line is one JSON object: the
tree, the runs, the failures. Needs one CUDA card.
"""

import json
import os
import sys
import tempfile

import numpy as np

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
REPEATS = int(sys.argv[2]) if len(sys.argv) > 2 else 8
RATE = 30.0

sys.path[:] = [TREE] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]
import chip_smoke as cs  # noqa: E402

if not os.path.abspath(cs.__file__).startswith(TREE):
    raise SystemExit(f"chip_smoke imported from {cs.__file__}, not from {TREE}")
System = sys.modules["orb_slam2_commit_tpu_torch.slam.system"].System


class Stop(Exception):
    """Raised after the online phase: the later phases are not run."""


runs = []
phase = ["smoke"]
resets = [0]
check_live_run, phase_online, reset = cs.check_live_run, cs.phase_online, System.reset


def counted_reset(self):
    resets[0] += 1
    return reset(self)


def recorded_check(what, run, gt, rate, stream_dir):
    """check_live_run with a miss recorded (and NaNs returned) in place of
    the raise."""
    m = run.system.map
    fed = [int(round(ts * rate)) for ts in run.fed_ts]
    rec = dict(phase=phase[0], what=what, rate=rate, fed=fed, states=list(run.states),
               keyframes=m.kf_frame_id[:m.next_kf].tolist(), resets=resets[0],
               track_ms=[round(s * 1e3, 1) for s in run.track_s])
    resets[0] = 0
    try:
        out = check_live_run(what, run, gt, rate, stream_dir)
        rec.update(ok=True, ate=out[0], span=out[1])
    except AssertionError as e:
        tracked = [(i, p) for i, p in zip(fed, run.poses) if p is not None]
        est = cs.centres([p for _, p in tracked])
        err = np.linalg.norm(est - cs.centres(gt)[[i for i, _ in tracked]], axis=1)
        rec.update(ok=False, msg=str(e)[:400], centre_errors=np.round(err, 4).tolist())
        out = (float("nan"),) * 4
    runs.append(rec)
    cs.log(f"live_repeats {rec['phase']}: {what} {'ok' if rec['ok'] else 'MISSED'}; fed "
           f"{fed}, states {sorted(set(run.states))}, keyframes' frames {rec['keyframes']}, "
           f"resets {rec['resets']}" + ("" if rec["ok"] else f"; {rec['msg']}; centre errors "
                                        f"{rec['centre_errors']}"))
    return out


def online_then_repeats(seqs, power, device="cuda"):
    phase_online(seqs, power, device)
    phase[0] = "repeat"
    cs.LIVE_RATES = (RATE,)
    for _ in range(REPEATS):
        with tempfile.TemporaryDirectory(prefix="live_repeats_") as root:
            cs.phase_online_live(seqs["rgbd"], power, root, device)
    raise Stop


def main():
    name, count, power = cs.phase_device()
    cs.phase_build()
    cs.check_live_run, cs.phase_online, System.reset = (recorded_check, online_then_repeats,
                                                         counted_reset)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_datasets_") as data_root:
            cs.run_phases(power, data_root)
    except Stop:
        pass
    at30 = [r for r in runs if r["rate"] == RATE]
    missed = [r for r in runs if not r["ok"]]
    cs.log(f"live_repeats on {TREE}: {len(at30)} live RGB-D runs at {RATE:g} frames/s "
           f"({sum(r['phase'] == 'smoke' for r in at30)} of them the online phase's), "
           f"{sum(not r['ok'] for r in at30)} missed a gate; {len(runs)} live runs in all, "
           f"{len(missed)} missed; on {power}")
    print(json.dumps({"tree": TREE, "device": name, "power": power, "runs": len(runs),
                      "runs_at_30": len(at30), "missed": missed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
