#!/usr/bin/env python3
"""Run chip_smoke.py's ring survey several times on one card and print the
numbers behind its loop gates: keyframes, the loop closed (keyframe pair,
frame), the scale-aligned ATE of the frames before the correction, before
and after it (the prefix gate), and the final ATE. With --exact, every call
of K7 under a candidate test is also held against its plain version.

The System on the card sums in no fixed order (index_add_), so the runs of
one tree differ; this counts how often each gate holds. Run from the root
of a checkout (its own chip_smoke.py and kernels are used):

    python3 scripts/loop_gate_runs.py 4
    python3 scripts/loop_gate_runs.py 2 --exact
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam2_commit_tpu_torch.kernels import matching as kmatching  # noqa: E402
from orb_slam2_commit_tpu_torch.utils import trajectory  # noqa: E402


def hold_forms_exact(stats):
    """Wrap each K7 form so that every call is also run through its plain
    version and counted in stats (calls, differ)."""
    for name in cs.K7_FORMS:
        fn = getattr(kmatching, name)

        def spy(*args, _fn=fn, _name=name):
            out = _fn(*args)
            want = kmatching.CANDIDATE_PLAINS[_name](*args)
            stats["calls"] += 1
            if not all(torch.equal(g, w) for g, w in zip(out, want)):
                stats["differ"] += 1
                print(f"{_name} differs from its plain version", flush=True)
            return out

        setattr(kmatching, name, spy)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("runs", type=int)
    parser.add_argument("--exact", action="store_true")
    args = parser.parse_args()
    _, _, power = cs.phase_device()
    cs.phase_build()
    stats = {"calls": 0, "differ": 0}
    if args.exact:
        hold_forms_exact(stats)
    seq = cs.loop_sequence()
    gt_c = cs.centres(seq[2])
    for r in range(args.runs):
        sys_, states, seconds, pre = cs.run_loop(seq)
        est = sys_.trajectory_positions()
        lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
        off, n = len(gt_c) - len(est), pre.get("n", 0)
        prefix = (trajectory.ate_rmse(est[:n][~lost[:n]], gt_c[off:off + n][~lost[:n]],
                                      align_scale=True) if n else float("nan"))
        loops = [(s["kf"], s["loop_kf"]) for s in sys_.loop_closer.correction_stats]
        print(f"run {r}: {seconds:.1f} s, state {states[-1]}, {sys_.map.next_kf} keyframes, "
              f"loops {loops} at frame {pre.get('frame')}, prefix ATE before "
              f"{pre.get('ate')} after {prefix} (gate holds: "
              f"{bool(prefix < pre.get('ate', float('nan')))}), final ATE "
              f"{cs.loop_ate(sys_, gt_c)}"
              + (f"; K7 calls held exact: {stats}" if args.exact else "")
              + f"; on {power}", flush=True)


if __name__ == "__main__":
    main()
