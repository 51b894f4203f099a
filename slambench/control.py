"""The readings the limits are set from, on the card, at the cell's own
size: for each seed, one short window of the cell, then the compared
numbers of the program (the lower readings) and of the control (the upper
readings: the reference's solve in bfloat16, the nearest precision below
the configuration's float32, in the program's place). All seeds run in one
process, one System after another. The benchmark's own runs do not run it.

  python3 slambench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

One JSON line a seed: {"seed", "program": {...}, "control": {...},
"frames", "failed"}.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from slambench import cell as cell_mod
    from slambench import registry

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    cfg = registry.config(bench, wl["config"])
    traffic = registry.traffic(wl["traffic"])
    share = float(traffic["check"]["frame_share"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = cell_mod.Cell(cfg, traffic, seed)
        c.set_up()
        w = c.window(args.seconds, share)
        c.close()
        torch.cuda.empty_cache()
        line = {"seed": seed, "program": c.numbers(),
                "control": c.numbers(dtype=torch.bfloat16),
                "frames": len(w.latencies), "failed": w.failed,
                "checked": [len(c.frame_answers), len(c.kf_answers)],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del c
    return 0


if __name__ == "__main__":
    sys.exit(main())
