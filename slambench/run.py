"""Run one cell of BENCHMARK.json once on the card and print its result.

  python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (process start to the first timed
frame) builds the program's kernels where they are not built yet (in the
checkout's orb_slam2_commit_tpu_torch/_build/), renders the cell's frames
on the card, loads the vocabulary and runs the warm-up frames. The window
then feeds frames back to back for --seconds. With --trace 0 the result
carries the cell's end-to-end metrics; with --trace 1 the window's last
20 s run under the autograd profiler and the result carries the cell's
per-layer metrics, the traced seconds the device was busy and their
length, and a breakdown. After the window the
plain reference checks the window's answers (slambench/reference.py); each
number compared is printed beside its limit, last on standard error and
last in the result's line.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (breakdown), checks. A run without a CUDA card,
or with fewer cards than the cell asks for, exits with 2 and prints no
result; so does one that finds JAX or the JAX package loaded after the
window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Build and kernel caches at fixed paths inside the checkout, so that only
# a cell's first run there builds.
CACHE = os.path.join(ROOT, ".slambench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
# One process with one thread for its host math: the port's host work is
# small numpy and torch calls that threads do not speed up, and threads
# that wait on each other on a shared host make the timings unsteady.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_commit_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(bench, wl, cfg, traffic, limits, seed, seconds, traced, device="cuda",
             t_start=T_START, max_frames=None):
    """One run of the cell: set-up, the window, the check -> (the result's
    dict, the checks [(name, value, limit, ok)]). `device` is the card and
    the window is timed, except in the tests that drive a run on the CPU
    for `max_frames` frames."""
    import torch

    from slambench import cell as cell_mod
    from slambench import reference, registry, trace

    on_card = torch.device(device).type == "cuda"
    c = cell_mod.Cell(cfg, traffic, seed, device=device)
    c.set_up()
    setup_s = time.perf_counter() - t_start
    log(f"slambench: set-up {setup_s:.3f} s, {c.k} frames before the window; "
        + ", ".join(f"{k} {v:.3f}" for k, v in c.setup_parts.items()))
    if c.lap_stages:
        log("slambench: the mapping lap's stages (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in c.lap_stages.items()))

    share = float(traffic["check"]["frame_share"])
    tr = None
    if traced:
        # The trace covers the window's last TRACE_SECONDS; the Profiler's
        # stages and the counters cover all of it.
        spans = []
        tp = trace.Traced()

        def between(left):
            if tp.t_host0 is None and left <= trace.TRACE_SECONDS:
                tp.start()

        with trace.stage_spans(c.system.profiler, spans):
            w = c.window(seconds, share, max_frames, between)
        tp.stop()
        tr = tp.reduce(w.t_end, spans)
        log("slambench: trace " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                                             f"{k} {v}" for k, v in tp.cost_s.items()))
    else:
        w = c.window(seconds, share, max_frames)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    log("slambench: the window's stages (count, s): " + ", ".join(
        f"{k} {v['count']:.0f} {v['total_s']:.3f}" for k, v in
        sorted(w.stages.items(), key=lambda kv: -kv[1]["total_s"])[:10]))
    if w.exhausted:
        log(f"slambench: the pool of {len(c.pool)} frames ran out {w.seconds:.3f} s into the "
            f"window: the traffic's pool_frames is too small for this rate")

    ctx = {"cfg": cfg, "frames": len(w.latencies), "stages": w.stages,
           "attempted": w.attempted, "keyframes": w.keyframes, "captures": w.captures,
           "dropped": w.dropped,
           "trace": tr}
    metrics = {}
    if traced:
        for m in registry.metrics(bench, "per_layer", wl["name"]):
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"frames_per_s": cell_mod.frames_per_s(w),
                  "frame_ms_p95": cell_mod.p95_ms(w.latencies), "setup_s": setup_s}
        for m in registry.metrics(bench, "end_to_end", wl["name"]):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    c.close()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    rows = reference.judge(c.numbers(), limits)
    log(f"slambench: {len(w.latencies)} frames in {w.seconds:.3f} s, {w.attempted} fed, "
        f"{w.failed} failed, {w.dropped} dropped, {w.keyframes} keyframes; checked {len(c.frame_answers)} frames "
        f"and {len(c.kf_answers)} keyframes in {time.perf_counter() - t_check:.3f} s")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(rows) and all(ok for *_, ok in rows),
              "attempted": w.attempted, "failed": w.failed, "metrics": metrics,
              "device": device_info}
    if tr:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in tr["device_ops"]],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in rows}
    return result, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slambench import registry, roofline

    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        log(f"slambench: {wl['chips']} CUDA card(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    cfg = registry.config(bench, wl["config"])
    traffic = registry.traffic(wl["traffic"])
    limits = registry.limits(wl["name"])
    log(f"slambench: {wl['name']} seed {args.seed}: {power_limit()}; rooflines against "
        f"{roofline.PEAK_NAME}")
    result, rows = run_cell(bench, wl, cfg, traffic, limits, args.seed, args.seconds,
                            bool(args.trace))
    found = loaded_forbidden()
    if found:
        log(f"slambench: loaded in this process after the window: {', '.join(found)}")
        return 2
    for name, value, limit, ok in rows:
        log(f"check {name}: {value!r} against limit {limit!r}: {'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
