#!/usr/bin/env python3
"""Compare design variants of the port's K1 and K8 kernels on one card.

A variant is csrc/<lib>.cu with a few text substitutions. Every variant of a
set is built with the library's own nvcc flags (one nvcc each, all at once;
`-Xptxas -v` lines and instruction counts from cuobjdump are printed, the
SASS is written to chiprun_out/), held against its plain version on the
main paths' inputs (K1 bit for bit on chip_smoke.py's two canvases; K8
within chip_smoke.py's bounds on its six problems, two launches
bit-identical), and timed by device-busy time under torch.profiler in the
order A B .. B A twice. K8 variants also report their evaluations, which
differ between builds because the LM's path depends on float rounding, and
the time per evaluation; the `-clock` variants add clock64() counters
around the solve, the SE3 update, the pass and the block reduction of
every trial evaluation and print cycles per evaluation.

Run from the repository root on a machine with the card:

    python3 scripts/kernel_variants.py pose_lm-threads
    python3 scripts/kernel_variants.py level-tile
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam2_commit_tpu_torch import interop  # noqa: E402
from orb_slam2_commit_tpu_torch.kernels import _build, level, pose_lm  # noqa: E402
from orb_slam2_commit_tpu_torch.optim import pose_opt  # noqa: E402

OUT = Path("chiprun_out")

_THREADS = "constexpr int THREADS = 256;"
# clock64() counters around the phases of a trial evaluation, read back by
# clock_read(): solve, SE3, pass, block reduction, trials, whole launch.
_CLOCK = [
    ("constexpr uint8_t VALID = 1, STEREO = 2, ACTIVE = 4;",
     "constexpr uint8_t VALID = 1, STEREO = 2, ACTIVE = 4;\n"
     "__device__ long long clock_counts[6];"),
    ("  float n_evals = 0.0f, obs_evals = 0.0f, rounds = 0.0f;",
     "  float n_evals = 0.0f, obs_evals = 0.0f, rounds = 0.0f;\n"
     "  long long c_solve = 0, c_se3 = 0, c_pass = 0, c_sum = 0, n_trial = 0;\n"
     "  const long long c_start = clock64();"),
    ("      if (lm_solve(cur, lam, x)) {",
     "      const long long c0 = clock64();\n"
     "      const bool solved = lm_solve(cur, lam, x);\n"
     "      c_solve += clock64() - c0;\n"
     "      if (solved) {"),
    ("        se3_left_update(xi, R, t, Rn, tn);\n"
     "        pass(p, s, Rn, tn, false, true, robust, has_stereo, acc);\n"
     "        col = block_sum(acc, part, buf);",
     "        const long long c1 = clock64();\n"
     "        se3_left_update(xi, R, t, Rn, tn);\n"
     "        const long long c2 = clock64();\n"
     "        pass(p, s, Rn, tn, false, true, robust, has_stereo, acc);\n"
     "        const long long c3 = clock64();\n"
     "        col = block_sum(acc, part, buf);\n"
     "        const long long c4 = clock64();\n"
     "        c_se3 += c2 - c1; c_pass += c3 - c2; c_sum += c4 - c3; n_trial += 1;"),
    ("    *n_inliers_out = (long long)n_inliers;",
     "    *n_inliers_out = (long long)n_inliers;\n"
     "    clock_counts[0] = c_solve; clock_counts[1] = c_se3; clock_counts[2] = c_pass;\n"
     "    clock_counts[3] = c_sum; clock_counts[4] = n_trial;\n"
     "    clock_counts[5] = clock64() - c_start;"),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int clock_read(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, clock_counts, sizeof(clock_counts));\n}\n"),
]

SETS = {
    # K8's block size: the committed 256 threads against 128, 384 and 512.
    "pose_lm-threads": ("pose_lm", {
        f"{n}-clock": ([] if n == 256 else [(_THREADS, f"constexpr int THREADS = {n};")])
        + _CLOCK
        for n in (256, 128, 384, 512)}),
    # K1's output tile: the committed 32x64 against 32x32.
    "level-tile": ("level", {
        "32x64": [],
        "32x32": [("constexpr int TH = 64;", "constexpr int TH = 32;")],
    }),
}


def build(lib, tag, subs):
    src = (_build.CSRC_DIR / f"{lib}.cu").read_text()
    for a, b in subs:
        if a not in src:
            raise SystemExit(f"{lib} {tag}: substitution target not found: {a[:60]!r}")
        src = src.replace(a, b)
    path = OUT / f"variant_{lib}_{tag}.cu"
    path.write_text(src)
    so = path.with_suffix(".so")
    proc = subprocess.Popen(["/usr/local/cuda/bin/nvcc", *_build.nvcc_flags(lib), "-o",
                             str(so), str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def load(lib, so):
    dll = ctypes.CDLL(str(so))
    for fn_name, argtypes in _build.SIGNATURES[lib].items():
        fn = getattr(dll, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return dll


def sass_counts(so, kernel):
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    (so.with_suffix(".sass")).write_text(sass)
    for part in sass.split("Function : ")[1:]:
        if kernel in part.split("\n")[0]:
            ops = [re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split()[0].split(".")[0]
                   for m in re.finditer(r"/\*[0-9a-f]{4,5}\*/\s+(.*?);", part)]
            return len(ops), Counter(ops).most_common(8)
    return 0, []


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("set", choices=sorted(SETS))
    args = parser.parse_args()
    lib, variants = SETS[args.set]
    OUT.mkdir(exist_ok=True)
    _, _, power = cs.phase_device()

    built = {tag: build(lib, tag, subs) for tag, subs in variants.items()}
    dlls = {}
    for tag, (proc, so) in built.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{lib} {tag}: nvcc failed\n{log}")
        kernel = "pose_lm_kernel" if lib == "pose_lm" else "level_kernel"
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        n, top = sass_counts(so, kernel)
        print(f"{lib} {tag}: {'; '.join(lines[-2:])}; {kernel} {n} SASS instructions {top}")
        dlls[tag] = load(lib, so)

    config, step_args = interop.make_example(cs.WIDTH, cs.HEIGHT, cs.N_FEATURES,
                                             cs.N_POINTS, "cuda")
    pairs = {s: interop.make_fused_example(cs.WIDTH, cs.HEIGHT, cs.N_FEATURES, cs.N_POINTS,
                                           cs.N_CANDIDATES, "cuda", sensor=s)
             for s in ("monocular", "stereo")}
    x = cs.main_path_inputs(step_args[0], *pairs["monocular"])
    x.update(cs.stereo_path_inputs(*pairs["stereo"]))
    th_hi, th_lo = x["ths"]

    if lib == "level":
        canvases = (x["canvas"], x["small_canvas"])
        want = [level.level_preprocess_plain(*level.pad_level(c), th_hi, th_lo)
                for c in canvases]

        def check():
            for c, w in zip(canvases, want):
                got = level.level_preprocess(c, th_hi, th_lo)
                if not all(torch.equal(g, v) for g, v in zip(got, w)):
                    raise SystemExit("K1 variant is not bit-exact")

        def timed():
            return cs.device_busy_ms(lambda: level.level_preprocess(x["canvas"], th_hi, th_lo),
                                     200)[0]
    else:
        problems = x["k8"] + x["k8_stereo"] + [cs.tiled_problem(x["k8_stereo"][0], n)
                                               for n in cs.K8_TILED_ROWS]
        want = [pose_opt.pose_optimization_plain(*a) for a in problems]

        def check():
            for a, w in zip(problems, want):
                got, again = pose_lm.pose_lm(*a), pose_lm.pose_lm(*a)
                d_rot = cs.rot_angle_deg(got.R.cpu(), w.R.cpu())
                differ = int((got.inliers != w.inliers).sum())
                if not (d_rot < cs.ROT_DEG_TOL and float((got.t - w.t).norm()) < cs.T_TOL
                        and differ <= cs.K8_INLIER_TOL * a[2].shape[0]
                        and all(torch.equal(p, q) for p, q in zip(got, again))):
                    raise SystemExit("K8 variant differs from its plain version")

        def timed():
            return cs.device_busy_ms(lambda: [pose_lm.pose_lm(*a) for a in x["k8"]], 50)[0]

    tags = list(dlls)
    times = {t: [] for t in tags}
    evals = {}
    for tag in tags:
        _build._libraries[lib] = dlls[tag]
        check()
        if lib == "pose_lm":
            evals[tag] = sum(pose_lm.work_done(*a)[0] for a in x["k8"])
        if hasattr(dlls[tag], "clock_read"):
            dlls[tag].clock_read.argtypes = [ctypes.c_void_p]
            for what, a in zip(("mono", "mono", "stereo", "stereo"), x["k8"] + x["k8_stereo"]):
                pose_lm.pose_lm(*a)
                torch.cuda.synchronize()
                c = (ctypes.c_longlong * 6)()
                dlls[tag].clock_read(c)
                n = max(c[4], 1)
                print(f"{lib} {tag} {what} problem: cycles per trial evaluation: solve "
                      f"{c[0] / n:.0f}, SE3 {c[1] / n:.0f}, pass {c[2] / n:.0f}, block "
                      f"reduction {c[3] / n:.0f} ({c[4]} trials, {c[5]} cycles in all)")
    for order in (tags, tags[::-1], tags, tags[::-1]):
        for tag in order:
            _build._libraries[lib] = dlls[tag]
            times[tag].append(timed())
    for tag in tags:
        line = f"{lib} {tag}: device-busy ms per call {[round(v, 5) for v in times[tag]]}"
        if lib == "pose_lm":
            line += (f", {evals[tag]:.0f} evaluations, "
                     f"{min(times[tag]) / evals[tag] * 1e3:.3f} us per evaluation")
        print(f"{line} on {power}")


if __name__ == "__main__":
    main()
