#!/usr/bin/env python3
"""Compare design variants of the port's K1-K8 kernels on one card.

A variant is csrc/<lib>.cu (a set may build two libraries) with a few text
substitutions, each made in the sources that hold its target, or, under
the tag `previous`, the sources of an earlier design read from --previous
DIR (write them there first, for example with
`git show <commit>:orb_slam2_commit_tpu_torch/csrc/matching.cu`). Every
variant of a set is built with the library's own nvcc flags (one nvcc each,
all at once; `-Xptxas -v` lines and instruction counts from cuobjdump are
printed, the sources, libraries and SASS are written to OUT), held against
its plain version on the main paths' inputs, and timed by device-busy time
under torch.profiler in the order A B .. B A twice:
- K1 bit for bit on chip_smoke.py's two canvases;
- K2 bit for bit on chip_smoke.py's three pairs of maps, timed per launch
  on the main canvas's, with the time of each of its two kernels;
- K6 bit for bit on every case of chip_smoke.py's phase 3, timed over the
  monocular pair's searches (the previous design runs the motion stage's
  two windows as two launches) and on a call with every row invalid; K7,
  which shares the library, exact on the stereo pair's two launches and
  timed beside it; the `-clock` variant prints the cycles of block 0's
  staging, scan and merge;
- K7 on the stereo band exact in both directions on chip_smoke.py's band
  cases, timed on the stereo pair's call (the previous design runs K7
  under the band's mask twice, left -> right and right -> left on the
  transposed mask, as the stereo matcher called it), with K6 and K7 under
  a mask still exact; the `-clock` variants, on both sides, add up
  clock64() and %globaltimer in block 0, thread 0, over every launch of
  the timed loop and print the SM clock they imply;
- K3 bit for bit on chip_smoke.py's maps (the previous design in its row
  form on the cell matrix), timed per launch on the main canvas's score
  map (the previous design on the cell matrix, which cell_matrix copied
  out of the map first) and with that copy;
- K4 + K5 on chip_smoke.py's patch cases (the step's and the pair's
  inputs, the 320x240 canvas, centres at and past every edge): both
  windows bit for bit, offsets within K5_TOL; timed per image as the fused
  launch, or, for the previous design and the redesigned standalone
  kernels, as extract_patches twice and corner_subpix (three launches);
  also the two K4 launches alone and K5 alone on the pair's windows;
- K7 under a candidate test (matching-k7m): each form (flags, window,
  epipolar band) exact against its plain version and against K7 under the
  mask it replaces on the recorded calls of its callers (an RGB-D System
  run and a monocular kidnap run, recorded with the committed build) and
  on interop's cases; timed per caller at its recorded shapes (reference
  keyframe, triangulation, initialization, relocalization, BoW
  relocalization as 4 of relocalization's candidates, loop candidates as
  one reference-keyframe call with a batch axis of 1), the previous design
  under the caller's mask built beforehand, and K7 under the triangulation
  masks; the set also prints the 1-bit tensor-core product's rate, the
  CUDA cores' popcount rate, and whether ptxas takes wgmma with 1-bit
  operands for sm_90a;
- K8 within chip_smoke.py's bounds on its six problems, two launches
  bit-identical. K8 variants also report their evaluations, which differ
  between builds because the LM's path depends on float rounding, and the
  time per evaluation; the `-clock` variants add clock64() counters around
  the solve, the SE3 update, the pass and the block reduction of every
  trial evaluation and print cycles per evaluation.

Run from the repository root on a machine with the card:

    python3 scripts/kernel_variants.py pose_lm-threads
    python3 scripts/kernel_variants.py level-tile
    python3 scripts/kernel_variants.py level-combine --previous DIR
    python3 scripts/kernel_variants.py matching-k6 --previous DIR
    python3 scripts/kernel_variants.py matching-k7 --previous DIR
    python3 scripts/kernel_variants.py select-k3 --previous DIR
    python3 scripts/kernel_variants.py patches-k4k5 --previous DIR
    python3 scripts/kernel_variants.py matching-k7m --previous DIR
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam2_commit_tpu_torch import interop  # noqa: E402
from orb_slam2_commit_tpu_torch.kernels import (  # noqa: E402
    _build, level, matching as kmatching, patches, pose_lm, select, subpix)
from orb_slam2_commit_tpu_torch.optim import pose_opt  # noqa: E402

OUT = Path("chiprun_out")
PREVIOUS = "previous"
_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# The entry points of a set's previous design where they differ from the
# committed ones: matching-k6's (the one-window K6, no radius2) and
# matching-k7's (the two-window K6); neither has the batch argument that
# K6 and K7 take now; matching-k7m's (K7 under a mask with a batch axis,
# one warp a row, before the candidate tests).
_PREVIOUS_MASKED = (_c_void_p, _c_int, _c_void_p, _c_int, _c_void_p, _c_void_p, _c_void_p)
PREVIOUS_SIGNATURES = {
    "matching-k7m": {
        "masked_top2_launch": (
            _c_void_p, ctypes.c_longlong, _c_int, _c_void_p, ctypes.c_longlong, _c_int,
            _c_void_p, _c_int, _c_void_p, _c_void_p),
    },
    "matching-k6": {
        "projection_top2_launch": (
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_void_p),
        "masked_top2_launch": _PREVIOUS_MASKED,
    },
    "matching-k7": {
        "projection_top2_launch": (
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_int, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p,
            _c_void_p),
        "masked_top2_launch": _PREVIOUS_MASKED,
    },
}

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
_NT_W, _NT_H = "constexpr int NT_W = 128;", "constexpr int NT_H = 32;"
_ROWS, _CHUNK = "constexpr int ROWS = 8;", "constexpr int CHUNK = 2048;"
_WPR = "constexpr int WPR = 2;"
# clock64() counters in K6's block 0, thread 0, per window count: staging
# of the first chunk, the scan, the merge and store, the whole block.
_K6_CLOCK = [
    ("constexpr unsigned NO_KEY = 0xffffffffu;  // \"no column\": above every key",
     "constexpr unsigned NO_KEY = 0xffffffffu;\n__device__ long long k6_clocks[2][4];"),
    ("  const bool active = row < m && valid_a[row] != 0;\n",
     "  const bool active = row < m && valid_a[row] != 0;\n"
     "  const long long t_start = clock64();\n  long long t_staged = 0;\n"),
    ("      stage_columns(desc_b, xy_b, octave_b, valid_b, c0, cw, stride, sxy, soct, sdesc);\n"
     "      __syncthreads();\n",
     "      stage_columns(desc_b, xy_b, octave_b, valid_b, c0, cw, stride, sxy, soct, sdesc);\n"
     "      __syncthreads();\n      if (!t_staged) t_staged = clock64();\n"),
    ("  // Merge the warp's keys, then the row's parts into part 0.\n",
     "  const long long t_scanned = clock64();\n"),
    ("    if (lane == 0) store_top2(k1[w], k2[w], row, m, n, out + (size_t)w * 4 * m);\n  }\n",
     "    if (lane == 0) store_top2(k1[w], k2[w], row, m, n, out + (size_t)w * 4 * m);\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    const long long t_end = clock64();\n"
     "    k6_clocks[NW - 1][0] = t_staged - t_start;\n"
     "    k6_clocks[NW - 1][1] = t_scanned - t_staged;\n"
     "    k6_clocks[NW - 1][2] = t_end - t_scanned;\n"
     "    k6_clocks[NW - 1][3] = t_end - t_start;\n  }\n"),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int clock_read(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, k6_clocks, sizeof(k6_clocks));\n}\n"),
]
# K6 staged by the bulk-copy engine: one thread asks for the chunk's
# descriptors [cw, 8] and positions [cw, 2] as they lie in device memory
# (an odd last position by a load) and the block waits on an mbarrier,
# while every thread loads its columns' octaves and valid flags; an
# invalid column's x becomes NaN once the copy has landed. The scan reads
# a candidate's descriptor as two 16-byte words of that copy, in which a
# column's eight words lie together.
_K6_BULK = [
    ("// NW windows: radius (and radius2 when NW == 2). out: [NW, 4, m].\n",
     """__device__ __forceinline__ void stage_columns_bulk(
    const uint4* __restrict__ desc_b, const float2* __restrict__ xy_b,
    const int* __restrict__ octave_b, const uint8_t* __restrict__ valid_b,
    int c0, int cw, float2* sxy, int* soct, unsigned* sdesc, uint64_t* bar,
    unsigned& phase) {
  constexpr int CPT = CHUNK / THREADS;
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  const int even = cw & ~1;
  if (threadIdx.x == 0) {
    const unsigned d_bytes = 32u * cw, p_bytes = 8u * even;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(d_bytes + p_bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];"
                 :: "r"((unsigned)__cvta_generic_to_shared(sdesc)),
                    "l"(desc_b + 2 * (size_t)c0), "r"(d_bytes), "r"(b) : "memory");
    if (p_bytes)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                   " [%0], [%1], %2, [%3];"
                   :: "r"((unsigned)__cvta_generic_to_shared(sxy)),
                      "l"(xy_b + c0), "r"(p_bytes), "r"(b) : "memory");
  }
  int oc[CPT];
  bool ok[CPT];
  float2 last = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < cw) {
      oc[k] = __ldg(octave_b + c0 + c);
      ok[k] = __ldg(valid_b + c0 + c) != 0;
      if (c >= even) last = __ldg(xy_b + c0 + c);
    }
  }
  unsigned done = 0;
  while (!done) {
    asm volatile("{\\n .reg .pred ready;\\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\\n"
                 " selp.u32 %0, 1, 0, ready;\\n}"
                 : "=r"(done) : "r"(b), "r"(phase) : "memory");
  }
  phase ^= 1u;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < cw) {
      soct[c] = oc[k];
      if (c >= even) sxy[c] = last;
      if (!ok[k]) sxy[c].x = __int_as_float(0x7fc00000);
    }
  }
}

// NW windows: radius (and radius2 when NW == 2). out: [NW, 4, m].
"""),
    ("    for (int c0 = 0; c0 < n; c0 += cap) {\n",
     "    __shared__ uint64_t bar;\n    unsigned phase = 0;\n"
     "    if (threadIdx.x == 0) {\n"
     "      asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\"\n"
     "                   :: \"r\"((unsigned)__cvta_generic_to_shared(&bar)) : \"memory\");\n"
     "      asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
     "    }\n    __syncthreads();\n"
     "    for (int c0 = 0; c0 < n; c0 += cap) {\n"),
    ("      stage_columns(desc_b, xy_b, octave_b, valid_b, c0, cw, stride, sxy, soct, sdesc);\n",
     "      stage_columns_bulk(desc_b, xy_b, octave_b, valid_b, c0, cw, sxy, soct, sdesc,\n"
     "                         &bar, phase);\n"),
    ("#pragma unroll\n"
     "          for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ sdesc[w * stride + j]);\n",
     "          const uint4* q = reinterpret_cast<const uint4*>(sdesc) + 2 * j;\n"
     "          const uint4 q0 = q[0], q1 = q[1];\n"
     "          const unsigned bw[WORDS] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};\n"
     "#pragma unroll\n"
     "          for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ bw[w]);\n"),
]
# K6 staging positions, octaves and valid flags only (13 of the 45 bytes a
# column): a candidate's descriptor comes from L2 as two 16-byte loads.
_K6_DESC_L2 = [
    ("      if (q < 2 * cw) w[k] = __ldg(d + q);\n", "      if (false) w[k] = __ldg(d + q);\n"),
    ("      if (q < 2 * cw) {\n        unsigned* s", "      if (false) {\n        unsigned* s"),
    ("#pragma unroll\n"
     "          for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ sdesc[w * stride + j]);\n",
     "          const uint4 q0 = __ldg(desc_b + 2 * (size_t)(c0 + j));\n"
     "          const uint4 q1 = __ldg(desc_b + 2 * (size_t)(c0 + j) + 1);\n"
     "          const unsigned bw[WORDS] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};\n"
     "#pragma unroll\n"
     "          for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ bw[w]);\n"),
]
# clock64() and %globaltimer in block 0, thread 0, added up over every
# launch: K7 under a mask (the previous design, one launch per direction)
# and K7 on the band.
_K7_CLOCK_DECL = ("constexpr unsigned NO_KEY = 0xffffffffu;  // \"no column\": above every key",
                  "constexpr unsigned NO_KEY = 0xffffffffu;\n"
                  "__device__ unsigned long long k7_clocks[3];\n"
                  "__device__ __forceinline__ unsigned long long global_ns() {\n"
                  "  unsigned long long t;\n"
                  "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
                  "  return t;\n}")
_K7_CLOCK_END = ("  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
                 "    atomicAdd(&k7_clocks[0], (unsigned long long)(clock64() - c_start));\n"
                 "    atomicAdd(&k7_clocks[1], global_ns() - g_start);\n"
                 "    atomicAdd(&k7_clocks[2], 1ull);\n  }\n")
_K7_CLOCK_READ = ("}  // namespace\n",
                  "}  // namespace\n\nextern \"C\" int clock_read(void* host) {\n"
                  "  return (int)cudaMemcpyFromSymbol(host, k7_clocks, sizeof(k7_clocks));\n}\n")
_K7_CLOCK_START = ("  const long long c_start = clock64();\n"
                   "  const unsigned long long g_start = global_ns();\n")
_K7_CLOCK_MASKED = [
    _K7_CLOCK_DECL,
    ("  const int row = blockIdx.x * WARPS + warp;\n  if (row >= m) return;\n",
     "  const int row = blockIdx.x * WARPS + warp;\n  if (row >= m) return;\n"
     + _K7_CLOCK_START),
    ("  if (lane == 0) store_top2(k1, k2, row, m, n, out);\n}\n",
     "  if (lane == 0) store_top2(k1, k2, row, m, n, out);\n" + _K7_CLOCK_END + "}\n"),
    _K7_CLOCK_READ,
]
_K7_CLOCK_BAND = [
    _K7_CLOCK_DECL,
    ("  const int row = r0 + warp / BAND_WPR;\n",
     "  const int row = r0 + warp / BAND_WPR;\n" + _K7_CLOCK_START),
    ("  if (lane == 0) store_top2(k1, k2, row0 + row, m_all, n, out);\n",
     "  if (lane == 0) store_top2(k1, k2, row0 + row, m_all, n, out);\n" + _K7_CLOCK_END),
    _K7_CLOCK_READ,
]
_BAND_ROWS, _BAND_WPR = "constexpr int BAND_ROWS = 8;", "constexpr int BAND_WPR = 2;"
_K3_WARPS = "constexpr int WARPS = 4;     // cells per block"


# describe_kernel with both windows of a keypoint in one block (the fused
# launch's first design), in place of a block per window: all its loads of
# both windows in flight, then the stores.
_K45_BOTH_WINDOWS = [
    ("""  const int nb = (k + KPB - 1) / KPB;
  const bool brief_part = (int)blockIdx.x >= nb;
  const int kp = ((int)blockIdx.x - (brief_part ? nb : 0)) * KPB + threadIdx.x / TPK;""",
     """  const bool brief_part = false;
  const int kp = blockIdx.x * KPB + threadIdx.x / TPK;"""),
    ("""    if (brief_part) {
      float b[trips<BRIEF, COPY>()];
      load_window<BRIEF, COPY>(blur, hb, wb, clampi(y, 0, hb - 1), clampi(x, 0, wb - 1), tid, b);
      store_window<BRIEF, COPY>(b, tid, brief + (size_t)kp * BRIEF * BRIEF);
    } else {
      float a[trips<IC, COPY>()];
      load_window<IC, COPY>(canvas, h, w, yc, xc, tid, a);
      store_window<IC, COPY>(a, tid, ic + (size_t)kp * IC * IC);
    }""",
     """    float a[trips<IC, COPY>()], b[trips<BRIEF, COPY>()];
    load_window<IC, COPY>(canvas, h, w, yc, xc, tid, a);
    load_window<BRIEF, COPY>(blur, hb, wb, clampi(y, 0, hb - 1), clampi(x, 0, wb - 1), tid, b);
    store_window<IC, COPY>(a, tid, ic + (size_t)kp * IC * IC);
    store_window<BRIEF, COPY>(b, tid, brief + (size_t)kp * BRIEF * BRIEF);"""),
    ("describe_kernel<<<2 * ((k + KPB - 1) / KPB),", "describe_kernel<<<(k + KPB - 1) / KPB,"),
]


def _k45(kpb=1, copy=128, solver=True, split=True):
    """Substitutions that set describe_kernel's layout in csrc/patches.cu
    (the committed one by default)."""
    return [("constexpr int KPB = 1;", f"constexpr int KPB = {kpb};"),
            ("constexpr int COPY = 128;", f"constexpr int COPY = {copy};"),
            ("constexpr bool OWN_SOLVER = true;",
             f"constexpr bool OWN_SOLVER = {str(solver).lower()};"),
            ] + ([] if split else _K45_BOTH_WINDOWS)


# Tags of the patches-k4k5 set that run K4 and K5 as three launches.
THREE_LAUNCHES = (PREVIOUS, "standalone")
# K3 with every entry of a lane in registers (PR 6's first design): a
# round masks the winning entry by 32 selects and rescans the lane by a
# tree of depth 5, in place of one group of four in shared memory and
# the eight group heads.
_K3_REGISTERS = [
    ("""// NJ: entries per lane / 4. MAP32:""",
     """// The lane's best entry by a tree of depth 5 over 32 slots.
template <int NV>
__device__ __forceinline__ void lane_best(const float (&v)[NV], float& hv, int& hp) {
  float bv[32];
  int bp[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    bv[t] = t < NV ? v[t < NV ? t : 0] : -INFINITY;
    bp[t] = t;
  }
#pragma unroll
  for (int s = 1; s < 32; s *= 2) {
#pragma unroll
    for (int t = 0; t < 32; t += 2 * s) {
      if (bv[t + s] > bv[t]) {
        bv[t] = bv[t + s];
        bp[t] = bp[t + s];
      }
    }
  }
  hv = bv[0];
  hp = bp[0];
}

// NJ: entries per lane / 4. MAP32:"""),
    ("""  float gv[NJ];
  int gp[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    staged[warp][j][lane] = q[j];
    group_best(q[j], gv[j], gp[j]);
    gp[j] += 4 * j;
  }
  float hv;
  int hp;
  heads_best(gv, gp, hv, hp);
  for (int round = 0; round < k; ++round) {
    const unsigned key = order_key(hv);
    const unsigned best = __reduce_max_sync(0xffffffffu, key);
    const unsigned idx = (unsigned)((hp / 4) * LANE + 4 * lane + hp % 4);
    const unsigned win = __reduce_min_sync(0xffffffffu, key == best ? idx : 0xffffffffu);
    if (idx == win) {
      vals[(size_t)row * k + round] = hv;
      args[(size_t)row * k + round] = (int)idx;
      // Mask the entry, then find its group's new head and the lane's.
      const int j = hp / 4, e = hp % 4;
      float4 g4 = staged[warp][j][lane];
      g4.x = e == 0 ? -INFINITY : g4.x;
      g4.y = e == 1 ? -INFINITY : g4.y;
      g4.z = e == 2 ? -INFINITY : g4.z;
      g4.w = e == 3 ? -INFINITY : g4.w;
      staged[warp][j][lane] = g4;
      float nv;
      int ne;
      group_best(g4, nv, ne);
#pragma unroll
      for (int g = 0; g < NJ; ++g) {
        if (g == j) {
          gv[g] = nv;
          gp[g] = 4 * g + ne;
        }
      }
      heads_best(gv, gp, hv, hp);
    }
  }
}

""",
     """  float v[4 * NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    v[4 * j] = q[j].x;
    v[4 * j + 1] = q[j].y;
    v[4 * j + 2] = q[j].z;
    v[4 * j + 3] = q[j].w;
  }
  float hv;
  int hp;
  lane_best(v, hv, hp);
  for (int round = 0; round < k; ++round) {
    const unsigned key = order_key(hv);
    const unsigned best = __reduce_max_sync(0xffffffffu, key);
    const unsigned idx = (unsigned)((hp / 4) * LANE + 4 * lane + hp % 4);
    const unsigned win = __reduce_min_sync(0xffffffffu, key == best ? idx : 0xffffffffu);
    if (idx == win) {
      vals[(size_t)row * k + round] = hv;
      args[(size_t)row * k + round] = (int)idx;
#pragma unroll
      for (int t = 0; t < 4 * NJ; ++t) {
        if (t == hp) v[t] = -INFINITY;
      }
      lane_best(v, hv, hp);
    }
  }
}

"""),
]

# K2 in one launch: each per-pixel block finds the flags of the 3 x 6
# cells its staged pixels lie in from score_hi inside the bounds (every
# row of those cells, 18 float4 loads a thread, all in flight), in place
# of the flag pass and its launch.
_K2_ONE_LAUNCH = [
    ("""  for (int k = tid; k < FR * FC; k += 32 * NMS_BY) {
    const int cy = y0 / CELL - 1 + k / FC, cx = x0 / CELL - 1 + k % FC;
    cell_hi[k / FC][k % FC] =
        cy >= 0 && cy < hp / CELL && cx >= 0 && cx < n_cx ? flags[cy * n_cx + cx] : 0;
  }
  __syncthreads();
""", """  __shared__ int2 cell_bounds[FR * CELL];
  __shared__ unsigned cell_bits;
  if (tid == 0) cell_bits = 0;
  for (int r = tid; r < FR * CELL; r += 32 * NMS_BY) {
    const int y = y0 - CELL + r;
    cell_bounds[r] = y >= 0 && y < hp
        ? make_int2(__ldg(bounds + (size_t)y * bounds_stride),
                    __ldg(bounds + (size_t)y * bounds_stride + 1))
        : make_int2(0, 0);
  }
  __syncthreads();
  {
    constexpr int Q = FC * CELL / 4;
    constexpr int PER = FR * CELL * Q / (32 * NMS_BY);
    static_assert(PER * 32 * NMS_BY == FR * CELL * Q, "cells split evenly");
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * 32 * NMS_BY;
      const int r = i / Q, q = i % Q;
      const int y = y0 - CELL + r, x = x0 - CELL + 4 * q;
      const int2 b = cell_bounds[r];
      if (x >= 0 && x < wp && x + 4 > b.x && x < b.y) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(score_hi + (size_t)y * wp + x));
        const float v[4] = {s.x, s.y, s.z, s.w};
        bool f = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) f |= v[e] > 0.f && x + e >= b.x && x + e < b.y;
        if (f) bits |= 1u << ((r / CELL) * FC + q / (CELL / 4));
      }
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (tx == 0 && bits) atomicOr(&cell_bits, bits);
  }
  __syncthreads();
  if (tid < FR * FC) cell_hi[tid / FC][tid % FC] = (cell_bits >> tid) & 1u;
  __syncthreads();
"""),
    ("""  const int strips = (hp / CELL) * (wp / FLAG_W);
  cell_flag_kernel<<<strips, FLAG_WARPS * 32, 0, s>>>(
      (const float*)score_hi, (const int*)bounds, bounds_stride, wp,
      (unsigned char*)flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
""", ""),
]

# K7 under a candidate test on CUDA cores (design (a)): each lane gathers
# its two rows' whole descriptors from its quad once, and in place of the
# tensor cores' product reads its two columns' descriptors from shared
# memory and counts popcount(row & column) itself, 8 popcounts a pair
# (each column read serves two rows, four with MT_RT = 2).
_K7M_POPC = [
    ("#pragma unroll\n  for (int i = 0; i < MT_RT; ++i) {\n    live[i] = ",
     "unsigned ra[2 * MT_RT][WORDS];\n#pragma unroll\n"
     "  for (int q = 0; q < 2 * MT_RT; ++q) {\n#pragma unroll\n"
     "    for (int w = 0; w < 4; ++w) {\n"
     "      ra[q][w] = __shfl_sync(0xffffffffu, a[q / 2][q % 2], (lane & ~3) | w);\n"
     "      ra[q][w + 4] = __shfl_sync(0xffffffffu, a[q / 2][2 + q % 2], (lane & ~3) | w);\n"
     "    }\n  }\n"
     "#pragma unroll\n  for (int i = 0; i < MT_RT; ++i) {\n    live[i] = "),
    ("          and_popc(a[i], bw.x, bw.y, c);\n",
     "          const uint4* cd = reinterpret_cast<const uint4*>(sdesc + 4 * (8 * jt + 2 * t));\n"
     "#pragma unroll\n          for (int e = 0; e < 2; ++e) {\n"
     "            const uint4 p0 = cd[2 * e], p1 = cd[2 * e + 1];\n"
     "#pragma unroll\n            for (int h = 0; h < 2; ++h) {\n"
     "              const unsigned* r = ra[2 * i + h];\n"
     "              c[2 * h + e] = __popc(r[0] & p0.x) + __popc(r[4] & p0.y) + "
     "__popc(r[1] & p0.z) + __popc(r[5] & p0.w) + __popc(r[2] & p1.x) + "
     "__popc(r[6] & p1.y) + __popc(r[3] & p1.z) + __popc(r[7] & p1.w);\n"
     "            }\n          }\n"),
]
# K7 under a candidate test reading each tile's B fragments from L1/L2
# (two 4-byte loads a lane) in place of the staged copy; the columns' key
# bases, masks and test values are still staged.
_K7M_L1 = [
    ("      d[0] = make_uint4(w0[k].x, w1[k].x, w0[k].y, w1[k].y);\n"
     "      d[1] = make_uint4(w0[k].z, w1[k].z, w0[k].w, w1[k].w);\n", "      (void)d;\n"),
    ("        const uint2 bw = sdesc[32 * jt + lane];\n",
     "        const unsigned* bcol = reinterpret_cast<const unsigned*>(p.desc_b) +\n"
     "                               (size_t)(scol[8 * jt + g].x & COL_MASK) * WORDS;\n"
     "        const uint2 bw = make_uint2(__ldg(bcol + t), __ldg(bcol + t + 4));\n"),
]
# K7 under a candidate test with its first epilogue: the test of a pair
# run only where its key would enter the row's top-2 (behind a branch,
# the column's values read from shared memory per pair), in place of
# every pair's verdict without a branch and the division only near the
# band's edge.
_K7M_LAZY = [
    ("// The test of a pair beyond both flags (the row's values v, the column's\n// coordinates xy and threshold thr), in the float32 operations and order\n// of the mask it replaces, without a branch -> 1 (a candidate), 0 (not)\n// or -1 (exact_test decides: the mask byte, or the division near the\n// band's edge; sq: the epipolar distance's numerator).\ntemplate <int T>\n__device__ __forceinline__ int pair_verdict(const float (&v)[4], float2 xy, float thr,\n                                            float r, float& sq) {\n  if (T == T_WINDOW)\n    return fabsf(__fsub_rn(v[0], xy.x)) <= r && fabsf(__fsub_rn(v[1], xy.y)) <= r;\n  if (T == T_EPIPOLAR) {\n    const float num = __fadd_rn(__fadd_rn(__fmul_rn(v[0], xy.x), __fmul_rn(v[1], xy.y)), v[2]);\n    sq = __fmul_rn(num, num);\n    // sq / den < thr without the division where sq lies clear of thr den:\n    // each rounding moves a side by at most 2^-24, well inside the 2^-20\n    // margins, so fl(sq / den) < thr holds below the first and fails above\n    // the second. A td outside [1e-30, FLT_MAX] (subnormal, inf or NaN)\n    // takes the division.\n    const float td = __fmul_rn(thr, v[3]);\n    if (!(td >= 1e-30f && td <= 3.4028235e38f)) return -1;\n    if (sq < __fmul_rn(td, 0.99999905f)) return 1;    // 1 - 2^-20\n    return sq > __fmul_rn(td, 1.00000095f) ? 0 : -1;  // 1 + 2^-20\n  }\n  return T == T_MASK ? -1 : 1;\n}\n\n// The exact test of a pair (row, column c) whose verdict was -1.\ntemplate <int T>\n__device__ __forceinline__ bool exact_test(const TestArgs& p, int row, int c, float sq,\n                                           float den, float thr) {\n  if (T == T_MASK) return __ldg(p.mask + (size_t)row * p.n + c) != 0;\n  return __fdiv_rn(sq, den) < thr;\n}\n\n",
     '// The test of the pair (row, column c in staged slot j) beyond both flags, in the\n// float32 operations (and order) of the mask it replaces.\ntemplate <int T>\n__device__ __forceinline__ bool pair_test(const TestArgs& p, const float (&v)[4], int row,\n                                          int c, int j, const float2* sxy, const float* sthr) {\n  if (T == T_MASK) return __ldg(p.mask + (size_t)row * p.n + c) != 0;\n  if (T == T_WINDOW) {\n    const float2 q = sxy[j];\n    return fabsf(__fsub_rn(v[0], q.x)) <= p.r && fabsf(__fsub_rn(v[1], q.y)) <= p.r;\n  }\n  if (T == T_EPIPOLAR) {\n    const float2 q = sxy[j];\n    const float num = __fadd_rn(__fadd_rn(__fmul_rn(v[0], q.x), __fmul_rn(v[1], q.y)), v[2]);\n    const float sq = __fmul_rn(num, num), thr = sthr[j];\n    // sq / den < thr without the division where sq lies clear of thr den:\n    // each rounding moves a side by at most 2^-24, well inside the 2^-20\n    // margins, so fl(sq / den) < thr holds below the first and fails above\n    // the second. A td outside [1e-30, FLT_MAX] (subnormal, inf or NaN)\n    // takes the division.\n    const float td = __fmul_rn(thr, v[3]);\n    if (td >= 1e-30f && td <= 3.4028235e38f) {\n      if (sq < __fmul_rn(td, 0.99999905f)) return true;    // 1 - 2^-20\n      if (sq > __fmul_rn(td, 1.00000095f)) return false;   // 1 + 2^-20\n    }\n    return __fdiv_rn(sq, v[3]) < thr;\n  }\n  return true;\n}\n\n'),
    ("        // The test's values of the lane's two columns (2t, 2t + 1).\n        float4 cxy = make_float4(0.f, 0.f, 0.f, 0.f);\n        float2 cthr = make_float2(0.f, 0.f);\n        if (T == T_WINDOW || T == T_EPIPOLAR) {\n          cxy = *reinterpret_cast<const float4*>(sxy + 8 * jt + 2 * t);\n        }\n        if (T == T_EPIPOLAR) cthr = *reinterpret_cast<const float2*>(sthr + 8 * jt + 2 * t);\n", ""),
    ('              const float thr = e ? cthr.y : cthr.x;\n              float sq = 0.f;\n              const int verdict = pair_verdict<T>(\n                  v[q], e ? make_float2(cxy.z, cxy.w) : make_float2(cxy.x, cxy.y), thr, p.r, sq);\n              // (pa + pb - 2 popc(a & b)) << COL_BITS | column, or all ones\n              // where a flag is clear or the test fails.\n              const unsigned key = ((e ? cb.z : cb.x) + row_base[q] -\n                                    ((unsigned)c[2 * h + e] << (COL_BITS + 1))) |\n                                   (e ? cb.w : cb.y) | row_mask[q] | (verdict ? 0u : NO_KEY);\n              if (key < k2[q] &&\n                  (verdict > 0 || exact_test<T>(p, r0 + 16 * i + g + 8 * h,\n                                                key & COL_MASK, sq, v[q][3], thr))) {\n                insert(key, k1[q], k2[q]);\n',
     '              // (pa + pb - 2 popc(a & b)) << COL_BITS | column, or all ones\n              // where a flag is clear.\n              const unsigned key = ((e ? cb.z : cb.x) + row_base[q] -\n                                    ((unsigned)c[2 * h + e] << (COL_BITS + 1))) |\n                                   (e ? cb.w : cb.y) | row_mask[q];\n              if (key < k2[q]) {\n                const int j = 8 * jt + 2 * t + e;\n                const int row = r0 + 16 * i + g + 8 * h;\n                if (pair_test<T>(p, v[q], row, key & COL_MASK, j, sxy, sthr)) {\n                  insert(key, k1[q], k2[q]);\n                }\n'),
]
_MT_WARPS, _MT_WPR, _MT_RT, _MT_CHUNK = (
    "constexpr int MT_WARPS = 8;", "constexpr int MT_WPR = 8;", "constexpr int MT_RT = 1;",
    "constexpr int MT_CHUNK = 1024;")
# One column tile a trip of the scan loop, in place of two (their loads and
# products issued together).
_K7M_UNROLL1 = [("#pragma unroll 2\n      for (int jt = part; jt < slots / 8; jt += MT_WPR) {\n",
                 "      for (int jt = part; jt < slots / 8; jt += MT_WPR) {\n")]


def _k7m(warps=8, wpr=8, rt=1, chunk=1024):
    """Substitutions that set K7's block in csrc/matching.cu: `warps` a
    block, `wpr` of them on the same 16 x `rt` rows, `chunk` columns staged
    a pass (the committed 8, 8, 1, 1024 by default)."""
    return [(_MT_WARPS, f"constexpr int MT_WARPS = {warps};"),
            (_MT_WPR, f"constexpr int MT_WPR = {wpr};"),
            (_MT_RT, f"constexpr int MT_RT = {rt};"),
            (_MT_CHUNK, f"constexpr int MT_CHUNK = {chunk};")]


# name -> (library, {tag: substitutions}, kernels whose SASS is counted)
SETS = {
    # K8's block size: the committed 256 threads against 128, 384 and 512.
    "pose_lm-threads": ("pose_lm", {
        f"{n}-clock": ([] if n == 256 else [(_THREADS, f"constexpr int THREADS = {n};")])
        + _CLOCK
        for n in (256, 128, 384, 512)}, ("pose_lm_kernel",)),
    # K1's output tile: the committed 32x64 against 32x32.
    "level-tile": ("level", {
        "32x64": [],
        "32x32": [("constexpr int TH = 64;", "constexpr int TH = 32;")],
    }, ("level_kernel",)),
    # K2: the previous design against the committed 128x32 tile of 8
    # thread rows and 8 flag warps, and other tiles, 4 thread rows, 4 flag
    # warps, and one launch that finds its cells' flags in every block.
    "level-combine": ("level", {
        PREVIOUS: [],
        "128x32": [],
        "128x64": [(_NT_H, "constexpr int NT_H = 64;")],
        "64x32": [(_NT_W, "constexpr int NT_W = 64;")],
        "128x32-by4": [("constexpr int NMS_BY = 8;", "constexpr int NMS_BY = 4;")],
        "128x32-flag4": [("constexpr int FLAG_WARPS = 8;", "constexpr int FLAG_WARPS = 4;")],
        "128x32-one-launch": _K2_ONE_LAUNCH,
    }, ("cell_flag_kernel", "combine_nms_kernel")),
    # K6: the previous design against the committed 8 rows per block, 2
    # warps per row and 2048-column chunks staged by vector loads; 1 and 4
    # warps per row; 4 and 16 rows; 512-column chunks (two passes over the
    # main paths' 1000 columns); staging by the bulk-copy engine; the
    # committed build with clock counters.
    "matching-k6": ("matching", {
        PREVIOUS: [],
        "rows8-wpr2": [],
        "rows8-wpr1": [(_WPR, "constexpr int WPR = 1;")],
        "rows8-wpr4": [(_WPR, "constexpr int WPR = 4;")],
        "rows4-wpr2": [(_ROWS, "constexpr int ROWS = 4;")],
        "rows16-wpr2": [(_ROWS, "constexpr int ROWS = 16;")],
        "rows8-wpr2-chunk512": [(_CHUNK, "constexpr int CHUNK = 512;")],
        "rows8-wpr2-bulk": _K6_BULK,
        "rows8-wpr2-desc-l2": _K6_DESC_L2,
        "rows8-wpr4-desc-l2": [(_WPR, "constexpr int WPR = 4;")] + _K6_DESC_L2,
        "rows4-wpr2-desc-l2": [(_ROWS, "constexpr int ROWS = 4;")] + _K6_DESC_L2,
        "rows8-wpr2-clock": _K6_CLOCK,
    }, ("projection_top2_kernel", "masked_top2_kernel")),
    # K7: the previous design (two launches under the band's mask) against
    # the committed band kernel, 8 rows per block and 2 warps per row; 1
    # and 4 warps per row; 4 and 16 rows; both sides with clock counters.
    "matching-k7": ("matching", {
        PREVIOUS: [],
        "band-rows8-wpr2": [],
        "band-rows8-wpr1": [(_BAND_WPR, "constexpr int BAND_WPR = 1;")],
        "band-rows8-wpr4": [(_BAND_WPR, "constexpr int BAND_WPR = 4;")],
        "band-rows4-wpr2": [(_BAND_ROWS, "constexpr int BAND_ROWS = 4;")],
        "band-rows16-wpr2": [(_BAND_ROWS, "constexpr int BAND_ROWS = 16;")],
        f"{PREVIOUS}-clock": _K7_CLOCK_MASKED,
        "band-rows8-wpr2-clock": _K7_CLOCK_BAND,
    }, ("stereo_band_top2_kernel", "masked_top2_kernel")),
    # K3: the previous design (row form on the cell matrix) against the
    # committed 4 cells per block with groups of four staged in shared
    # memory, 2 and 8 cells, and every entry in registers.
    "select-k3": ("select", {
        PREVIOUS: [],
        "warps4": [],
        "warps2": [(_K3_WARPS, "constexpr int WARPS = 2;")],
        "warps8": [(_K3_WARPS, "constexpr int WARPS = 8;")],
        "warps4-registers": _K3_REGISTERS,
    }, ("cell_topk_kernel",)),
    # K7 under a candidate test: the previous design (K7 under a mask, one
    # warp a row, on the caller's mask built beforehand) against the committed
    # 16 rows a block (8 warps on the same 16 rows, each on every eighth
    # 8-slot tile, two tiles a trip; tensor cores; the candidate columns of
    # 1024-column chunks packed into shared memory; every pair's verdict
    # without a branch); 16 rows with 4 or 16 warps; 32, 64 and 128 rows a
    # block with 1, 2 or 4 warps on the same rows; two 16-row tiles a warp;
    # 512- and 2048-column chunks; one tile a trip; B fragments read from
    # L1/L2; popcounts on CUDA cores in place of the tensor cores; the first
    # epilogue (each pair's test behind a branch, run only where its key
    # would enter the top-2).
    "matching-k7m": ("matching", {
        PREVIOUS: [],
        "rows16-w8-wpr8": [],
        "rows16-w4-wpr4": _k7m(warps=4, wpr=4),
        "rows16-w16-wpr16": _k7m(warps=16, wpr=16),
        "rows32-w8-wpr4": _k7m(wpr=4),
        "rows32-w4-wpr2": _k7m(warps=4, wpr=2),
        "rows64-w4": _k7m(warps=4, wpr=1),
        "rows64-w8-wpr2": _k7m(wpr=2),
        "rows128-w8": _k7m(wpr=1),
        "rows64-w2-rt2": _k7m(warps=2, wpr=1, rt=2),
        "rows16-w8-wpr8-chunk512": _k7m(chunk=512),
        "rows16-w8-wpr8-chunk2048": _k7m(chunk=2048),
        "rows16-w8-wpr8-unroll1": _K7M_UNROLL1,
        "rows16-w8-wpr8-b-l1": _K7M_L1,
        "rows16-w8-wpr8-popc": _K7M_POPC,
        "rows16-w8-wpr8-lazy": _K7M_LAZY,
        "rows16-w16-wpr16-lazy": _k7m(warps=16, wpr=16) + _K7M_LAZY,
        "rows16-w4-wpr4-lazy": _k7m(warps=4, wpr=4) + _K7M_LAZY,
        "rows64-w4-lazy": _k7m(warps=4, wpr=1) + _K7M_LAZY,
        "rows64-w4-lazy-popc": _k7m(warps=4, wpr=1) + _K7M_LAZY + _K7M_POPC,
    }, ("candidate_top2_kernel", "masked_top2_kernel")),
    # K4 + K5: the previous designs (two K4 launches and one K5, one
    # thread per keypoint) against the committed fused launch (blocks of
    # one window each: 128 copying threads, and beside them in a 31x31
    # block a warp solving), the same with 224 copying threads, with 256
    # and the solve on the last copying warp, with 2 keypoints a block;
    # blocks copying both windows of 1 or 2 keypoints with 128 or 256
    # threads, the solve on the last copying warp or on a warp of its own
    # beside 224 or 256; and the redesigned standalone kernels as three
    # launches.
    "patches-k4k5": (("patches", "subpix"), {
        PREVIOUS: [],
        "split-t128-solver": _k45(),
        "split-t224-solver": _k45(copy=224),
        "split-t256": _k45(copy=256, solver=False),
        "split-kpb2-t128-solver": _k45(kpb=2),
        "kpb1-t256": _k45(copy=256, solver=False, split=False),
        "kpb1-t128": _k45(solver=False, split=False),
        "kpb2-t128": _k45(kpb=2, solver=False, split=False),
        "kpb2-t256": _k45(kpb=2, copy=256, solver=False, split=False),
        "kpb1-t256-solver": _k45(copy=256, split=False),
        "kpb1-t224-solver": _k45(copy=224, split=False),
        "standalone": [],
    }, ("describe_kernel", "patch_kernel", "subpix_kernel")),
}


def build(libs, tag, subs, previous):
    """Start nvcc on the variant's sources -> {lib: (process, library)};
    each substitution is made in every source that holds its target, and
    the headers come from the sources' own directory."""
    src_dir = previous if tag.startswith(PREVIOUS) else _build.CSRC_DIR
    srcs = {}
    for lib in libs:
        src_path = src_dir / f"{lib}.cu"
        if not src_path.exists():
            raise SystemExit(f"{src_path} not found: write the previous design's source there")
        srcs[lib] = src_path.read_text()
    for a, b in subs:
        hit = [lib for lib in libs if a in srcs[lib]]
        if not hit:
            raise SystemExit(f"{tag}: substitution target not found: {a[:60]!r}")
        for lib in hit:
            srcs[lib] = srcs[lib].replace(a, b)
    out = {}
    for lib, src in srcs.items():
        path = OUT / f"variant_{lib}_{tag}.cu"
        path.write_text(src)
        so = path.with_suffix(".so")
        out[lib] = (subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *_build.nvcc_flags(lib), "-I", str(src_dir), "-o",
             str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return out


def load(set_name, lib, tag, so):
    """The variant's library, its entry points typed; a previous design
    lacks the entry points that came after it."""
    dll = ctypes.CDLL(str(so))
    signatures = PREVIOUS_SIGNATURES.get(set_name, {}) if tag.startswith(PREVIOUS) else {}
    for fn_name, argtypes in {**_build.SIGNATURES[lib], **signatures}.items():
        if not hasattr(dll, fn_name):
            continue
        fn = getattr(dll, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return dll


def sass_counts(so, kernels):
    """-> [(function, instructions, most common opcodes)] of every function
    whose name holds one of `kernels`."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    (so.with_suffix(".sass")).write_text(sass)
    found = []
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n")[0].strip()
        if any(k in name for k in kernels):
            ops = [re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split()[0].split(".")[0]
                   for m in re.finditer(r"/\*[0-9a-f]{4,5}\*/\s+(.*?);", part)]
            found.append((name, len(ops), Counter(ops).most_common(6)))
    return found


def previous_k6(dll):
    """The one-window K6 behind the wrapper's interface: one launch per
    window."""
    def top2(*args):
        outs = []
        for r in args[2]:
            a = (*args[:2], r, *args[3:])
            out = torch.empty((4, a[0].shape[0]), dtype=torch.int32, device=a[0].device)
            _build.check(dll.projection_top2_launch(
                *(t.data_ptr() for t in a[:6]), a[0].shape[0],
                *(t.data_ptr() for t in a[6:]), a[6].shape[0], out.data_ptr(),
                _build.stream_of(a[0])), "previous projection_top2")
            outs.append(tuple(out))
        return tuple(outs)
    return top2


def previous_k6_two_windows(dll):
    """The two-window K6 without a batch argument behind the wrapper's
    interface: both windows in one launch."""
    def top2(desc_a, proj, radii, *rest):
        m, n = desc_a.shape[0], rest[3].shape[0]
        desc_b, xy_b = _build.aligned(rest[3]), _build.aligned(rest[4])
        out = torch.empty((len(radii), 4, m), dtype=torch.int32, device=desc_a.device)
        _build.check(dll.projection_top2_launch(
            desc_a.data_ptr(), _build.aligned(proj).data_ptr(), radii[0].data_ptr(),
            radii[1].data_ptr() if len(radii) == 2 else None,
            *(t.data_ptr() for t in rest[:3]), m, desc_b.data_ptr(), xy_b.data_ptr(),
            rest[5].data_ptr(), rest[6].data_ptr(), n, out.data_ptr(),
            _build.stream_of(desc_a)), "previous projection_top2")
        return tuple(tuple(o) for o in out)
    return top2


def previous_masked(dll):
    """A previous design's K7 under a mask, with no batch argument."""
    def top2(desc_a, desc_b, mask):
        out = torch.empty((4, desc_a.shape[0]), dtype=torch.int32, device=desc_a.device)
        _build.check(dll.masked_top2_launch(
            desc_a.data_ptr(), desc_a.shape[0], desc_b.data_ptr(), desc_b.shape[0],
            mask.data_ptr(), out.data_ptr(), _build.stream_of(desc_a)),
            "previous masked_top2")
        return out[0], out[1], out[2], out[3]
    return top2


# The 1-bit tensor-core product's rate (the H100's data sheet gives
# none), CUDA cores' popcount rate beside it, and whether ptxas takes
# wgmma with 1-bit operands for sm_90a (compiled, not run).
_RATE_CU = r"""
#include <cuda_runtime.h>
__global__ void b1_mma_rate(int iters, int* out) {
  const unsigned a0 = threadIdx.x * 2654435761u, a1 = ~a0, a2 = a0 ^ 0x5bd1e995u,
                 a3 = blockIdx.x * 40503u, b0 = a0 >> 3, b1 = a1 << 5;
  int c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  int s = 0;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 0x7fffffff) out[0] = s;
}
__global__ void popc_rate(int iters, int* out) {
  unsigned x[8];
  for (int k = 0; k < 8; ++k) x[k] = threadIdx.x * (k + 1) * 2654435761u;
  int acc[8] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[k] += __popc(x[k]);
      x[k] = x[k] * 1664525u + 1013904223u;
    }
  }
  int s = 0;
  for (int k = 0; k < 8; ++k) s += acc[k];
  if (s == 0x7fffffff) out[0] = s;
}
extern "C" int rate_launch(int which, int blocks, int iters, void* out, void* stream) {
  if (which == 0) b1_mma_rate<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, (int*)out);
  else popc_rate<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, (int*)out);
  return (int)cudaGetLastError();
}
"""
_WGMMA_B1_CU = r"""
__global__ void wgmma_b1(unsigned long long da, unsigned long long db, int* out) {
  int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n8k256.s32.b1.b1.and.popc"
               " {%0, %1, %2, %3}, %4, %5, p;\n}"
               : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3) : "l"(da), "l"(db), "r"(0));
  out[threadIdx.x] = d0 + d1 + d2 + d3;
}
"""


def one_bit_rates():
    """Print the 1-bit MMA's and the popcount's rates on this card (all SMs,
    8 blocks of 256 threads each, independent chains), and what ptxas says
    to wgmma with 1-bit operands."""
    nvcc = "/usr/local/cuda/bin/nvcc"
    src, so = OUT / "k7m_rates.cu", OUT / "k7m_rates.so"
    src.write_text(_RATE_CU)
    subprocess.run([nvcc, *_build.nvcc_flags("matching"), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(so))
    dll.rate_launch.argtypes = [_c_int, _c_int, _c_int, _c_void_p, _c_void_p]
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    for which, what, per_call in ((0, "mma.sync m16n8k256 .b1 AND + popc", 16 * 8 * 256 * 2),
                                  (1, "__popc (CUDA cores)", 1)):
        iters = 4096 if which == 0 else 65536

        def run():
            _build.check(dll.rate_launch(which, blocks, iters, out.data_ptr(),
                                         _build.stream_of(out)), "rate_launch")

        ms = cs.gpu_time_ms(run, 5)
        n = blocks * 256 * iters * 8 * (per_call / 32 if which == 0 else per_call)
        unit = "bit operations (AND and add)" if which == 0 else "popcounts"
        print(f"rate: {what}: {n / ms / 1e9:.1f} T {unit}/s ({ms:.3f} ms for "
              f"{n:.3g}); {cs.smi_clocks()}")
    src = OUT / "k7m_wgmma_b1.cu"
    src.write_text(_WGMMA_B1_CU)
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-c", "-o",
                        str(src.with_suffix(".o")), str(src)], capture_output=True, text=True)
    print(f"wgmma m64n8k256 .b1 .and.popc on sm_90a: "
          f"{'ptxas takes it' if r.returncode == 0 else 'refused'}"
          + (f": {r.stderr.strip()[:400]}" if r.returncode else ""))


def previous_masked_batched(dll):
    """The previous design's K7 under a mask, with a batch axis, behind
    the masked wrapper's interface."""
    def top2(desc_a, desc_b, mask):
        m, n = mask.shape[-2:]
        lead = tuple(mask.shape[:-2])
        out = torch.empty((lead[0] if lead else 1, 4, m), dtype=torch.int32,
                          device=desc_a.device)
        _build.check(dll.masked_top2_launch(
            desc_a.data_ptr(), m * 8 if desc_a.dim() == 3 else 0, m, desc_b.data_ptr(),
            n * 8 if desc_b.dim() == 3 else 0, n, mask.data_ptr(), out.shape[0],
            out.data_ptr(), _build.stream_of(desc_a)), "previous masked_top2")
        return tuple(out.reshape(lead + (4, m)).unbind(-2))
    return top2


def is_previous(state):
    return state["tag"].startswith(PREVIOUS)


def level_checks(x, state):
    th_hi, th_lo = x["ths"]
    canvases = (x["canvas"], x["small_canvas"])
    want = [level.level_preprocess_plain(*level.pad_level(c), th_hi, th_lo)
            for c in canvases]

    def check():
        for c, w in zip(canvases, want):
            got = level.level_preprocess(c, th_hi, th_lo)
            if not all(torch.equal(g, v) for g, v in zip(got, w)):
                raise SystemExit("K1 variant is not bit-exact")

    return check, {"K1": lambda: level.level_preprocess(x["canvas"], th_hi, th_lo)}, 200


def combine_checks(x, state):
    th_hi, th_lo = x["ths"]
    _, s_hi, s_lo = level.level_preprocess(x["small_canvas"], th_hi, th_lo)
    maps = ((x["hi"], x["lo"], x["bounds"]), (s_hi, s_lo, x["small_bounds"]),
            (torch.zeros_like(x["hi"]), x["lo"], x["bounds"]))
    want = [level.combine_nms_plain(*m) for m in maps]

    def check():
        for m, w in zip(maps, want):
            if not torch.equal(level.combine_nms(*m), w):
                raise SystemExit("K2 variant is not bit-exact")

    return check, {"K2": lambda: level.combine_nms(*maps[0])}, 200


def matching_checks(x, state):
    problems = list(cs.k6_problems(x))
    want7 = [kmatching.masked_hamming_top2_plain(*a) for a in x["k7"]]

    def check():
        for what, args in problems:
            cs.check_k6(what, args)
        for a, w in zip(x["k7"], want7):
            if not all(torch.equal(g, v) for g, v in zip(kmatching.masked_hamming_top2(*a), w)):
                raise SystemExit("K7 differs from its plain version")

    # The motion stage's call with every row invalid: a launch with nothing
    # to scan, the floor of a launch's device time.
    motion = x["k6"][0]
    idle = (*motion[:5], torch.zeros_like(motion[5]), *motion[6:])
    return check, {
        "K6 pair": lambda: [kmatching.projection_hamming_top2(*a) for a in x["k6"]],
        "K6 every row invalid": lambda: kmatching.projection_hamming_top2(*idle),
        "K7 stereo pair": lambda: [kmatching.masked_hamming_top2(*a) for a in x["k7"]],
    }, 200


def pose_checks(x, state):
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

    return check, {"K8": lambda: [pose_lm.pose_lm(*a) for a in x["k8"]]}, 50


def band_checks(x, state):
    """K7: the band kernel on chip_smoke.py's band cases (the previous
    design has none), K7 under a mask and K6 on theirs."""
    problems = list(cs.band_problems(x))
    check6, _, _ = matching_checks(x, state)

    def check():
        check6()
        if not is_previous(state):
            for what, args in problems:
                cs.check_band(what, args)

    def k7():
        if is_previous(state):
            return [kmatching.masked_hamming_top2(*a) for a in x["k7"]]
        return kmatching.stereo_band_top2(*x["k7_band"])

    return check, {"K7 stereo pair": k7}, 200


def select_checks(x, state):
    """K3: the map form on chip_smoke.py's two score maps, the row form on
    the main map's cell matrix (the previous design: the row form only)."""
    k, cell = x["k"], x["cell"]
    maps = (x["score"], x["small_score"])
    want = [select.cell_topk_map_plain(m, cell, k) for m in maps]

    def check():
        for m, (wv, wa) in zip(maps, want):
            got = (select.cell_topk(select.cell_matrix(m, cell), k) if is_previous(state)
                   else select.cell_topk_map(m, cell, k))
            if not (torch.equal(got[0], wv) and torch.equal(got[1], wa)):
                raise SystemExit("K3 variant differs from its plain version")

    def k3():
        if is_previous(state):
            return select.cell_topk(x["cells"], k)
        return select.cell_topk_map(x["score"], cell, k)

    def k3_with_copy():
        if is_previous(state):
            return select.cell_topk(select.cell_matrix(x["score"], cell), k)
        return select.cell_topk_map(x["score"], cell, k)

    return check, {"K3": k3, "K3 with its input's copy": k3_with_copy}, 200


def patches_checks(x, state):
    """K4 + K5: the fused launch (the previous design and the standalone
    kernels: extract_patches twice, then corner_subpix on the 31x31
    windows) on chip_smoke.py's patch cases against the plain version."""
    problems = list(cs.describe_problems(x))
    want = [patches.describe_patches_plain(*args, True) for _, args in problems]
    half = patches.PATCH_SIZE // 2

    def k45(canvas, blur, yx):
        if state["tag"] in THREE_LAUNCHES:
            ic = patches.extract_patches(canvas, yx, patches.PATCH_SIZE)
            brief = patches.extract_patches(blur, yx, patches.BRIEF_PATCH)
            return ic, brief, subpix.corner_subpix_from_patches(ic, half, half)
        return patches.describe_patches(canvas, blur, yx, True)

    def check():
        for (what, args), w in zip(problems, want):
            ic, brief, off = k45(*args)
            err = cs.max_abs(off, w[2])
            if not (torch.equal(ic, w[0]) and torch.equal(brief, w[1]) and err <= cs.K5_TOL):
                raise SystemExit(f"K4 + K5 variant differs from the plain version on the "
                                 f"{what} inputs (offsets max|d| {err:g})")
            print(f"{state['tag']}: {what}: windows exact, offsets max|d| {err:g} px")

    def windows_only():
        if state["tag"] in THREE_LAUNCHES:
            return (patches.extract_patches(canvas, yx, patches.PATCH_SIZE),
                    patches.extract_patches(blur, yx, patches.BRIEF_PATCH))
        return patches.describe_patches(canvas, blur, yx, False)

    canvas, blur, yx = x["canvas"], x["blur"], x["yx"]
    return check, {
        "K4 + K5 per image": lambda: k45(canvas, blur, yx),
        "K4 + K5 without refinement": windows_only,
        "K4 both windows": lambda: (patches.extract_patches(canvas, yx, patches.PATCH_SIZE),
                                    patches.extract_patches(blur, yx, patches.BRIEF_PATCH)),
        "K5 alone": lambda: subpix.corner_subpix_from_patches(*x["k5"]),
    }, 200


def k7m_checks(x, state):
    """K7 under a candidate test: each form on the recorded calls of its
    callers (the RGB-D System's reference-keyframe and triangulation
    calls, the monocular kidnap run's initialization and relocalization
    calls, recorded with the committed build) and on interop's cases,
    against its plain version and against K7 under the mask it replaces;
    the previous design under the callers' masks. Timed per caller, at its
    recorded shapes: the form, or (previous) K7 under the caller's mask
    built beforehand; BoW relocalization as the first 4 candidates of a
    relocalization call, the loop candidates as one reference-keyframe
    call with its column table given a batch axis of 1."""
    x.update(cs.system_path_inputs({"rgbd": cs.system_sequence("rgbd")}))
    x.update(cs.mono_path_inputs(cs.system_sequence("monocular", kidnap=True)))
    one_bit_rates()
    reloc = x["mono_k7_reloc"][0]
    ref = x["sys_k7"][0]
    callers = {
        "reference keyframe": ("valid_hamming_top2", x["sys_k7"]),
        "triangulation": ("epipolar_hamming_top2", x["sys_k7b"]),
        "initialization": ("window_hamming_top2", x["mono_k7_init"]),
        "relocalization": ("valid_hamming_top2", x["mono_k7_reloc"]),
        "BoW relocalization": ("valid_hamming_top2", [
            (reloc[0][:4].contiguous(), reloc[1], reloc[2][:4].contiguous(), reloc[3])]),
        "loop candidates": ("valid_hamming_top2", [
            (ref[0], ref[1][None].contiguous(), ref[2], ref[3][None].contiguous())]),
    }
    masks = {c: [(a[0], a[1], cs.k7_mask(name, a)) for a in calls]
             for c, (name, calls) in callers.items()}
    problems = [(what, name, a) for what, name, a in cs.k7_problems(x)] + [
        (f"{c} call {i}", name, a) for c, (name, calls) in callers.items()
        if c in ("BoW relocalization", "loop candidates") for i, a in enumerate(calls)]
    want_masked = {c: [kmatching.masked_hamming_top2_plain(*a) for a in m]
                   for c, m in masks.items()}

    def check():
        if is_previous(state):
            top2 = previous_masked_batched(_build._libraries["matching"])
            for c, m in masks.items():
                for a, w in zip(m, want_masked[c]):
                    if not all(torch.equal(g, v) for g, v in zip(top2(*a), w)):
                        raise SystemExit(f"the previous K7 differs on the {c} calls")
            return
        for what, name, a in problems:
            cs.check_form(what, name, a, twice=False)

    def timed_caller(c):
        name, calls = callers[c]

        def run():
            if is_previous(state):
                top2 = previous_masked_batched(_build._libraries["matching"])
                return [top2(*a) for a in masks[c]]
            return [getattr(kmatching, name)(*a) for a in calls]
        return run

    def timed_masked():
        top2 = (previous_masked_batched(_build._libraries["matching"])
                if is_previous(state) else kmatching.masked_hamming_top2)
        return [top2(*a) for a in masks["triangulation"]]

    timed = {f"K7 {c}": timed_caller(c) for c in callers}
    timed["K7 under the triangulation masks"] = timed_masked
    return check, timed, 200


CHECKS = {"pose_lm-threads": pose_checks, "level-tile": level_checks,
          "level-combine": combine_checks, "matching-k6": matching_checks,
          "matching-k7": band_checks, "select-k3": select_checks,
          "patches-k4k5": patches_checks, "matching-k7m": k7m_checks}


def k7_clocks(dll):
    """A K7 `-clock` variant's sums: (cycles, ns, launches)."""
    c = (ctypes.c_ulonglong * 3)()
    dll.clock_read(c)
    return tuple(c)


def print_clocks(set_name, lib, tag, dll, x):
    """Run the main path's calls of a `-clock` variant once each and print
    the cycles its counters read."""
    dll.clock_read.argtypes = [ctypes.c_void_p]
    if set_name == "matching-k7":
        return     # read around the timed loop instead
    if lib == "matching":
        for what, a in zip(("motion stage", "local-map stage"), x["k6"]):
            kmatching.projection_hamming_top2(*a)
            torch.cuda.synchronize()
            c = (ctypes.c_longlong * 8)()
            dll.clock_read(c)
            w = 4 * (len(a[2]) - 1)
            print(f"{lib} {tag} {what}: block 0, thread 0 cycles: staging {c[w]}, scan "
                  f"{c[w + 1]}, merge and store {c[w + 2]}, whole block {c[w + 3]}")
        return
    for what, a in zip(("mono", "mono", "stereo", "stereo"), x["k8"] + x["k8_stereo"]):
        pose_lm.pose_lm(*a)
        torch.cuda.synchronize()
        c = (ctypes.c_longlong * 6)()
        dll.clock_read(c)
        n = max(c[4], 1)
        print(f"{lib} {tag} {what} problem: cycles per trial evaluation: solve "
              f"{c[0] / n:.0f}, SE3 {c[1] / n:.0f}, pass {c[2] / n:.0f}, block "
              f"reduction {c[3] / n:.0f} ({c[4]} trials, {c[5]} cycles in all)")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("set", choices=sorted(SETS))
    parser.add_argument("--previous", type=Path, default=Path("_checkouts/previous"),
                        help="directory holding the previous design's <lib>.cu")
    args = parser.parse_args()
    libs, variants, kernels = SETS[args.set]
    libs = (libs,) if isinstance(libs, str) else libs
    lib = "+".join(libs)
    OUT.mkdir(exist_ok=True)
    _, _, power = cs.phase_device()

    built = {tag: build(libs, tag, subs, args.previous) for tag, subs in variants.items()}
    state = {"tag": ""}
    dlls = {}
    for tag, procs in built.items():
        dlls[tag] = {}
        for name_lib, (proc, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{name_lib} {tag}: nvcc failed\n{log}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"{name_lib} {tag}: {line.strip()}")
            for name, n, top in sass_counts(so, kernels):
                print(f"{name_lib} {tag}: {name[:60]} {n} SASS instructions {top}")
            dlls[tag][name_lib] = load(args.set, name_lib, tag, so)

    config, step_args = interop.make_example(cs.WIDTH, cs.HEIGHT, cs.N_FEATURES,
                                             cs.N_POINTS, "cuda")
    pairs = {s: interop.make_fused_example(cs.WIDTH, cs.HEIGHT, cs.N_FEATURES, cs.N_POINTS,
                                           cs.N_CANDIDATES, "cuda", sensor=s)
             for s in ("monocular", "stereo")}
    x = cs.main_path_inputs(step_args[0], *pairs["monocular"])
    x.update(cs.stereo_path_inputs(*pairs["stereo"]))
    check, timed, iters = CHECKS[args.set](x, state)

    wrappers = (kmatching.projection_hamming_top2, kmatching.masked_hamming_top2)
    previous_k6s = {"matching-k6": previous_k6, "matching-k7": previous_k6_two_windows}

    def use(tag):
        state["tag"] = tag
        _build._libraries.update(dlls[tag])
        dll = dlls[tag][libs[0]]
        previous = args.set in previous_k6s and tag.startswith(PREVIOUS)
        kmatching.projection_hamming_top2, kmatching.masked_hamming_top2 = (
            (previous_k6s[args.set](dll), previous_masked(dll)) if previous else wrappers)

    tags = list(dlls)
    times = {(t, what): [] for t in tags for what in timed}
    split = {}
    evals = {}
    for tag in tags:
        use(tag)
        check()
        print(f"{lib} {tag}: exact against the plain versions")
        if lib == "pose_lm":
            evals[tag] = sum(pose_lm.work_done(*a)[0] for a in x["k8"])
        if hasattr(dlls[tag][libs[0]], "clock_read"):
            print_clocks(args.set, lib, tag, dlls[tag][libs[0]], x)
    clocks_before = {t: k7_clocks(dlls[t][libs[0]]) for t in tags
                     if args.set == "matching-k7" and hasattr(dlls[t][libs[0]], "clock_read")}
    for order in (tags, tags[::-1], tags, tags[::-1]):
        for tag in order:
            use(tag)
            for what, fn in timed.items():
                ms, by_name = cs.device_busy_ms(fn, iters)
                times[(tag, what)].append(ms)
                split.setdefault((tag, what), []).append(by_name)
    kmatching.projection_hamming_top2, kmatching.masked_hamming_top2 = wrappers
    for tag, before in clocks_before.items():
        cycles, ns, n = (a - b for a, b in zip(k7_clocks(dlls[tag][libs[0]]), before))
        print(f"{lib} {tag}: block 0, thread 0 over the timed loop's {n} launches: "
              f"{cycles / max(n, 1):.0f} cycles and {ns / max(n, 1):.0f} ns per launch, "
              f"{cycles / max(ns, 1) * 1e3:.0f} MHz")
    for tag in tags:
        for what in timed:
            v = times[(tag, what)]
            by_op = {}
            for d in split[(tag, what)]:
                for k, ms in d.items():
                    by_op[k] = min(by_op.get(k, ms), ms)
            line = (f"{lib} {tag} {what}: device-busy ms per call {[round(t, 5) for t in v]}"
                    f"; by operation, least of 4: " + ", ".join(
                        f"{k} {ms:.4f}" for k, ms in sorted(by_op.items())))
            if lib == "pose_lm":
                line += (f", {evals[tag]:.0f} evaluations, "
                         f"{min(v) / evals[tag] * 1e3:.3f} us per evaluation")
            print(f"{line} on {power}; {cs.smi_clocks()}")


if __name__ == "__main__":
    main()
