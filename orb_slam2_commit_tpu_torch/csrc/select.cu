// K3 cell_topk: exact per-cell top-k of a score map, values descending and
// ties to the lowest index. Replaces the Pallas kernel
// orb_slam2_commit_tpu/ops/pallas_select.py:cell_topk (_cell_topk_kernel).
//
// Two entry points share one kernel. The map form reads the [hc, w]
// score map in place: cell (cy, cx) of a cell x cell grid is a row whose
// entry i is pixel (cy * cell + i / cell, cx * cell + i % cell); columns
// at or past w read 0.0, the zero padding of the width that the JAX
// package's cell matrix has. The row form reads a [C, S] matrix, one cell
// per matrix row.
//
// Semantics follow the Pallas kernel exactly: each row is padded with -inf
// to a multiple of 128 entries, then k rounds of (max, lowest index holding
// the max, set that entry to -inf). When fewer than k finite entries
// remain, a round returns -inf at the lowest index holding -inf, which may
// be one masked by an earlier round, just as the Pallas kernel does.
//
// What bounds it on the H100: memory. It reads the map once (~6 MB for
// the 1480 cells of the 640x480 canvas) and writes 2 x C x k words; the k
// rounds of compares are cheap.
//
// Design: one warp per cell, 4 cells per block. Lane l holds entries
// j * 128 + 4 l + e (j < S_pad / 128, e < 4), a group of four per j; for
// 32x32 cells of a map whose width is a multiple of 4 each group is one
// float4 load, pixel row 4 j + l / 8, columns 4 (l % 8) .. + 3, so 8 lanes
// read one 128-byte cell row. A lane keeps its groups in shared memory
// (group-major, so a warp's accesses to one group never conflict) and
// each group's best entry in registers. Each round is two warp reductions,
// the greatest order key (the float's bits made monotone, -0 as +0) and
// then the lowest index holding it; only the winning lane stores the
// result, masks its entry in its group, finds that group's new best (3
// compares) and its own over the 8 group heads (a tree of depth 3). On an
// H100 80GB HBM3 at 700 W (scripts/kernel_variants.py select-k3, in turns)
// a launch on the 640x480 canvas's [2368, 640] map takes 0.0044 ms,
// against 0.0098-0.0102 ms for the design it replaces, which staged each
// row in shared memory, rescanned all 1024 entries in each round and read
// a copy of the map that cell_matrix wrote first (0.0190-0.0201 ms with
// that copy). Every entry in registers, each round masking by 32 selects
// and rescanning by a tree of depth 5, took 0.0068 ms (by a chain of 32
// compares 0.0072); 2 and 8 cells per block 0.0044 and 0.0050 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;     // cells per block
constexpr int LANE = 128;    // rows are padded with -inf to a multiple of this
constexpr int MAX_J = 8;     // entries per lane / 4: rows of up to 1024

// Monotone in the float's value: a > b as floats iff key(a) > key(b)
// (NaN aside); -0.0 and +0.0 share a key, so their tie goes by index.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The best of a group's four entries: greatest value, ties to the lowest
// position (each node keeps its left child unless the right one is
// greater) -> (value, position 0..3).
__device__ __forceinline__ void group_best(float4 q, float& bv, int& be) {
  const bool y = q.y > q.x, w = q.w > q.z;
  const float a = y ? q.y : q.x, b = w ? q.w : q.z;
  const bool right = b > a;
  bv = right ? b : a;
  be = right ? (w ? 3 : 2) : (y ? 1 : 0);
}

// The best of NJ group heads, by a tree over 8 slots (slots past NJ hold
// -inf and, lying right of every real one, lose every tie).
template <int NJ>
__device__ __forceinline__ void heads_best(const float (&gv)[NJ], const int (&gp)[NJ],
                                           float& hv, int& hp) {
  float bv[MAX_J];
  int bp[MAX_J];
#pragma unroll
  for (int g = 0; g < MAX_J; ++g) {
    bv[g] = g < NJ ? gv[g < NJ ? g : 0] : -INFINITY;
    bp[g] = g < NJ ? gp[g < NJ ? g : 0] : 4 * g;
  }
#pragma unroll
  for (int s = 1; s < MAX_J; s *= 2) {
#pragma unroll
    for (int g = 0; g < MAX_J; g += 2 * s) {
      if (bv[g + s] > bv[g]) {
        bv[g] = bv[g + s];
        bp[g] = bp[g + s];
      }
    }
  }
  hv = bv[0];
  hp = bp[0];
}

// NJ: entries per lane / 4. MAP32: 32x32 cells read by float4 (w, pitch
// multiples of 4, x 16-byte aligned); else any cell_h x cell_w cells read
// entry by entry.
template <int NJ, bool MAP32>
__global__ void __launch_bounds__(WARPS * 32) cell_topk_kernel(
    const float* __restrict__ x, int c, int n_cx, int cell_h, int cell_w, int w,
    int pitch, int k, float* __restrict__ vals, int* __restrict__ args) {
  // Each lane's groups of four entries, group-major: a lane's 16-byte
  // slots are consecutive across the warp, so a warp's accesses to one
  // group never conflict.
  __shared__ float4 staged[WARPS][MAX_J][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= c) return;
  const int cy = row / n_cx, cx = row - cy * n_cx;

  float4 q[NJ];
  if (MAP32) {
    const int col = cx * 32 + 4 * (lane & 7);
    const float* p = x + (size_t)(cy * 32 + (lane >> 3)) * pitch + col;
    const bool in = col < w;    // the whole float4 lies inside or outside
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      q[j] = in ? __ldg(reinterpret_cast<const float4*>(p + (size_t)4 * j * pitch))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const int s = cell_h * cell_w;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float e[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = j * LANE + 4 * lane + t;
        e[t] = -INFINITY;
        if (i < s) {
          const int r = i / cell_w, col = cx * cell_w + (i - r * cell_w);
          e[t] = col < w ? __ldg(x + (size_t)(cy * cell_h + r) * pitch + col) : 0.f;
        }
      }
      q[j] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }

  float gv[NJ];
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

template <int NJ, bool MAP32>
int launch(const float* x, int c, int n_cx, int cell_h, int cell_w, int w, int pitch, int k,
           float* vals, int* args, cudaStream_t stream) {
  cell_topk_kernel<NJ, MAP32><<<(c + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args);
  return (int)cudaGetLastError();
}

// Entries read one by one, NJ = nj.
int launch_entries(const float* x, int c, int n_cx, int cell_h, int cell_w, int w, int pitch,
                   int nj, int k, float* vals, int* args, cudaStream_t stream) {
  switch (nj) {
    case 1: return launch<1, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    case 2: return launch<2, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    case 3: return launch<3, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    case 4: return launch<4, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    case 5: return launch<5, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    case 6: return launch<6, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    case 7: return launch<7, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    case 8: return launch<8, false>(x, c, n_cx, cell_h, cell_w, w, pitch, k, vals, args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Row form: [c, s] matrix, rows padded with -inf to s_pad (<= 1024).
extern "C" int cell_topk_launch(const void* x, int c, int s, int s_pad, int k,
                                void* vals, void* args, void* stream) {
  return launch_entries((const float*)x, c, 1, 1, s, s, s, s_pad / LANE, k, (float*)vals,
                        (int*)args, (cudaStream_t)stream);
}

// Map form: the contiguous [hc, w] map, hc a multiple of cell, cell * cell
// <= 1024; out [(hc / cell) * ceil(w / cell), k].
extern "C" int cell_topk_map_launch(const void* score, int hc, int w, int cell, int k,
                                    void* vals, void* args, void* stream) {
  const int n_cx = (w + cell - 1) / cell, c = (hc / cell) * n_cx;
  const int nj = (cell * cell + LANE - 1) / LANE;
  if (cell == 32 && w % 4 == 0 && (uintptr_t)score % 16 == 0) {
    return launch<MAX_J, true>((const float*)score, c, n_cx, 32, 32, w, w, k, (float*)vals,
                               (int*)args, (cudaStream_t)stream);
  }
  return launch_entries((const float*)score, c, n_cx, cell, cell, w, w, nj, k, (float*)vals,
                        (int*)args, (cudaStream_t)stream);
}
