// Level kernels of the packed ORB extractor, for sm_90a.
//
// K1 level_preprocess: 7x7 sigma=2 separable blur + FAST-9/16 V-scores at
//    two thresholds, straight from the unpadded canvas. Replaces the Pallas
//    kernel orb_slam2_commit_tpu/ops/pallas_level.py:level_preprocess
//    (_level_kernel).
// K2 combine_nms: row-bounds detection mask, per-32-px-cell high/low
//    threshold fallback and 3x3 non-maximum suppression with raster-first
//    ties. Replaces orb_slam2_commit_tpu/ops/pallas_level.py:combine_nms
//    (_combine_nms_kernel).
//
// What bounds them on the H100: memory by the byte count, instruction issue
// in practice. K1 reads the canvas once and writes three canvas-sized maps
// (~24 MB at 640x480 over 8 levels), ~7 us at 3.35 TB/s; its ~400
// instructions per pixel (the FAST ring alone is 16 x ~18) take longer to
// issue than that (~20 us at 1.98 GHz). K2 reads two maps and writes one
// (~19 MB).
//
// K1's design: one 32-wide, 64-tall output tile per block of 32x8
// threads, each thread eight consecutive rows of one column. The block
// stages the tile plus its 3-px halo (70x38, 1.30x the outputs) in shared
// memory, one warp per row with coalesced loads, runs the horizontal blur
// over the 70 staged rows (1.09x the outputs), then slides the vertical
// blur down its eight rows on 14 loaded values and reads the FAST ring
// from the unblurred tile (a 32x32 tile was 3.5% slower on an H100,
// scripts/kernel_variants.py level-tile). The ring's bright and dark
// masks are built from sign bits by funnel shifts, not compares and
// selects: ~18 instructions per ring pixel and output.
// The padding the Pallas wrapper built in device memory (reflect-101 by 3,
// then edge-replicated right and bottom) is index arithmetic here:
// padded row r is canvas row row_src[r] and padded column c canvas column
// col_src[c] (two int32 tables built once on the host, kernels/level.py).
// A tile whose halo lies inside the canvas indexes it directly; the
// others, at the canvas edges and over the pad rows and columns, go
// through the tables. Stores are 32 consecutive floats per warp and row.
//
// K2's design: one thread per output pixel over a 32x8 block that stages
// a 2-px halo of combined scores (NMS needs each neighbour's own is-max
// decision). It first reduces each 32x32 cell to a "has a masked high
// score" flag in a separate small launch, so the per-pixel pass reads one
// byte per cell.
//
// Rounding: the blur is accumulated tap by tap, taps 0..6 in order, with
// explicit round-to-nearest multiplies and adds (and the library is built
// with -fmad=false); the vertical pass reuses loaded values, never partial
// sums. So nothing is contracted into FMA and the result has the same bits
// as the plain PyTorch version on the padded canvas (BRIEF compares blurred
// values, so one ulp can flip a bit).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int HALO = 3;
constexpr int CELL = 32;
// K1's output tile, its staged tile and the rows each thread produces.
constexpr int TW = 32;
constexpr int TH = 64;
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int RPT = TH / BY;

struct Taps {
  float t[7];
};

// FAST circle (row, col) offsets in the order of ops/fast.py CIRCLE_OFFSETS:
// rows -3 -3 -2 -1 0 1 2 3 3 3 2 1 0 -1 -2 -3, columns 0 1 2 3 3 3 2 1 0 -1
// -2 -3 -3 -3 -2 -1, packed 3 bits per entry (offset + 3) so that in the
// unrolled ring loop they fold into the loads' immediate offsets.
__device__ __forceinline__ constexpr int ring_dy(int k) {
  return (int)((0x53976d63440ull >> (3 * k)) & 7u) - 3;
}
__device__ __forceinline__ constexpr int ring_dx(int k) {
  return (int)((0x440053976d63ull >> (3 * k)) & 7u) - 3;
}

__device__ __forceinline__ bool has_arc(unsigned int mask16) {
  unsigned int m = mask16 | (mask16 << 16);
  unsigned int r = m & (m >> 1);
  r = r & (r >> 2);
  r = r & (r >> 4);
  r = r & (m >> 8);
  return (r & 0xFFFFu) != 0u;
}

// image: [h, w] canvas; row_src [>= hp + 6], col_src [>= wp + 6]: padded
// index -> canvas index. Output pixel (y, x) is centred on padded
// (y + 3, x + 3), which is image[row_src[y + 3], col_src[x + 3]].
__global__ void __launch_bounds__(BX * BY)
level_kernel(const float* __restrict__ image, int h, int w,
             const int* __restrict__ row_src, const int* __restrict__ col_src,
             float* __restrict__ blur, float* __restrict__ score_hi,
             float* __restrict__ score_lo, int wp, float th_hi, float th_lo,
             Taps taps) {
  __shared__ float tile[SH][SW];   // padded rows y0.., columns x0..
  __shared__ float hrow[SH][TW];   // their horizontal blur

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;

  // Stage: one warp per row, lanes over the 38 columns (32 + 6).
  const bool interior = y0 >= HALO && y0 + TH + HALO <= h && x0 >= HALO &&
                        x0 + TW + HALO <= w;
  if (interior) {
    const float* src = image + (size_t)(y0 - HALO) * w + (x0 - HALO);
    for (int r = warp; r < SH; r += BY) {
      const float* row = src + (size_t)r * w;
      tile[r][lane] = __ldg(row + lane);
      if (lane < SW - 32) tile[r][32 + lane] = __ldg(row + 32 + lane);
    }
  } else {
    const int c0 = __ldg(col_src + x0 + lane);
    const int c1 = lane < SW - 32 ? __ldg(col_src + x0 + 32 + lane) : 0;
    for (int r = warp; r < SH; r += BY) {
      const float* row = image + (size_t)__ldg(row_src + y0 + r) * w;
      tile[r][lane] = __ldg(row + c0);
      if (lane < SW - 32) tile[r][32 + lane] = __ldg(row + c1);
    }
  }
  __syncthreads();

  // Horizontal pass over every staged row (taps 0..6 in order).
  for (int r = warp; r < SH; r += BY) {
    float acc = __fmul_rn(taps.t[0], tile[r][lane]);
#pragma unroll
    for (int t = 1; t < 7; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(taps.t[t], tile[r][lane + t]));
    }
    hrow[r][lane] = acc;
  }
  __syncthreads();

  // Vertical pass down this thread's RPT rows, on RPT + 6 loaded values.
  const int r0 = warp * RPT;
  float col[RPT + 2 * HALO];
#pragma unroll
  for (int k = 0; k < RPT + 2 * HALO; ++k) col[k] = hrow[r0 + k][lane];

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    float b = __fmul_rn(taps.t[0], col[j]);
#pragma unroll
    for (int t = 1; t < 7; ++t) b = __fadd_rn(b, __fmul_rn(taps.t[t], col[j + t]));

    const int ty = r0 + j + HALO;
    const int tx = lane + HALO;
    const float center = tile[ty][tx];
    // Ring pixel k is bright iff th - d < 0 and dark iff d + th < 0 (both
    // exact in sign), so each mask collects sign bits, one funnel shift per
    // pixel; ring pixel k lands on bit 15 - k, and a reversed ring has the
    // same arcs. The V-score terms are max(d - th, 0) = max(-(th - d), 0)
    // and max(-d - th, 0) = max(-(d + th), 0), summed in ring order from
    // the first term; a zero term may come out as -0, which changes no sum
    // that a corner's score reads.
    unsigned int bb_hi = 0, db_hi = 0, bb_lo = 0, db_lo = 0;
    float sb_hi, sd_hi, sb_lo, sd_lo;
#pragma unroll
    for (int bit = 0; bit < 16; ++bit) {
      const float d = __fsub_rn(tile[ty + ring_dy(bit)][tx + ring_dx(bit)], center);
      const float fb_hi = __fsub_rn(th_hi, d), fd_hi = __fadd_rn(d, th_hi);
      const float fb_lo = __fsub_rn(th_lo, d), fd_lo = __fadd_rn(d, th_lo);
      const float tb_hi = fmaxf(-fb_hi, 0.f), td_hi = fmaxf(-fd_hi, 0.f);
      const float tb_lo = fmaxf(-fb_lo, 0.f), td_lo = fmaxf(-fd_lo, 0.f);
      sb_hi = bit ? __fadd_rn(sb_hi, tb_hi) : tb_hi;
      sd_hi = bit ? __fadd_rn(sd_hi, td_hi) : td_hi;
      sb_lo = bit ? __fadd_rn(sb_lo, tb_lo) : tb_lo;
      sd_lo = bit ? __fadd_rn(sd_lo, td_lo) : td_lo;
      bb_hi = __funnelshift_l(__float_as_uint(fb_hi), bb_hi, 1);
      db_hi = __funnelshift_l(__float_as_uint(fd_hi), db_hi, 1);
      bb_lo = __funnelshift_l(__float_as_uint(fb_lo), bb_lo, 1);
      db_lo = __funnelshift_l(__float_as_uint(fd_lo), db_lo, 1);
    }
    const bool corner_hi = has_arc(bb_hi) || has_arc(db_hi);
    const bool corner_lo = has_arc(bb_lo) || has_arc(db_lo);

    const size_t o = (size_t)(y0 + r0 + j) * wp + x0 + lane;
    blur[o] = b;
    score_hi[o] = corner_hi ? fmaxf(sb_hi, sd_hi) : 0.f;
    score_lo[o] = corner_lo ? fmaxf(sb_lo, sd_lo) : 0.f;
  }
}

// flags[cy, cx] = 1 iff cell (cy, cx) holds a pixel inside its row's
// bounds [x0, x1) with score_hi > 0. One 32x8 block per 32x32 cell.
__global__ void cell_flag_kernel(const float* __restrict__ score_hi,
                                 const int* __restrict__ bounds,
                                 int bounds_stride, int wp,
                                 unsigned char* __restrict__ flags) {
  const int x = blockIdx.x * CELL + threadIdx.x;
  int found = 0;
  for (int r = threadIdx.y; r < CELL; r += BY) {
    const int y = blockIdx.y * CELL + r;
    const int bx0 = bounds[(size_t)y * bounds_stride];
    const int bx1 = bounds[(size_t)y * bounds_stride + 1];
    if (x >= bx0 && x < bx1 && score_hi[(size_t)y * wp + x] > 0.f) found = 1;
  }
  found = __syncthreads_or(found);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    flags[blockIdx.y * gridDim.x + blockIdx.x] = found ? 1 : 0;
  }
}

__global__ void combine_nms_kernel(const float* __restrict__ score_hi,
                                   const float* __restrict__ score_lo,
                                   const int* __restrict__ bounds,
                                   int bounds_stride,
                                   const unsigned char* __restrict__ flags,
                                   int hp, int wp, float* __restrict__ out) {
  // Combined scores with a 2-px halo; -inf outside the canvas.
  __shared__ float comb[BY + 4][BX + 4];
  // is-max decisions with a 1-px halo.
  __shared__ unsigned char is_max[BY + 2][BX + 2];

  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int n_threads = BX * BY;
  const int n_cx = wp / CELL;

  for (int i = tid; i < (BY + 4) * (BX + 4); i += n_threads) {
    const int r = i / (BX + 4);
    const int c = i % (BX + 4);
    const int y = y0 - 2 + r;
    const int x = x0 - 2 + c;
    float v = -INFINITY;
    if (y >= 0 && y < hp && x >= 0 && x < wp) {
      const int bx0 = bounds[(size_t)y * bounds_stride];
      const int bx1 = bounds[(size_t)y * bounds_stride + 1];
      if (x >= bx0 && x < bx1) {
        const bool hi = flags[(y / CELL) * n_cx + x / CELL] != 0;
        v = hi ? score_hi[(size_t)y * wp + x] : score_lo[(size_t)y * wp + x];
      } else {
        v = 0.f;
      }
    }
    comb[r][c] = v;
  }
  __syncthreads();

  for (int i = tid; i < (BY + 2) * (BX + 2); i += n_threads) {
    const int r = i / (BX + 2);
    const int c = i % (BX + 2);
    const float s = comb[r + 1][c + 1];
    float nb = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) nb = fmaxf(nb, comb[r + dy][c + dx]);
    }
    is_max[r][c] = (s >= nb && s > 0.f) ? 1 : 0;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // Keep iff is-max and no raster-earlier neighbour (smaller flat index)
  // is a maximum too.
  const bool keep = is_max[ty + 1][tx + 1] && !is_max[ty][tx] &&
                    !is_max[ty][tx + 1] && !is_max[ty][tx + 2] &&
                    !is_max[ty + 1][tx];
  out[(size_t)(y0 + ty) * wp + x0 + tx] = keep ? comb[ty + 2][tx + 2] : 0.f;
}

}  // namespace

extern "C" int level_preprocess_launch(const void* image, int h, int w,
                                       const void* row_src, const void* col_src,
                                       void* blur, void* score_hi,
                                       void* score_lo, int hp, int wp,
                                       float th_hi, float th_lo,
                                       const float* taps_host, void* stream) {
  Taps taps;
  for (int t = 0; t < 7; ++t) taps.t[t] = taps_host[t];
  dim3 block(BX, BY);
  dim3 grid(wp / TW, hp / TH);
  level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)image, h, w, (const int*)row_src, (const int*)col_src,
      (float*)blur, (float*)score_hi, (float*)score_lo, wp, th_hi, th_lo, taps);
  return (int)cudaGetLastError();
}

extern "C" int combine_nms_launch(const void* score_hi, const void* score_lo,
                                  const void* bounds, int bounds_stride,
                                  void* flags, void* out, int hp, int wp,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 block(BX, BY);
  cell_flag_kernel<<<dim3(wp / CELL, hp / CELL), block, 0, s>>>(
      (const float*)score_hi, (const int*)bounds, bounds_stride, wp,
      (unsigned char*)flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_nms_kernel<<<dim3(wp / BX, hp / BY), block, 0, s>>>(
      (const float*)score_hi, (const float*)score_lo, (const int*)bounds,
      bounds_stride, (const unsigned char*)flags, hp, wp, (float*)out);
  return (int)cudaGetLastError();
}
