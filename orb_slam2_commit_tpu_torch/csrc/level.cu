// Level kernels of the packed ORB extractor, for sm_90a.
//
// K1 level_preprocess: 7x7 sigma=2 separable blur + FAST-9/16 V-scores at
//    two thresholds, on a canvas padded by the wrapper (reflect-101 by 3,
//    then edge-padded). Replaces the Pallas kernel
//    orb_slam2_commit_tpu/ops/pallas_level.py:level_preprocess
//    (_level_kernel).
// K2 combine_nms: row-bounds detection mask, per-32-px-cell high/low
//    threshold fallback and 3x3 non-maximum suppression with raster-first
//    ties. Replaces orb_slam2_commit_tpu/ops/pallas_level.py:combine_nms
//    (_combine_nms_kernel).
//
// What bounds them on the H100: memory. K1 reads the padded canvas once and
// writes three canvas-sized maps (~25 MB at 640x480 over 8 levels); its
// ~250 flops per pixel stay far below the card's float32 rate. K2 reads two
// maps and writes one (~19 MB). Design: one thread per output pixel over a
// 32x8 block; each block stages its input tile plus halo in shared memory
// (3 px for K1, whose blur taps and FAST circle both reach +/-3; 2 px of
// combined scores for K2, because NMS needs each neighbour's own is-max
// decision), so every input byte is read from device memory about once.
// K2 first reduces each 32x32 cell to a "has a masked high score" flag in a
// separate small launch, so the per-pixel pass reads one byte per cell.
//
// Rounding: the blur is accumulated tap by tap with explicit round-to-
// nearest multiplies and adds (and the library is built with -fmad=false),
// so nothing is contracted into FMA and the result has the same bits as the
// plain PyTorch version (BRIEF compares blurred values, so one ulp can flip
// a bit).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int HALO = 3;
constexpr int CELL = 32;

struct Taps {
  float t[7];
};

// FAST circle (row, col) offsets in the order of ops/fast.py CIRCLE_OFFSETS.
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool has_arc(unsigned int mask16) {
  unsigned int m = mask16 | (mask16 << 16);
  unsigned int r = m & (m >> 1);
  r = r & (r >> 2);
  r = r & (r >> 4);
  r = r & (m >> 8);
  return (r & 0xFFFFu) != 0u;
}

// padded: [hp + 9, in_stride] (at least hp + 6 rows and wp + 6 columns);
// output pixel (y, x) is centred on padded[y + 3, x + 3].
__global__ void level_kernel(const float* __restrict__ padded, int in_stride,
                             float* __restrict__ blur,
                             float* __restrict__ score_hi,
                             float* __restrict__ score_lo, int wp,
                             float th_hi, float th_lo, Taps taps) {
  __shared__ float tile[BY + 2 * HALO][BX + 2 * HALO];
  __shared__ float hrow[BY + 2 * HALO][BX];

  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int n_threads = BX * BY;

  for (int i = tid; i < (BY + 2 * HALO) * (BX + 2 * HALO); i += n_threads) {
    const int r = i / (BX + 2 * HALO);
    const int c = i % (BX + 2 * HALO);
    tile[r][c] = padded[(size_t)(y0 + r) * in_stride + x0 + c];
  }
  __syncthreads();

  // Horizontal pass over every staged row (taps 0..6 in order).
  for (int i = tid; i < (BY + 2 * HALO) * BX; i += n_threads) {
    const int r = i / BX;
    const int c = i % BX;
    float acc = __fmul_rn(taps.t[0], tile[r][c]);
#pragma unroll
    for (int t = 1; t < 7; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(taps.t[t], tile[r][c + t]));
    }
    hrow[r][c] = acc;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  float b = __fmul_rn(taps.t[0], hrow[ty][tx]);
#pragma unroll
  for (int t = 1; t < 7; ++t) {
    b = __fadd_rn(b, __fmul_rn(taps.t[t], hrow[ty + t][tx]));
  }

  const float center = tile[ty + HALO][tx + HALO];
  unsigned int bb_hi = 0, db_hi = 0, bb_lo = 0, db_lo = 0;
  float sb_hi = 0.f, sd_hi = 0.f, sb_lo = 0.f, sd_lo = 0.f;
#pragma unroll
  for (int bit = 0; bit < 16; ++bit) {
    const float d = __fsub_rn(
        tile[ty + HALO + kCircleDy[bit]][tx + HALO + kCircleDx[bit]], center);
    const unsigned int w = 1u << bit;
    if (d > th_hi) bb_hi |= w;
    if (d < -th_hi) db_hi |= w;
    if (d > th_lo) bb_lo |= w;
    if (d < -th_lo) db_lo |= w;
    sb_hi = __fadd_rn(sb_hi, fmaxf(__fsub_rn(d, th_hi), 0.f));
    sd_hi = __fadd_rn(sd_hi, fmaxf(__fsub_rn(-d, th_hi), 0.f));
    sb_lo = __fadd_rn(sb_lo, fmaxf(__fsub_rn(d, th_lo), 0.f));
    sd_lo = __fadd_rn(sd_lo, fmaxf(__fsub_rn(-d, th_lo), 0.f));
  }
  const bool corner_hi = has_arc(bb_hi) || has_arc(db_hi);
  const bool corner_lo = has_arc(bb_lo) || has_arc(db_lo);

  const size_t o = (size_t)(y0 + ty) * wp + x0 + tx;
  blur[o] = b;
  score_hi[o] = corner_hi ? fmaxf(sb_hi, sd_hi) : 0.f;
  score_lo[o] = corner_lo ? fmaxf(sb_lo, sd_lo) : 0.f;
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

extern "C" int level_preprocess_launch(const void* padded, int in_stride,
                                       void* blur, void* score_hi,
                                       void* score_lo, int hp, int wp,
                                       float th_hi, float th_lo,
                                       const float* taps_host, void* stream) {
  Taps taps;
  for (int t = 0; t < 7; ++t) taps.t[t] = taps_host[t];
  dim3 block(BX, BY);
  dim3 grid(wp / BX, hp / BY);
  level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)padded, in_stride, (float*)blur, (float*)score_hi,
      (float*)score_lo, wp, th_hi, th_lo, taps);
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
