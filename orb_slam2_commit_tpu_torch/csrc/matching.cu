// Hamming top-2 kernels: K6 projection_hamming_top2 and K7
// masked_hamming_top2. Both give, per row, the best and second-best Hamming
// distance (and their columns) over the row's candidate columns.
//
// K6: for each of M projected map points, over the N current keypoints
// that fall inside its search window and octave band. Replaces the Pallas
// kernels orb_slam2_commit_tpu/ops/pallas_matching.py:
// projection_hamming_top2 (_projection_kernel, VPU popcount, and
// _projection_mxu_kernel, +-1 bf16 matmul; both give the same outputs).
// A column is a candidate when |u - x| <= r and |v - y| <= r (float32),
// lo <= octave <= hi, and both valid flags are set.
//
// K7: over the candidates of a caller-supplied [M, N] bool mask. Replaces
// the Pallas kernel orb_slam2_commit_tpu/ops/pallas_matching.py:
// masked_hamming_top2 (_masked_kernel). Its main caller is the stereo
// matcher (ops/stereo.py): left -> right under the epipolar, octave and
// disparity mask, and right -> left under the transposed mask for the
// mutual check.
//
// Semantics follow the Pallas kernels exactly, index fallbacks included.
// Rows are reduced by the packed key (distance << COL_BITS) | column, so
// ties go to the lowest column; a non-candidate carries the distance code
// EMPTY (> 256), which decodes to BIG = 1 << 20. A row with no candidate
// has best index 0; where a row has fewer than two candidates the second
// index is the lowest non-candidate column other than the best (clamped
// to N - 1), as _top2_reduce gives it. COL_BITS = 23 lifts the TPU's
// 4096-column limit to 8M columns.
//
// What bounds them on the H100: neither memory nor arithmetic. K6 moves
// ~0.2 MB in and out at [2048, 1000] and does ~2M window tests and ~30
// integer operations per candidate pair. K7 reads ~1 MB of mask at the
// stereo path's [1000, 1000] (~0.3 us at 3.35 TB/s) and pays ~24 integer
// operations per candidate pair. Each is a few microseconds of
// latency-bound work.
// Design: one warp per row, 8 rows per block. The row's descriptor (and
// K6's window) live in registers; lanes stride over the N columns, so each
// column's position, octave and flag (K6) or the row's mask bytes (K7)
// are read coalesced, and a column's 32 descriptor bytes are read only
// when it is a candidate (__popc on the 8 XORed words). Each lane keeps
// its two smallest keys; five shuffle rounds merge them across the warp.
// Only the 4 x M results reach memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int WORDS = 8;                  // 256-bit descriptor
constexpr int COL_BITS = 23;
constexpr unsigned COL_MASK = (1u << COL_BITS) - 1u;
constexpr unsigned EMPTY = 511u;          // distance code of a non-candidate
constexpr int BIG = 1 << 20;
constexpr unsigned NO_KEY = 0xffffffffu;  // "no column": above every key

__device__ __forceinline__ void insert(unsigned key, unsigned& k1, unsigned& k2) {
  if (key < k1) {
    k2 = k1;
    k1 = key;
  } else if (key < k2) {
    k2 = key;
  }
}

// Merge each lane's two smallest keys across the warp; lane 0 decodes
// them into out[0..3][row].
__device__ __forceinline__ void reduce_and_store(
    unsigned k1, unsigned k2, int lane, int row, int m, int n, int* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    const unsigned lo1 = min(k1, o1);
    const unsigned hi1 = max(k1, o1);
    k2 = min(hi1, min(k2, o2));
    k1 = lo1;
  }
  if (lane == 0) {
    const unsigned d1 = k1 >> COL_BITS, d2 = k2 >> COL_BITS;
    out[row] = d1 >= EMPTY ? BIG : (int)d1;
    out[m + row] = min((int)(k1 & COL_MASK), n - 1);
    out[2 * m + row] = d2 >= EMPTY ? BIG : (int)d2;
    out[3 * m + row] = min((int)(k2 & COL_MASK), n - 1);
  }
}

__global__ void projection_top2_kernel(
    const int* __restrict__ desc_a, const float* __restrict__ proj,
    const float* __restrict__ radius, const int* __restrict__ oct_lo,
    const int* __restrict__ oct_hi, const uint8_t* __restrict__ valid_a, int m,
    const int* __restrict__ desc_b, const float* __restrict__ xy_b,
    const int* __restrict__ octave_b, const uint8_t* __restrict__ valid_b,
    int n, int* __restrict__ out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= m) return;

  unsigned a[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) a[w] = (unsigned)__ldg(desc_a + (size_t)row * WORDS + w);
  const float u = __ldg(proj + 2 * row);
  const float v = __ldg(proj + 2 * row + 1);
  const float r = __ldg(radius + row);
  const int lo = __ldg(oct_lo + row);
  const int hi = __ldg(oct_hi + row);
  const bool va = valid_a[row] != 0;

  unsigned k1 = NO_KEY, k2 = NO_KEY;
  for (int j = lane; j < n; j += 32) {
    const float x = __ldg(xy_b + 2 * j);
    const float y = __ldg(xy_b + 2 * j + 1);
    const int oc = __ldg(octave_b + j);
    const bool cand = va && valid_b[j] != 0 && fabsf(u - x) <= r &&
                      fabsf(v - y) <= r && oc >= lo && oc <= hi;
    unsigned d = EMPTY;
    if (cand) {
      d = 0;
      const int* b = desc_b + (size_t)j * WORDS;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ (unsigned)__ldg(b + w));
    }
    insert((d << COL_BITS) | (unsigned)j, k1, k2);
  }
  reduce_and_store(k1, k2, lane, row, m, n, out);
}

__global__ void masked_top2_kernel(
    const int* __restrict__ desc_a, int m, const int* __restrict__ desc_b,
    int n, const uint8_t* __restrict__ mask, int* __restrict__ out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= m) return;

  unsigned a[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) a[w] = (unsigned)__ldg(desc_a + (size_t)row * WORDS + w);
  const uint8_t* mrow = mask + (size_t)row * n;

  unsigned k1 = NO_KEY, k2 = NO_KEY;
  for (int j = lane; j < n; j += 32) {
    unsigned d = EMPTY;
    if (__ldg(mrow + j) != 0) {
      d = 0;
      const int* b = desc_b + (size_t)j * WORDS;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ (unsigned)__ldg(b + w));
    }
    insert((d << COL_BITS) | (unsigned)j, k1, k2);
  }
  reduce_and_store(k1, k2, lane, row, m, n, out);
}

}  // namespace

extern "C" int projection_top2_launch(
    const void* desc_a, const void* proj, const void* radius,
    const void* oct_lo, const void* oct_hi, const void* valid_a, int m,
    const void* desc_b, const void* xy_b, const void* octave_b,
    const void* valid_b, int n, void* out, void* stream) {
  const int blocks = (m + WARPS - 1) / WARPS;
  projection_top2_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)desc_a, (const float*)proj, (const float*)radius,
      (const int*)oct_lo, (const int*)oct_hi, (const uint8_t*)valid_a, m,
      (const int*)desc_b, (const float*)xy_b, (const int*)octave_b,
      (const uint8_t*)valid_b, n, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int masked_top2_launch(
    const void* desc_a, int m, const void* desc_b, int n, const void* mask,
    void* out, void* stream) {
  const int blocks = (m + WARPS - 1) / WARPS;
  masked_top2_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)desc_a, m, (const int*)desc_b, n, (const uint8_t*)mask,
      (int*)out);
  return (int)cudaGetLastError();
}
