// Hamming top-2 kernels: K6 projection_hamming_top2 and K7 (its band
// form stereo_band_top2 and masked_hamming_top2). Each gives, per row, the
// best and second-best Hamming distance (and their columns) over the row's
// candidate columns.
//
// K6: for each of M projected map points, over the N current keypoints
// that fall inside its search window and octave band. Replaces the Pallas
// kernels orb_slam2_commit_tpu/ops/pallas_matching.py:
// projection_hamming_top2 (_projection_kernel, VPU popcount, and
// _projection_mxu_kernel, +-1 bf16 matmul; both give the same outputs).
// A column is a candidate when |u - x| <= r and |v - y| <= r (float32),
// lo <= octave <= hi, and both valid flags are set. K6 may take a second
// radius per row (the motion stage's widened retry window) and then gives
// both windows' top-2 from one scan.
//
// K7: the same top-2 over a row's candidates. Replaces the Pallas kernel
// orb_slam2_commit_tpu/ops/pallas_matching.py: masked_hamming_top2
// (_masked_kernel), in two forms. On the stereo band (stereo_band_top2,
// the stereo matcher's only call, ops/stereo.py) the kernel tests the
// candidate band itself: left keypoint l and right keypoint r pair when
// both are valid, |y_l - y_r| <= 2 scale_l, octave_r is within octave_l
// +- 1 and -2 <= x_l - x_r <= max_d (float32, max_d the float32 value
// PyTorch compares with); one launch gives left -> right and right ->
// left. Under a caller-supplied [M, N] bool mask (masked_hamming_top2)
// it serves the dense-mask matchers: reference-keyframe tracking
// (match_brute_force), monocular initialization (match_for_initialization)
// and, with a leading batch axis, the mapper's triangulation matcher over
// neighbour pairs (match_for_triangulation in fused_triangulation_jit,
// the row descriptors shared) and relocalization over candidate keyframes
// (match_brute_force_many, the column descriptors shared).
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
// ~0.2 MB in and out at [2048, 1000] and does ~8 operations per window
// test of a valid row and ~24 per candidate pair; the stereo band ~0.13
// MB and ~16 M operations for 1000 x 1000 keypoints both ways. Each is a
// few microseconds of latency-bound work.
//
// K6's design. A block of ROWS rows, WPR warps each, stages the column
// table in dynamic shared memory, CHUNK columns at a time (one pass at the
// main paths' N = 1000, 45 KB; larger N loops over chunks with the same
// code), as structure of arrays: positions with the valid flag folded into
// x (an invalid column's x is NaN, which no window holds, so no octave
// sentinel can collide with a caller's band), octaves, and the descriptors
// word-major with a row stride of cap + 4 words, so that the 16-byte
// loads of a column's descriptor store without bank conflicts and
// consecutive lanes read consecutive columns without them. A thread
// issues all its staging loads before its stores (one trip to L2 for up
// to 1024 columns). The warps of a row then test alternate runs of 32
// columns from shared memory and read a descriptor only for a candidate;
// a lane keeps candidate keys only, the warps merge theirs through shared
// memory, and the index fallbacks are filled in after the merge. A row
// whose valid flag is clear scans nothing and writes (BIG, 0, BIG,
// min(1, N - 1)); a block none of whose rows is valid stages nothing. Two
// windows share the scan: the wider of the two radii filters, then each
// window's own test picks the lane's (k1, k2) pair it goes to, so each
// window is exact for any two radii. On an H100 80GB HBM3 at 700 W
// (scripts/kernel_variants.py matching-k6) the monocular pair's two
// launches take 0.0093 ms: 5.7 us with two windows over 1024 rows, 3.6 us
// over 2048 rows of which 118 are valid, 1.8 us when no row is valid.
// The earlier design, one warp per row striding over the columns in
// global memory, waited on a chain of dependent loads in every iteration
// and ran its whole loop for invalid rows: 0.0310 ms for its three
// launches. 1 or 4 warps per row, 4 or 16 rows per block, 512-column
// chunks, staging by the bulk-copy engine (0.0105-0.0110 ms) and staging
// no descriptors, reading a candidate's from L2 (0.0100-0.0103 ms), were
// slower.
//
// K7 on the band. Rows 0..N_l-1 are left keypoints (columns: the right
// ones), the rest right keypoints (columns: the left ones under the
// transposed test), each block of BAND_ROWS rows x BAND_WPR warps on one
// side. A block stages its side's column table in dynamic shared memory,
// 16 bytes a column (x, NaN where the column is invalid, y, the octave's
// bits, 2 scale for left columns), tests the band there and reads a
// candidate's descriptor from L2 as two 16-byte loads; the keys, the
// merge and the index fallbacks are K6's. So neither the [N_l, N_r] mask
// nor its transpose exists. On an H100 80GB HBM3 at 700 W
// (scripts/kernel_variants.py matching-k7) the stereo pair's launch takes
// 0.0063 ms, against 0.0207 ms for the two launches under the mask that
// it replaces (which also needed ~17 operations to build the mask and a
// transpose copy); 1 or 4 warps per row (0.0081, 0.0088 ms) and 4 rows
// per block (0.0104 ms) were slower, 16 rows per block level
// (0.0061-0.0063 ms).
//
// Batches. Both K6 and K7 under a mask take a leading batch axis: the
// grid's y index is the problem, whose rows, columns, mask and outputs sit
// at its own offsets (the row descriptors may be shared by every
// problem: the mapper's fuse pass projects one keyframe's points into B
// target keyframes, and its triangulation matcher matches one keyframe's
// features against B neighbours). One launch serves all B problems; a problem's
// blocks run exactly the code of a launch of that problem alone, so each
// result is bit-identical to it, and the single-problem launches are
// batches of one. On an H100 80GB HBM3 at 700 W (chip_smoke.py, the
// System's recorded calls) a batched K7 launch over 4-8 neighbour pairs of
// [1000, 1000] masks takes ~0.009 ms, and a batched K6 launch over 4
// targets of 1024 points against 1000 keypoints ~0.010 ms.
//
// K7 under a mask: one warp per row, 8 rows per block. The row's
// descriptor lives in registers; lanes stride over the N columns, so the
// row's mask bytes are read coalesced, and a column's 32 descriptor bytes
// are read only when it is a candidate (__popc on the 8 XORed words). Each
// lane keeps its two smallest keys; five shuffle rounds merge them across
// the warp. Only the 4 x M results reach memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                  // K7's rows per block
constexpr int ROWS = 8;                   // K6's rows per block
constexpr int WPR = 2;                    // K6's warps per row
constexpr int THREADS = ROWS * WPR * 32;  // K6's block
constexpr int CHUNK = 2048;               // K6's columns staged per pass
constexpr int ROUND = 1024;               // K6's columns staged per round of loads
constexpr int BAND_ROWS = 8;              // K7 band's rows per block
constexpr int BAND_WPR = 2;               // K7 band's warps per row
constexpr int BAND_THREADS = BAND_ROWS * BAND_WPR * 32;
constexpr int BAND_CHUNK = 2048;          // K7 band's columns staged per pass
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

// Merge each lane's two smallest keys across the warp (every lane ends
// with the warp's two).
__device__ __forceinline__ void warp_merge(unsigned& k1, unsigned& k2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    const unsigned lo1 = min(k1, o1);
    const unsigned hi1 = max(k1, o1);
    k2 = min(hi1, min(k2, o2));
    k1 = lo1;
  }
}

// Decode a row's two keys into out[0..3][row] of an out with m rows.
__device__ __forceinline__ void store_top2(unsigned k1, unsigned k2, int row, int m,
                                           int n, int* out) {
  const unsigned d1 = k1 >> COL_BITS, d2 = k2 >> COL_BITS;
  out[row] = d1 >= EMPTY ? BIG : (int)d1;
  out[m + row] = min((int)(k1 & COL_MASK), n - 1);
  out[2 * m + row] = d2 >= EMPTY ? BIG : (int)d2;
  out[3 * m + row] = min((int)(k2 & COL_MASK), n - 1);
}

// Copy columns [c0, c0 + cw) of the column table into shared memory,
// ROUND columns per round: a thread issues every load of a round before
// its first store, so a round costs one trip to L2 (a strided loop whose
// trip count differs between threads left its last warps several trips).
__device__ __forceinline__ void stage_columns(
    const uint4* __restrict__ desc_b, const float2* __restrict__ xy_b,
    const int* __restrict__ octave_b, const uint8_t* __restrict__ valid_b,
    int c0, int cw, int stride, float2* sxy, int* soct, unsigned* sdesc) {
  constexpr int DPT = 2 * ROUND / THREADS, CPT = ROUND / THREADS;
  const uint4* d = desc_b + 2 * (size_t)c0;
  for (int base = 0; base < cw; base += ROUND) {
    uint4 w[DPT];
    float2 p[CPT];
    int oc[CPT];
    bool ok[CPT];
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      const int q = 2 * base + threadIdx.x + k * THREADS;
      if (q < 2 * cw) w[k] = __ldg(d + q);
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = base + threadIdx.x + k * THREADS;
      if (c < cw) {
        p[k] = __ldg(xy_b + c0 + c);
        oc[k] = __ldg(octave_b + c0 + c);
        ok[k] = __ldg(valid_b + c0 + c) != 0;
      }
    }
#pragma unroll
    for (int k = 0; k < DPT; ++k) {
      const int q = 2 * base + threadIdx.x + k * THREADS;
      if (q < 2 * cw) {
        unsigned* s = sdesc + (q & 1) * 4 * stride + (q >> 1);
        s[0] = w[k].x;
        s[stride] = w[k].y;
        s[2 * stride] = w[k].z;
        s[3 * stride] = w[k].w;
      }
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = base + threadIdx.x + k * THREADS;
      if (c < cw) {
        sxy[c] = make_float2(ok[k] ? p[k].x : __int_as_float(0x7fc00000), p[k].y);
        soct[c] = oc[k];
      }
    }
  }
}

// NW windows: radius (and radius2 when NW == 2). out: [NW, 4, m].
template <int NW>
__global__ void __launch_bounds__(THREADS) projection_top2_kernel(
    const int* __restrict__ desc_a, const float2* __restrict__ proj,
    const float* __restrict__ radius, const float* __restrict__ radius2,
    const int* __restrict__ oct_lo, const int* __restrict__ oct_hi,
    const uint8_t* __restrict__ valid_a, int m, const uint4* __restrict__ desc_b,
    const float2* __restrict__ xy_b, const int* __restrict__ octave_b,
    const uint8_t* __restrict__ valid_b, int n, int cap, long long a_bstride,
    int* __restrict__ out) {
  // Problem blockIdx.y of a batch: its rows, columns and outputs.
  {
    const size_t b = blockIdx.y;
    desc_a += b * a_bstride;
    proj += b * m;
    radius += b * m;
    if constexpr (NW == 2) radius2 += b * m;
    oct_lo += b * m;
    oct_hi += b * m;
    valid_a += b * m;
    desc_b += b * 2 * (size_t)n;
    xy_b += b * n;
    octave_b += b * n;
    valid_b += b * n;
    out += b * NW * 4 * (size_t)m;
  }
  extern __shared__ uint4 smem[];
  float2* sxy = reinterpret_cast<float2*>(smem);
  int* soct = reinterpret_cast<int*>(sxy + cap);
  unsigned* sdesc = reinterpret_cast<unsigned*>(soct + cap);
  const int stride = cap + 4;
  // Each row's part (one warp's) two smallest keys per window.
  __shared__ uint2 parts[ROWS][WPR][NW];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int part = warp % WPR;
  const int row = blockIdx.x * ROWS + warp / WPR;
  const bool active = row < m && valid_a[row] != 0;

  unsigned k1[NW], k2[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) k1[w] = k2[w] = NO_KEY;

  if (__syncthreads_or(active)) {
    unsigned a[WORDS] = {};
    float2 uv = make_float2(0.f, 0.f);
    float r[NW] = {};
    int lo = 0, hi = 0;
    if (active) {
#pragma unroll
      for (int w = 0; w < WORDS; ++w) a[w] = (unsigned)__ldg(desc_a + (size_t)row * WORDS + w);
      uv = __ldg(proj + row);
      r[0] = __ldg(radius + row);
      if constexpr (NW == 2) r[1] = __ldg(radius2 + row);
      lo = __ldg(oct_lo + row);
      hi = __ldg(oct_hi + row);
    }
    // A column in either window passes this test (fmaxf drops a NaN radius,
    // whose window holds nothing).
    float r_any = r[0];
    if constexpr (NW == 2) r_any = fmaxf(r[0], r[1]);

    for (int c0 = 0; c0 < n; c0 += cap) {
      const int cw = min(cap, n - c0);
      if (c0) __syncthreads();   // every warp is done with the last chunk
      stage_columns(desc_b, xy_b, octave_b, valid_b, c0, cw, stride, sxy, soct, sdesc);
      __syncthreads();
      if (!active) continue;
#pragma unroll 4
      for (int j = part * 32 + lane; j < cw; j += WPR * 32) {
        const float2 p = sxy[j];
        const float dx = fabsf(uv.x - p.x), dy = fabsf(uv.y - p.y);
        const int oc = soct[j];
        if (dx <= r_any && dy <= r_any && oc >= lo && oc <= hi) {
          unsigned d = 0;
#pragma unroll
          for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ sdesc[w * stride + j]);
          const unsigned key = (d << COL_BITS) | (unsigned)(c0 + j);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            if (NW == 1 || (dx <= r[w] && dy <= r[w])) insert(key, k1[w], k2[w]);
          }
        }
      }
    }
  }
  // Merge the warp's keys, then the row's parts into part 0.
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    warp_merge(k1[w], k2[w]);
    if (lane == 0) parts[warp / WPR][part][w] = make_uint2(k1[w], k2[w]);
  }
  __syncthreads();
  if (row >= m || part != 0) return;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int p = 1; p < WPR; ++p) {
      const uint2 o = parts[warp / WPR][p][w];
      insert(o.x, k1[w], k2[w]);
      insert(o.y, k1[w], k2[w]);
    }
    // Fewer than two candidates: the lowest non-candidate columns, as the
    // Pallas kernels' reduction over every column gives them.
    if (k1[w] == NO_KEY) k1[w] = EMPTY << COL_BITS;
    if (k2[w] == NO_KEY) k2[w] = (EMPTY << COL_BITS) | ((k1[w] & COL_MASK) == 0u ? 1u : 0u);
    if (lane == 0) store_top2(k1[w], k2[w], row, m, n, out + (size_t)w * 4 * m);
  }
}

// Columns [c0, c0 + cw) of one side of a stereo pair into shared memory,
// one float4 per column: x (NaN where the column is invalid), y, the
// octave's bits and 2 * scale (0 where scale is null). Every load of the
// pass is issued before the first store.
__device__ __forceinline__ void stage_band_columns(
    const float2* __restrict__ xy, const int* __restrict__ octave,
    const float* __restrict__ scale, const uint8_t* __restrict__ valid, int c0,
    int cw, float4* scol) {
  constexpr int CPT = BAND_CHUNK / BAND_THREADS;
  float2 p[CPT];
  int oc[CPT];
  float s[CPT];
  bool ok[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * BAND_THREADS;
    if (c < cw) {
      p[k] = __ldg(xy + c0 + c);
      oc[k] = __ldg(octave + c0 + c);
      s[k] = scale ? __ldg(scale + c0 + c) : 0.f;
      ok[k] = __ldg(valid + c0 + c) != 0;
    }
  }
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * BAND_THREADS;
    if (c < cw) {
      scol[c] = make_float4(ok[k] ? p[k].x : __int_as_float(0x7fc00000), p[k].y,
                            __int_as_float(oc[k]), 2.f * s[k]);
    }
  }
}

// One block of K7 band rows. LEFT: rows are left keypoints and columns
// right ones (scale: the rows' scale factors); else rows are right
// keypoints and columns left ones (scale: the columns'). Row `row` of
// this side is row `row0 + row` of out ([4, m_all]).
template <bool LEFT>
__device__ __forceinline__ void band_block(
    int r0, int m, const uint4* __restrict__ desc_a, const float2* __restrict__ xy_a,
    const int* __restrict__ octave_a, const uint8_t* __restrict__ valid_a,
    const uint4* __restrict__ desc_b, const float2* __restrict__ xy_b,
    const int* __restrict__ octave_b, const uint8_t* __restrict__ valid_b, int n,
    const float* __restrict__ scale, float max_d, int cap, int row0, int m_all,
    float4* scol, uint2 (*parts)[BAND_WPR], int* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int part = warp % BAND_WPR;
  const int row = r0 + warp / BAND_WPR;
  const bool active = row < m && valid_a[row] != 0;

  unsigned k1 = NO_KEY, k2 = NO_KEY;
  if (__syncthreads_or(active)) {
    unsigned a[WORDS] = {};
    float2 xy = make_float2(0.f, 0.f);
    float s2 = 0.f;
    int o = 0;
    if (active) {
      const uint4 q0 = __ldg(desc_a + 2 * (size_t)row), q1 = __ldg(desc_a + 2 * (size_t)row + 1);
      a[0] = q0.x; a[1] = q0.y; a[2] = q0.z; a[3] = q0.w;
      a[4] = q1.x; a[5] = q1.y; a[6] = q1.z; a[7] = q1.w;
      xy = __ldg(xy_a + row);
      o = __ldg(octave_a + row);
      if (LEFT) s2 = 2.f * __ldg(scale + row);
    }
    for (int c0 = 0; c0 < n; c0 += cap) {
      const int cw = min(cap, n - c0);
      if (c0) __syncthreads();   // every warp is done with the last chunk
      stage_band_columns(xy_b, octave_b, LEFT ? nullptr : scale, valid_b, c0, cw, scol);
      __syncthreads();
      if (!active) continue;
#pragma unroll 4
      for (int j = part * 32 + lane; j < cw; j += BAND_WPR * 32) {
        const float4 c = scol[j];
        const int oc = __float_as_int(c.z);
        // The stereo matcher's candidate test, in its own float32 terms
        // (|y_l - y_r| <= 2 scale_l, octave_l +- 1, -2 <= x_l - x_r <= max_d);
        // an invalid column's NaN x fails both disparity tests.
        bool pass;
        if (LEFT) {
          const float d = xy.x - c.x;
          pass = fabsf(xy.y - c.y) <= s2 && oc >= o - 1 && oc <= o + 1 && d >= -2.f &&
                 d <= max_d;
        } else {
          const float d = c.x - xy.x;
          pass = fabsf(c.y - xy.y) <= c.w && o >= oc - 1 && o <= oc + 1 && d >= -2.f &&
                 d <= max_d;
        }
        if (pass) {
          const uint4 q0 = __ldg(desc_b + 2 * (size_t)(c0 + j));
          const uint4 q1 = __ldg(desc_b + 2 * (size_t)(c0 + j) + 1);
          const unsigned d = __popc(a[0] ^ q0.x) + __popc(a[1] ^ q0.y) +
                             __popc(a[2] ^ q0.z) + __popc(a[3] ^ q0.w) +
                             __popc(a[4] ^ q1.x) + __popc(a[5] ^ q1.y) +
                             __popc(a[6] ^ q1.z) + __popc(a[7] ^ q1.w);
          insert((d << COL_BITS) | (unsigned)(c0 + j), k1, k2);
        }
      }
    }
  }
  // Merge the warp's keys, then the row's parts into part 0.
  warp_merge(k1, k2);
  if (lane == 0) parts[warp / BAND_WPR][part] = make_uint2(k1, k2);
  __syncthreads();
  if (row >= m || part != 0) return;
#pragma unroll
  for (int p = 1; p < BAND_WPR; ++p) {
    const uint2 o = parts[warp / BAND_WPR][p];
    insert(o.x, k1, k2);
    insert(o.y, k1, k2);
  }
  if (k1 == NO_KEY) k1 = EMPTY << COL_BITS;
  if (k2 == NO_KEY) k2 = (EMPTY << COL_BITS) | ((k1 & COL_MASK) == 0u ? 1u : 0u);
  if (lane == 0) store_top2(k1, k2, row0 + row, m_all, n, out);
}

// K7 on the stereo band: left rows (blocks [0, ceil(nl / BAND_ROWS))),
// then right rows. out: [4, nl + nr].
__global__ void __launch_bounds__(BAND_THREADS) stereo_band_top2_kernel(
    const uint4* __restrict__ desc_l, const float2* __restrict__ xy_l,
    const int* __restrict__ octave_l, const float* __restrict__ scale_l,
    const uint8_t* __restrict__ valid_l, int nl, const uint4* __restrict__ desc_r,
    const float2* __restrict__ xy_r, const int* __restrict__ octave_r,
    const uint8_t* __restrict__ valid_r, int nr, float max_d, int cap,
    int* __restrict__ out) {
  extern __shared__ float4 scol[];
  __shared__ uint2 parts[BAND_ROWS][BAND_WPR];
  const int left_blocks = (nl + BAND_ROWS - 1) / BAND_ROWS;
  if ((int)blockIdx.x < left_blocks) {
    band_block<true>(blockIdx.x * BAND_ROWS, nl, desc_l, xy_l, octave_l, valid_l, desc_r,
                     xy_r, octave_r, valid_r, nr, scale_l, max_d, cap, 0, nl + nr, scol,
                     parts, out);
  } else {
    band_block<false>((blockIdx.x - left_blocks) * BAND_ROWS, nr, desc_r, xy_r, octave_r,
                      valid_r, desc_l, xy_l, octave_l, valid_l, nl, scale_l, max_d, cap,
                      nl, nl + nr, scol, parts, out);
  }
}

__global__ void masked_top2_kernel(
    const int* __restrict__ desc_a, long long a_bstride, int m,
    const int* __restrict__ desc_b, long long b_bstride, int n,
    const uint8_t* __restrict__ mask, int* __restrict__ out) {
  // Problem blockIdx.y of a batch: desc_a's rows a_bstride and desc_b's
  // columns b_bstride ints apart (0: shared by the problems), under
  // [B, M, N] -> out [B, 4, M].
  {
    const size_t b = blockIdx.y;
    desc_a += b * a_bstride;
    desc_b += b * b_bstride;
    mask += b * m * (size_t)n;
    out += b * 4 * (size_t)m;
  }
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
  warp_merge(k1, k2);
  if (lane == 0) store_top2(k1, k2, row, m, n, out);
}

}  // namespace

// radius2: null for one window (out [batch, 4, m]), else the second
// window's radii (out [batch, 2, 4, m]). Row tensors [batch, m, ...]
// except desc_a, whose problems lie a_bstride ints apart (0: shared);
// column tensors [batch, n, ...]. desc_b must be 16-byte and proj, xy_b
// 8-byte aligned.
extern "C" int projection_top2_launch(
    const void* desc_a, long long a_bstride, const void* proj, const void* radius,
    const void* radius2, const void* oct_lo, const void* oct_hi, const void* valid_a,
    int m, const void* desc_b, const void* xy_b, const void* octave_b,
    const void* valid_b, int n, int batch, void* out, void* stream) {
  const int cap = min((n + 31) / 32 * 32, CHUNK);
  const size_t smem = (size_t)cap * (sizeof(float2) + sizeof(int)) +
                      (size_t)(cap + 4) * WORDS * sizeof(unsigned);
  auto kernel = radius2 ? projection_top2_kernel<2> : projection_top2_kernel<1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + ROWS - 1) / ROWS, batch);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)desc_a, (const float2*)proj, (const float*)radius,
      (const float*)radius2, (const int*)oct_lo, (const int*)oct_hi,
      (const uint8_t*)valid_a, m, (const uint4*)desc_b, (const float2*)xy_b,
      (const int*)octave_b, (const uint8_t*)valid_b, n, cap, a_bstride, (int*)out);
  return (int)cudaGetLastError();
}

// desc_l, desc_r must be 16-byte and xy_l, xy_r 8-byte aligned; max_d is
// the float32 value the disparity is compared with.
extern "C" int stereo_band_top2_launch(
    const void* desc_l, const void* xy_l, const void* octave_l, const void* scale_l,
    const void* valid_l, int nl, const void* desc_r, const void* xy_r,
    const void* octave_r, const void* valid_r, int nr, float max_d, void* out,
    void* stream) {
  const int cap = min((max(nl, nr) + 31) / 32 * 32, BAND_CHUNK);
  const size_t smem = (size_t)cap * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stereo_band_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (nl + BAND_ROWS - 1) / BAND_ROWS + (nr + BAND_ROWS - 1) / BAND_ROWS;
  stereo_band_top2_kernel<<<blocks, BAND_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint4*)desc_l, (const float2*)xy_l, (const int*)octave_l,
      (const float*)scale_l, (const uint8_t*)valid_l, nl, (const uint4*)desc_r,
      (const float2*)xy_r, (const int*)octave_r, (const uint8_t*)valid_r, nr, max_d, cap,
      (int*)out);
  return (int)cudaGetLastError();
}

// batch problems: desc_a [m, 8] per problem, a_bstride ints apart, desc_b
// [n, 8] per problem, b_bstride ints apart (0: shared), mask [batch, m, n]
// -> out [batch, 4, m].
extern "C" int masked_top2_launch(
    const void* desc_a, long long a_bstride, int m, const void* desc_b,
    long long b_bstride, int n, const void* mask, int batch, void* out, void* stream) {
  const dim3 grid((m + WARPS - 1) / WARPS, batch);
  masked_top2_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)desc_a, a_bstride, m, (const int*)desc_b, b_bstride, n,
      (const uint8_t*)mask, (int*)out);
  return (int)cudaGetLastError();
}
