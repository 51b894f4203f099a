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
// left. Under a candidate test (candidate_top2_kernel), one blocked kernel
// with the test compiled in: T_MASK, a caller-supplied [M, N] bool mask
// (masked_hamming_top2, the Pallas kernel's exact counterpart, no caller
// on the main paths); T_FLAGS, row flag x column flag (valid_hamming_top2:
// match_brute_force for reference-keyframe tracking, for relocalization
// over candidate keyframes, the column table shared, and for loop
// closing over its candidates, the row table shared); T_WINDOW, the flags
// and |dx|, |dy| <= r (window_hamming_top2: match_for_initialization);
// T_EPIPOLAR, the flags and ((l0 x + l1 y) + l2)^2 / den < thr
// (epipolar_hamming_top2: the mapper's match_for_triangulation over B
// neighbour pairs, the row table shared). So none of these callers builds
// a [B, M, N] mask on the card.
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
// Batches. Both K6 and K7 under a candidate test take a leading batch
// axis: the grid's y index is the problem, whose rows, columns and
// outputs sit at its own offsets (any table may be shared by every
// problem: the mapper's fuse pass projects one keyframe's points into B
// target keyframes, its triangulation matcher matches one keyframe's
// features against B neighbours, relocalization B candidate keyframes
// against one frame). One launch serves all B problems; a problem's blocks
// run exactly the code of a launch of that problem alone, so each result
// is bit-identical to it, and the single-problem launches are batches of
// one. A batched K6 launch over 4 targets of 1024 points against 1000
// keypoints takes ~0.010 ms (H100 80GB HBM3, 700 W, chip_smoke.py).
//
// K7 under a candidate test. Unlike K6's, its validity product is a dense
// popcount product: at 8 popcounts a pair on CUDA cores (16 a clock per
// SM, 4.1 T/s measured) relocalization's [8, 2000, 1000] alone is ~30 us
// of popcounts, and the test of the sparse callers (the epipolar band,
// the window) costs more than the distance. So a block of 16 rows runs 8
// warps on them, each on every eighth 8-column tile of the staged columns
// (two tiles a trip): the tensor cores' 1-bit product (mma.sync
// m16n8k256 .b1, AND + popcount, 10.3 P bit operations/s measured) gives
// popc(a & b) for a 16 x 8 tile, and d = popc(a) + popc(b) - 2 popc(a & b)
// with each descriptor's popcount taken once (the rows' from the A
// fragment, the columns' when staged). The block stages only the columns
// whose flag is set (every column under T_MASK), packed in shared memory
// with their key base (pb << COL_BITS | column) and the test's values, a
// chunk of MT_CHUNK columns at a time (any N < 2^23). A lane's four pairs a
// tile (rows g, g + 8; columns 2t, 2t + 1) each get a key
// (pa + pb - 2 popc) << COL_BITS | column, ORed with all ones where the
// row's flag is clear or the test fails; the test runs for every pair
// without a branch, in the mask's float32 operations, and the epipolar one
// divides only within 2^-20 of the band's edge. The keys are merged by
// the quad, then by the row's 8 warps through shared memory; the index
// fallbacks are filled in after the merge, as K6's. A 16-row tile with no
// flag set scans nothing, and a block none of whose rows has one stages
// nothing. What bounds it: the per-pair epilogue (key, flags, test,
// top-2 insert), ~10-25 instructions a pair, run by too few warps at the
// callers' sizes (1000-2000 rows, 1-8 problems): latency more than
// operations; the product itself is ~1% of the time.
// On an H100 80GB HBM3 at 700 W (scripts/kernel_variants.py matching-k7m,
// device-busy ms of each caller's recorded calls, median of 4 in turns;
// the previous design, one warp a row under the caller's mask built
// beforehand, in brackets):
// reference keyframe 0.0050 (0.0150), initialization (3 calls) 0.0189
// (0.0356), relocalization [8, 2000, 1000] 0.0131 (0.0558), BoW
// relocalization 0.0085 (0.0330), loop candidates 0.0050 (0.0150);
// triangulation (4 calls) 0.0286 of kernel (0.0387), plus its lines'
// PyTorch operations. Slower: popcounts on CUDA cores (design (a), 8 a
// pair; relocalization 0.0246, reference keyframe 0.0083); 4 warps on the
// 16 rows (0.0072, 0.0281 initialization) and 16 (relocalization 0.0201:
// a block of 512 threads leaves too few blocks resident); 32, 64 and 128
// rows a block (too few blocks at 1000-2000 rows: 0.0067-0.0144 reference
// keyframe) and two 16-row tiles a warp (0.0207); 512-column chunks
// (0.0059); one tile a trip (triangulation 0.0811 against 0.0799 a call);
// the test behind a branch, run only where the key would enter the top-2
// (0.0848); B fragments read from L1/L2 in place of staged (0.0053);
// 2048-column chunks tie (initialization 0.0180, one pass over its 2000
// columns, but twice the shared memory). K7 under a caller's mask reads a
// mask byte per pair, four from each of eight rows a tile, and is slower
// than the previous design on the triangulation masks (0.0803 against
// 0.0390);
// it has no caller on the main paths. ptxas takes wgmma's 1-bit form
// (m64nNk256 .b1 .and.popc) for sm_90a: a later step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;                   // K6's rows per block
constexpr int WPR = 2;                    // K6's warps per row
constexpr int THREADS = ROWS * WPR * 32;  // K6's block
constexpr int CHUNK = 2048;               // K6's columns staged per pass
constexpr int ROUND = 1024;               // K6's columns staged per round of loads
constexpr int BAND_ROWS = 8;              // K7 band's rows per block
constexpr int BAND_WPR = 2;               // K7 band's warps per row
constexpr int BAND_THREADS = BAND_ROWS * BAND_WPR * 32;
constexpr int BAND_CHUNK = 2048;          // K7 band's columns staged per pass
constexpr int MT_WARPS = 8;               // K7 under a test: warps per block,
constexpr int MT_WPR = 8;                 // warps sharing 16 x MT_RT rows,
constexpr int MT_RT = 1;                  // 16-row tiles per warp
constexpr int MT_THREADS = MT_WARPS * 32;
constexpr int MT_ROWS = MT_WARPS / MT_WPR * 16 * MT_RT;
constexpr int MT_CHUNK = 1024;            // its columns staged per pass
constexpr int MT_ROUND = 4 * MT_THREADS;  // its columns staged per round of loads
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

// ---------------------------------------------------------------------------
// K7 under a candidate test: one blocked kernel, the test compiled in.
// ---------------------------------------------------------------------------

enum Test { T_MASK = 0, T_FLAGS = 1, T_WINDOW = 2, T_EPIPOLAR = 3 };

// Which tables carry a batch axis (bit set) or are shared by the
// problems (clear). The mask always has one.
enum Batched : unsigned {
  B_DESC_A = 1, B_ROW_OK = 2, B_ROW_V = 4, B_DEN = 8,
  B_DESC_B = 16, B_COL_OK = 32, B_COL_XY = 64, B_THR = 128,
};

struct TestArgs {
  const unsigned* desc_a;   // [M, 8]
  const uint4* desc_b;      // [N, 8] as two 16-byte words a column
  const uint8_t* mask;      // T_MASK: [M, N]
  const uint8_t* row_ok;    // T_FLAGS, T_WINDOW, T_EPIPOLAR: [M]
  const uint8_t* col_ok;    // [N]
  const float* row_v;       // T_WINDOW: [M, 2] (x, y); T_EPIPOLAR: [M, 3] line
  const float* den;         // T_EPIPOLAR: [M] clamped l0^2 + l1^2
  const float2* col_xy;     // T_WINDOW, T_EPIPOLAR: [N]
  const float* thr;         // T_EPIPOLAR: [N] 3.84 sigma2
  float r;                  // T_WINDOW: the window's half size
  int m, n;
  unsigned batched;         // Batched bits
  int* out;                 // [B, 4, M]
};

// Problem b's tables.
__device__ __forceinline__ TestArgs problem(TestArgs p, size_t b) {
  const size_t m = p.m, n = p.n;
  auto off = [&](unsigned bit, size_t per) { return (p.batched & bit) ? b * per : 0; };
  p.desc_a += off(B_DESC_A, 8 * m);
  p.desc_b += off(B_DESC_B, 2 * n);
  if (p.mask) p.mask += b * m * n;
  if (p.row_ok) p.row_ok += off(B_ROW_OK, m);
  if (p.col_ok) p.col_ok += off(B_COL_OK, n);
  if (p.row_v) p.row_v += off(B_ROW_V, (p.den ? 3 : 2) * m);
  if (p.den) p.den += off(B_DEN, m);
  if (p.col_xy) p.col_xy += off(B_COL_XY, n);
  if (p.thr) p.thr += off(B_THR, n);
  p.out += b * 4 * m;
  return p;
}

// c[2h + e] = popcount(row_h & column_e) over the 256 bits, for a 16-row
// tile's rows g + 8h and an 8-column tile's columns 2t + e (g = lane / 4,
// t = lane % 4): the tensor cores' 1-bit product. a: the rows' A fragment
// (words t and t + 4 of rows g and g + 8), b0, b1: words t and t + 4 of
// column g.
__device__ __forceinline__ void and_popc(const unsigned (&a)[4], unsigned b0, unsigned b1,
                                         int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// The candidate columns of [c0, c0 + cw) of problem p (their flag set;
// every column under T_MASK) into shared memory, packed in slots 0, 1, ...
// in no fixed order (a warp's in column order, warps by an atomic count),
// then empty slots up to a multiple of 8: each column's descriptor as four
// (word t, word t + 4) pairs (a warp reads an 8-slot tile's B fragments as
// 256 consecutive bytes), its key base (popcount << COL_BITS | column:
// a key carries its own column, so the order of the slots changes no
// result) and its mask (0, all ones for an empty slot), and the test's
// coordinates and threshold. Every load of a round is issued before its
// first store. -> the count of slots (a multiple of 8).
template <int T>
__device__ __forceinline__ int stage_tested_columns(
    const TestArgs& p, int c0, int cw, uint2* sdesc, uint2* scol, float2* sxy, float* sthr,
    int* count) {
  constexpr int CPT = MT_ROUND / MT_THREADS;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  for (int base = 0; base < cw; base += MT_ROUND) {
    uint4 w0[CPT], w1[CPT];
    bool ok[CPT];
    float2 xy[CPT];
    float th[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = base + threadIdx.x + k * MT_THREADS;
      ok[k] = j < cw && (T == T_MASK || __ldg(p.col_ok + c0 + j) != 0);
      if (ok[k]) {
        w0[k] = __ldg(p.desc_b + 2 * (size_t)(c0 + j));
        w1[k] = __ldg(p.desc_b + 2 * (size_t)(c0 + j) + 1);
        if (T == T_WINDOW || T == T_EPIPOLAR) xy[k] = __ldg(p.col_xy + c0 + j);
        if (T == T_EPIPOLAR) th[k] = __ldg(p.thr + c0 + j);
      }
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const unsigned vote = __ballot_sync(0xffffffffu, ok[k]);
      int slot = 0;
      if (lane == 0 && vote) slot = atomicAdd(count, __popc(vote));
      slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(vote & ((1u << lane) - 1u));
      if (!ok[k]) continue;
      const unsigned pb = __popc(w0[k].x) + __popc(w0[k].y) + __popc(w0[k].z) +
                          __popc(w0[k].w) + __popc(w1[k].x) + __popc(w1[k].y) +
                          __popc(w1[k].z) + __popc(w1[k].w);
      uint4* d = reinterpret_cast<uint4*>(sdesc + 4 * slot);
      d[0] = make_uint4(w0[k].x, w1[k].x, w0[k].y, w1[k].y);
      d[1] = make_uint4(w0[k].z, w1[k].z, w0[k].w, w1[k].w);
      const int c = c0 + base + threadIdx.x + k * MT_THREADS;
      scol[slot] = make_uint2((pb << COL_BITS) | (unsigned)c, 0u);
      if (T == T_WINDOW || T == T_EPIPOLAR) sxy[slot] = xy[k];
      if (T == T_EPIPOLAR) sthr[slot] = th[k];
    }
  }
  __syncthreads();
  const int n = *count, padded = (n + 7) / 8 * 8;
  if ((int)threadIdx.x < padded - n) {
    uint4* d = reinterpret_cast<uint4*>(sdesc + 4 * (n + threadIdx.x));
    d[0] = d[1] = make_uint4(0u, 0u, 0u, 0u);
    scol[n + threadIdx.x] = make_uint2(0u, NO_KEY);
  }
  return padded;
}

// The test of a pair beyond both flags (the row's values v, the column's
// coordinates xy and threshold thr), in the float32 operations and order
// of the mask it replaces, without a branch -> 1 (a candidate), 0 (not)
// or -1 (exact_test decides: the mask byte, or the division near the
// band's edge; sq: the epipolar distance's numerator).
template <int T>
__device__ __forceinline__ int pair_verdict(const float (&v)[4], float2 xy, float thr,
                                            float r, float& sq) {
  if (T == T_WINDOW)
    return fabsf(__fsub_rn(v[0], xy.x)) <= r && fabsf(__fsub_rn(v[1], xy.y)) <= r;
  if (T == T_EPIPOLAR) {
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(v[0], xy.x), __fmul_rn(v[1], xy.y)), v[2]);
    sq = __fmul_rn(num, num);
    // sq / den < thr without the division where sq lies clear of thr den:
    // each rounding moves a side by at most 2^-24, well inside the 2^-20
    // margins, so fl(sq / den) < thr holds below the first and fails above
    // the second. A td outside [1e-30, FLT_MAX] (subnormal, inf or NaN)
    // takes the division.
    const float td = __fmul_rn(thr, v[3]);
    if (!(td >= 1e-30f && td <= 3.4028235e38f)) return -1;
    if (sq < __fmul_rn(td, 0.99999905f)) return 1;    // 1 - 2^-20
    return sq > __fmul_rn(td, 1.00000095f) ? 0 : -1;  // 1 + 2^-20
  }
  return T == T_MASK ? -1 : 1;
}

// The exact test of a pair (row, column c) whose verdict was -1.
template <int T>
__device__ __forceinline__ bool exact_test(const TestArgs& p, int row, int c, float sq,
                                           float den, float thr) {
  if (T == T_MASK) return __ldg(p.mask + (size_t)row * p.n + c) != 0;
  return __fdiv_rn(sq, den) < thr;
}

// A block of MT_ROWS rows: MT_WARPS / MT_WPR groups of MT_WPR warps, a
// group on 16 x MT_RT rows, its warps on alternate 8-column tiles. Lane
// (g, t) keeps the two smallest candidate keys of rows g and g + 8 of each
// of its warp's 16-row tiles, over columns 2t and 2t + 1 of each tile.
template <int T>
__global__ void __launch_bounds__(MT_THREADS) candidate_top2_kernel(TestArgs p, int cap) {
  p = problem(p, blockIdx.y);
  extern __shared__ uint4 smem[];
  uint2* sdesc = reinterpret_cast<uint2*>(smem);
  uint2* scol = sdesc + 4 * cap;
  float2* sxy = reinterpret_cast<float2*>(scol + cap);
  float* sthr = reinterpret_cast<float*>(sxy + cap);
  // Each warp's keys of its rows, for the merge of a group's warps; the
  // count of staged columns.
  __shared__ uint2 parts[MT_WARPS][16 * MT_RT];
  __shared__ int count;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int part = warp % MT_WPR;
  const int r0 = blockIdx.x * MT_ROWS + warp / MT_WPR * 16 * MT_RT;
  const int m = p.m, n = p.n;

  unsigned a[MT_RT][4];
  unsigned row_base[2 * MT_RT], row_mask[2 * MT_RT], k1[2 * MT_RT], k2[2 * MT_RT];
  float v[2 * MT_RT][4];
  bool live[MT_RT];
  bool any = false;
#pragma unroll
  for (int q = 0; q < 2 * MT_RT; ++q) {
    const int row = r0 + 16 * (q / 2) + g + 8 * (q % 2);
    const bool in = row < m;
    const bool ok = in && (T == T_MASK || __ldg(p.row_ok + row) != 0);
    const unsigned lo = in ? __ldg(p.desc_a + (size_t)row * WORDS + t) : 0u;
    const unsigned hi = in ? __ldg(p.desc_a + (size_t)row * WORDS + t + 4) : 0u;
    a[q / 2][q % 2] = lo;
    a[q / 2][2 + q % 2] = hi;
    unsigned pa = __popc(lo) + __popc(hi);
    pa += __shfl_xor_sync(0xffffffffu, pa, 1);
    pa += __shfl_xor_sync(0xffffffffu, pa, 2);
    row_base[q] = pa << COL_BITS;
    row_mask[q] = ok ? 0u : NO_KEY;
    k1[q] = k2[q] = NO_KEY;
    v[q][0] = v[q][1] = v[q][2] = v[q][3] = 0.f;
    if (ok && T == T_WINDOW) {
      v[q][0] = __ldg(p.row_v + 2 * (size_t)row);
      v[q][1] = __ldg(p.row_v + 2 * (size_t)row + 1);
    }
    if (ok && T == T_EPIPOLAR) {
#pragma unroll
      for (int e = 0; e < 3; ++e) v[q][e] = __ldg(p.row_v + 3 * (size_t)row + e);
      v[q][3] = __ldg(p.den + row);
    }
    any |= ok;
  }
#pragma unroll
  for (int i = 0; i < MT_RT; ++i) {
    live[i] = __any_sync(0xffffffffu, row_mask[2 * i] == 0u || row_mask[2 * i + 1] == 0u);
  }

  if (__syncthreads_or(any)) {
    for (int c0 = 0; c0 < n; c0 += cap) {
      if (c0) __syncthreads();   // every warp is done with the last chunk
      const int slots = stage_tested_columns<T>(p, c0, min(cap, n - c0), sdesc, scol, sxy,
                                                sthr, &count);
      __syncthreads();
#pragma unroll 2
      for (int jt = part; jt < slots / 8; jt += MT_WPR) {
        const uint2 bw = sdesc[32 * jt + lane];
        const uint4 cb = *reinterpret_cast<const uint4*>(scol + 8 * jt + 2 * t);
        // The test's values of the lane's two columns (2t, 2t + 1).
        float4 cxy = make_float4(0.f, 0.f, 0.f, 0.f);
        float2 cthr = make_float2(0.f, 0.f);
        if (T == T_WINDOW || T == T_EPIPOLAR) {
          cxy = *reinterpret_cast<const float4*>(sxy + 8 * jt + 2 * t);
        }
        if (T == T_EPIPOLAR) cthr = *reinterpret_cast<const float2*>(sthr + 8 * jt + 2 * t);
#pragma unroll
        for (int i = 0; i < MT_RT; ++i) {
          if (!live[i]) continue;
          int c[4];
          and_popc(a[i], bw.x, bw.y, c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = 2 * i + h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float thr = e ? cthr.y : cthr.x;
              float sq = 0.f;
              const int verdict = pair_verdict<T>(
                  v[q], e ? make_float2(cxy.z, cxy.w) : make_float2(cxy.x, cxy.y), thr, p.r, sq);
              // (pa + pb - 2 popc(a & b)) << COL_BITS | column, or all ones
              // where a flag is clear or the test fails.
              const unsigned key = ((e ? cb.z : cb.x) + row_base[q] -
                                    ((unsigned)c[2 * h + e] << (COL_BITS + 1))) |
                                   (e ? cb.w : cb.y) | row_mask[q] | (verdict ? 0u : NO_KEY);
              if (key < k2[q] &&
                  (verdict > 0 || exact_test<T>(p, r0 + 16 * i + g + 8 * h,
                                                key & COL_MASK, sq, v[q][3], thr))) {
                insert(key, k1[q], k2[q]);
              }
            }
          }
        }
      }
    }
  }

  // Merge the quad's keys (its four lanes hold the same rows), then the
  // group's warps into its first.
#pragma unroll
  for (int q = 0; q < 2 * MT_RT; ++q) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const unsigned o1 = __shfl_xor_sync(0xffffffffu, k1[q], off);
      const unsigned o2 = __shfl_xor_sync(0xffffffffu, k2[q], off);
      k2[q] = min(max(k1[q], o1), min(k2[q], o2));
      k1[q] = min(k1[q], o1);
    }
  }
  if constexpr (MT_WPR > 1) {
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < 2 * MT_RT; ++q) {
        parts[warp][16 * (q / 2) + g + 8 * (q % 2)] = make_uint2(k1[q], k2[q]);
      }
    }
    __syncthreads();
    if (part != 0) return;
#pragma unroll
    for (int w = 1; w < MT_WPR; ++w) {
#pragma unroll
      for (int q = 0; q < 2 * MT_RT; ++q) {
        const uint2 o = parts[warp + w][16 * (q / 2) + g + 8 * (q % 2)];
        insert(o.x, k1[q], k2[q]);
        insert(o.y, k1[q], k2[q]);
      }
    }
  }
  if (t != 0) return;
#pragma unroll
  for (int q = 0; q < 2 * MT_RT; ++q) {
    const int row = r0 + 16 * (q / 2) + g + 8 * (q % 2);
    if (row >= m) continue;
    // Fewer than two candidates: the lowest non-candidate columns, as the
    // Pallas kernel's reduction over every column gives them.
    if (k1[q] == NO_KEY) k1[q] = EMPTY << COL_BITS;
    if (k2[q] == NO_KEY) k2[q] = (EMPTY << COL_BITS) | ((k1[q] & COL_MASK) == 0u ? 1u : 0u);
    store_top2(k1[q], k2[q], row, m, n, p.out);
  }
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

// test: a Test. The tables are TestArgs' (null where the test reads none),
// each [m, ...] or [n, ...] per problem, with a batch axis where `batched`
// says so; desc_b must be 16-byte and col_xy 8-byte aligned. -> out
// [batch, 4, m].
extern "C" int candidate_top2_launch(
    int test, const void* desc_a, const void* desc_b, const void* mask, const void* row_ok,
    const void* col_ok, const void* row_v, const void* den, const void* col_xy,
    const void* thr, float r, int m, int n, int batch, unsigned batched, void* out,
    void* stream) {
  void (*kernel)(TestArgs, int);
  switch (test) {
    case T_MASK: kernel = candidate_top2_kernel<T_MASK>; break;
    case T_FLAGS: kernel = candidate_top2_kernel<T_FLAGS>; break;
    case T_WINDOW: kernel = candidate_top2_kernel<T_WINDOW>; break;
    case T_EPIPOLAR: kernel = candidate_top2_kernel<T_EPIPOLAR>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const TestArgs p{(const unsigned*)desc_a, (const uint4*)desc_b, (const uint8_t*)mask,
                   (const uint8_t*)row_ok, (const uint8_t*)col_ok, (const float*)row_v,
                   (const float*)den, (const float2*)col_xy, (const float*)thr, r, m, n,
                   batched, (int*)out};
  // Per staged column: its descriptor, key base and mask (40 bytes), the
  // coordinates (8) and the threshold (4) where the test reads them.
  const int cap = min((n + 7) / 8 * 8, MT_CHUNK);
  const size_t smem = (size_t)cap * (5 * sizeof(uint2) +
                                     (test >= T_WINDOW ? sizeof(float2) : 0) +
                                     (test == T_EPIPOLAR ? sizeof(float) : 0));
  // Past 48 KB with the merge's static parts, the block needs the opt-in.
  if (smem + MT_WARPS * 16 * MT_RT * sizeof(uint2) + sizeof(int) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + MT_ROWS - 1) / MT_ROWS, batch);
  kernel<<<grid, MT_THREADS, smem, (cudaStream_t)stream>>>(p, cap);
  return (int)cudaGetLastError();
}
