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
// issue than that (~20 us at 1.98 GHz). K2's bound counts what the
// function needs from the run's maps (chip_smoke.py): score_hi inside each
// row's bounds, score_lo inside the bounds of the low cells, the two bound
// columns, and the output map. The flag pass reads the first; the
// per-pixel pass reads the selected map inside the bounds once more, with
// its 1.20x halo, where K1 has just left both maps in the 50 MB L2.
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
// K2's design: two launches, each short, each with at most two dependent
// rounds of loads (a latency-bound pass pays per round, not per byte).
// The flag pass reduces each 32x32 cell to one "has a masked high score"
// byte: a block of 8 warps reads a strip of four cells side by side as
// float4 rows, 4 rows a warp, all in flight, and skips what lies outside
// a row's bounds (an early exit would save nothing in 4 rows; a warp per
// strip that stopped early ran 0.0124 ms on too few warps). The per-pixel
// pass stages a 128x32 tile (four cells of one cell row) with a 2-px
// halo, 1.20x the outputs: first the staged rows' bounds and the tile's
// 18 cell flags into shared memory, then every aligned float4 load of a
// thread at once, by 2-D loops; each float4 reads only the map its cell's
// flag selects, and neither map outside the bounds. Each thread then
// slides a 3x3 window down four rows of one 4-px column group in
// registers (horizontal maxima once per staged row, is-max bits by
// compares, the raster-first rule by bit operations) and stores each row's
// four outputs as one float4: ~1/3 of the instructions of an is-max pass
// through shared memory. One launch would need a grid barrier, or each
// block re-reading the score_hi of the 14 cells around its own 4 (4.5x the
// flag pass's reads) to know its halo's maps; two launches keep each pass
// at one read of what it needs. On the 2368x640 canvas (H100 80GB HBM3,
// 700 W; scripts/kernel_variants.py level-combine): flag pass 0.0026 ms,
// per-pixel pass 0.0076 ms, against 0.0037 and 0.0145 for the earlier
// design (one thread per output over a 32x8 tile with a 1.69x halo, and a
// flag pass over every pixel); 128x64 and 64x32 tiles, 4 thread rows, 4
// flag warps, and one launch whose blocks find their 18 cells' flags
// themselves (0.0132 ms against 0.0101-0.0103) were slower.
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
// K2's output tile (one cell row tall, four cells wide; a multiple of 32
// rows and of 64 columns that divides 128) and its thread rows; the
// cell-flag pass's strip (32 lanes x 4 px) and warps per block (each
// reads CELL / FLAG_WARPS rows of the strip).
constexpr int NT_W = 128;
constexpr int NT_H = 32;
constexpr int NMS_BY = 8;
constexpr int FLAG_W = 128;
constexpr int FLAG_WARPS = 8;

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
// bounds [x0, x1) with score_hi > 0. One block per strip of four cells
// side by side (128 px of one cell row), warp w reading rows w, w + 8, ..:
// lane l reads pixels 4l..4l+3 of a row as one float4, and only where
// they meet the row's bounds, so a row with empty bounds is never read.
// Every load of a thread is in flight at once (its rows' bounds, then its
// float4s): two dependent rounds per launch.
__global__ void __launch_bounds__(FLAG_WARPS * 32)
cell_flag_kernel(const float* __restrict__ score_hi,
                 const int* __restrict__ bounds, int bounds_stride, int wp,
                 unsigned char* __restrict__ flags) {
  __shared__ unsigned found_by_warp[FLAG_WARPS];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int strips_x = wp / FLAG_W;
  const int cy = blockIdx.x / strips_x;
  const int xs = (blockIdx.x % strips_x) * FLAG_W;
  const int x = xs + 4 * lane;

  int bx0[CELL / FLAG_WARPS], bx1[CELL / FLAG_WARPS];
#pragma unroll
  for (int k = 0; k < CELL / FLAG_WARPS; ++k) {
    const int y = cy * CELL + warp + k * FLAG_WARPS;
    bx0[k] = __ldg(bounds + (size_t)y * bounds_stride);
    bx1[k] = __ldg(bounds + (size_t)y * bounds_stride + 1);
  }
  bool found = false;
#pragma unroll
  for (int k = 0; k < CELL / FLAG_WARPS; ++k) {
    const int y = cy * CELL + warp + k * FLAG_WARPS;
    if (x + 4 > bx0[k] && x < bx1[k]) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(score_hi + (size_t)y * wp + x));
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) found |= v[e] > 0.f && x + e >= bx0[k] && x + e < bx1[k];
    }
  }
  // Lanes 8c..8c+7 hold cell c of the strip.
  const unsigned b = __ballot_sync(0xffffffffu, found);
  if (lane == 0) found_by_warp[warp] = b;
  __syncthreads();
  if (threadIdx.x < FLAG_W / CELL) {
    unsigned any = 0;
#pragma unroll
    for (int w = 0; w < FLAG_WARPS; ++w) any |= found_by_warp[w];
    flags[cy * (wp / CELL) + xs / CELL + threadIdx.x] =
        ((any >> (8 * threadIdx.x)) & 0xffu) ? 1 : 0;
  }
}

// One NT_W x NT_H output tile per block of 32 x NMS_BY threads; staged
// column group g holds pixels x0 - 4 + 4g .. +3, staged row r image row
// y0 - 2 + r.
__global__ void __launch_bounds__(32 * NMS_BY)
combine_nms_kernel(const float* __restrict__ score_hi,
                   const float* __restrict__ score_lo,
                   const int* __restrict__ bounds, int bounds_stride,
                   const unsigned char* __restrict__ flags, int hp, int wp,
                   float* __restrict__ out) {
  // Combined scores with a 2-px halo (and 2 more unused columns each
  // side, so that every load is one aligned float4); -inf outside the
  // canvas, 0 outside the row's bounds.
  __shared__ float4 comb[NT_H + 4][NT_W / 4 + 2];
  // Each staged row's bounds (empty outside the canvas), and the flags of
  // the cells the staged pixels lie in: cell rows y0 / CELL - 1 .., cell
  // columns x0 / CELL - 1 ...
  constexpr int GROUPS = NT_W / 4 + 2;
  constexpr int FR = NT_H / CELL + 2, FC = NT_W / CELL + 2;
  __shared__ int2 row_bounds[NT_H + 4];
  __shared__ unsigned char cell_hi[FR][FC];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int x0 = blockIdx.x * NT_W;
  const int y0 = blockIdx.y * NT_H;
  const int n_cx = wp / CELL;

  for (int r = tid; r < NT_H + 4; r += 32 * NMS_BY) {
    const int y = y0 - 2 + r;
    row_bounds[r] = y >= 0 && y < hp
        ? make_int2(__ldg(bounds + (size_t)y * bounds_stride),
                    __ldg(bounds + (size_t)y * bounds_stride + 1))
        : make_int2(0, 0);
  }
  for (int k = tid; k < FR * FC; k += 32 * NMS_BY) {
    const int cy = y0 / CELL - 1 + k / FC, cx = x0 / CELL - 1 + k % FC;
    cell_hi[k / FC][k % FC] =
        cy >= 0 && cy < hp / CELL && cx >= 0 && cx < n_cx ? flags[cy * n_cx + cx] : 0;
  }
  __syncthreads();

  // Each group reads only the map its cell's flag selects, and only where
  // it meets the row's bounds (a float4 never straddles a cell or the
  // canvas edge: both are multiples of 4 wide). All of a thread's loads
  // are issued before the first store.
  constexpr int RPT_NMS = (NT_H + 4 + NMS_BY - 1) / NMS_BY;
  constexpr int GPT = (GROUPS + 31) / 32;
  float4 staged[RPT_NMS][GPT];
#pragma unroll
  for (int i = 0; i < RPT_NMS; ++i) {
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      const int r = ty + i * NMS_BY, g = tx + j * 32;
      const int y = y0 - 2 + r, x = x0 - 4 + 4 * g;
      float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (r < NT_H + 4 && g < GROUPS && y >= 0 && y < hp && x >= 0 && x < wp) {
        const int2 b = row_bounds[r];
        v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (x + 4 > b.x && x < b.y) {
          const float* map =
              cell_hi[(r + CELL - 2) / CELL][(4 * g + CELL - 4) / CELL] ? score_hi : score_lo;
          v = __ldg(reinterpret_cast<const float4*>(map + (size_t)y * wp + x));
          if (x < b.x || x + 4 > b.y) {   // the float4 straddles a bound
            v.x = x >= b.x && x < b.y ? v.x : 0.f;
            v.y = x + 1 >= b.x && x + 1 < b.y ? v.y : 0.f;
            v.z = x + 2 >= b.x && x + 2 < b.y ? v.z : 0.f;
            v.w = x + 3 >= b.x && x + 3 < b.y ? v.w : 0.f;
          }
        }
      }
      staged[i][j] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < RPT_NMS; ++i) {
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      const int r = ty + i * NMS_BY, g = tx + j * 32;
      if (r < NT_H + 4 && g < GROUPS) comb[r][g] = staged[i][j];
    }
  }
  __syncthreads();

  // 3x3 NMS by a window sliding down each thread's R output rows of one
  // column group g (pixels x0 - 4 + 4g + j, j = 0..3): per staged row the
  // values of pixels -2..5 of the group (v), their horizontal 3-maxima at
  // pixels -1..4 (h), and from three rows of h the is-max bits of pixels
  // -1..4 (bit j + 1 for pixel j). A pixel is kept iff it is a maximum and
  // no raster-earlier neighbour (smaller flat index) is one too.
  constexpr int R = NT_H / NMS_BY;
  for (int g = tx + 1; g < GROUPS - 1; g += 32) {
    const int r0 = ty * R;   // first output row; staged row r0 + 2
    float h1[6], h2[6], c1[6];   // h of staged rows q - 2, q - 1; v of q - 1
    unsigned up = 0;             // is-max bits of the output row above
#pragma unroll
    for (int j = 0; j < 6; ++j) h1[j] = h2[j] = c1[j] = -INFINITY;
#pragma unroll
    for (int k = 0; k < R + 3; ++k) {
      const int q = r0 + k;
      const float4 a = comb[q][g - 1], b = comb[q][g], c = comb[q][g + 1];
      const float v[8] = {a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y};
      float h[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) h[j] = fmaxf(fmaxf(v[j], v[j + 1]), v[j + 2]);
      if (k >= 2) {   // the is-max bits of output row q - 3 (staged row q - 1)
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float s = c1[j];
          bits |= (unsigned)(s >= fmaxf(fmaxf(h1[j], h2[j]), h[j]) && s > 0.f) << j;
        }
        if (k >= 3) {
          const unsigned keep = (bits >> 1) & ~(up | up >> 1 | up >> 2 | bits);
          reinterpret_cast<float4*>(out + (size_t)(y0 + q - 3) * wp + x0)[g - 1] =
              make_float4(keep & 1u ? c1[1] : 0.f, keep & 2u ? c1[2] : 0.f,
                          keep & 4u ? c1[3] : 0.f, keep & 8u ? c1[4] : 0.f);
        }
        up = bits;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        h1[j] = h2[j];
        h2[j] = h[j];
        c1[j] = v[j + 1];
      }
    }
  }
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
  const int strips = (hp / CELL) * (wp / FLAG_W);
  cell_flag_kernel<<<strips, FLAG_WARPS * 32, 0, s>>>(
      (const float*)score_hi, (const int*)bounds, bounds_stride, wp,
      (unsigned char*)flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_nms_kernel<<<dim3(wp / NT_W, hp / NT_H), dim3(32, NMS_BY), 0, s>>>(
      (const float*)score_hi, (const float*)score_lo, (const int*)bounds,
      bounds_stride, (const unsigned char*)flags, hp, wp, (float*)out);
  return (int)cudaGetLastError();
}
