// K5's solve for one keypoint on one warp, shared by the standalone K5
// (csrc/subpix.cu, on pre-gathered patches) and the fused K4 + K5 launch
// (csrc/patches.cu, on the image), so the arithmetic exists once.
//
// Semantics follow the plain version (ops/subpix.py:offsets_from_windows)
// term by term: central-difference gradients over the 7x7 window (a 9x9
// read with its 1-px halo), then 2 iterations of a Gaussian-weighted
// (sigma^2 = 9) 2x2 gradient-orthogonality solve, the guard
// det > 1e-6 * max(a + c, 1e-12)^2, offsets clamped to +-1 px. Each of the
// 49 terms rounds as the plain version's does (built with -fmad=false);
// only the sums run in another order, so offsets agree to ~1e-6 px.
//
// Layout: lane l holds terms l and l + 32 (lanes 17-31 hold one), i.e.
// window row t / 7 and column t % 7. Each iteration's five weighted sums
// are butterfly reductions over the warp: every lane ends with the same
// bits (a float sum of two values does not depend on their order), so
// every lane takes the same guard branch and holds the same offsets.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace subpix {

constexpr int HALF = 3;
constexpr int S = 2 * HALF + 1;   // 7: the refinement window
constexpr int WIN = S + 2;        // 9: with the 1-px halo
constexpr int TERMS = S * S;      // 49
constexpr int ITERS = 2;
constexpr float MAX_OFFSET = 1.0f;
constexpr float TWO_SIGMA2 = 2.0f * HALF * HALF;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// pix(r, c), r, c in [0, WIN): the window's pixel; every lane of the warp
// must call this. -> (dy, dx) in every lane.
template <class Pix>
__device__ __forceinline__ float2 solve_warp(Pix pix) {
  const int lane = threadIdx.x & 31;
  float gxx[2], gyy[2], gxy[2], px[2], py[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = lane + 32 * s;
    const bool on = t < TERMS;
    const int r = (on ? t : 0) / S, c = (on ? t : 0) % S;
    const float g_y = 0.5f * (pix(r + 2, c + 1) - pix(r, c + 1));
    const float g_x = 0.5f * (pix(r + 1, c + 2) - pix(r + 1, c));
    gxx[s] = on ? g_x * g_x : 0.0f;
    gyy[s] = on ? g_y * g_y : 0.0f;
    gxy[s] = on ? g_x * g_y : 0.0f;
    px[s] = (float)(c - HALF);
    py[s] = (float)(r - HALF);
  }
  float cy = 0.0f, cx = 0.0f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    float a = 0.0f, b = 0.0f, c = 0.0f, bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float dx = px[s] - cx;
      const float dy = py[s] - cy;
      const float wgt = expf(-(dx * dx + dy * dy) / TWO_SIGMA2);
      a += wgt * gxx[s];
      b += wgt * gxy[s];
      c += wgt * gyy[s];
      bx += wgt * (gxx[s] * px[s] + gxy[s] * py[s]);
      by += wgt * (gxy[s] * px[s] + gyy[s] * py[s]);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    c = warp_sum(c);
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float det = a * c - b * b;
    const float s2 = fmaxf(a + c, 1e-12f);
    if (det > 1e-6f * (s2 * s2)) {
      const float nx = (c * bx - b * by) / det;
      const float ny = (a * by - b * bx) / det;
      cx = fminf(fmaxf(nx, -MAX_OFFSET), MAX_OFFSET);
      cy = fminf(fmaxf(ny, -MAX_OFFSET), MAX_OFFSET);
    }
  }
  return make_float2(cy, cx);
}

}  // namespace subpix
