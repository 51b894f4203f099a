// K5 corner_subpix: subpixel offsets (dy, dx) of K keypoints from their
// pre-gathered [K, P, P] patches (the 31x31 IC-angle windows of K4), the
// keypoint at (cy, cx) of its patch. Replaces the Pallas kernel
// orb_slam2_commit_tpu/ops/subpix.py:corner_subpix_from_patches_pallas
// (_subpix_kernel).
//
// Semantics follow the plain version (ops/subpix.py:offsets_from_windows)
// term by term: central-difference gradients over the 7x7 window (a 9x9
// read with its 1-px halo), then 2 iterations of a Gaussian-weighted
// (sigma^2 = 9) 2x2 gradient-orthogonality solve, the guard
// det > 1e-6 * max(a + c, 1e-12)^2, offsets clamped to +-1 px. The sums run
// in another order than the plain version's, so offsets agree to ~1e-6 px,
// not bit for bit.
//
// What bounds it on the H100: neither resource, really. It needs 81 of the
// 961 pixels of each patch (324 KB at K = 1000) and ~3k float operations
// per keypoint, a few microseconds of work at most; launch latency
// dominates. Design: one thread per keypoint, reading only its 81 window
// pixels and keeping the 49 x- and y-gradients in registers; the weighted
// sums of both iterations are recomputed from them with expf, so nothing
// but the two offsets is written back.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HALF = 3;
constexpr int S = 2 * HALF + 1;   // 7: the refinement window
constexpr int ITERS = 2;
constexpr float MAX_OFFSET = 1.0f;
constexpr float TWO_SIGMA2 = 2.0f * HALF * HALF;
constexpr int THREADS = 128;

__global__ void subpix_kernel(const float* __restrict__ patches, int k, int p,
                              int cy0, int cx0, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= k) return;
  // Top-left corner of the 9x9 window (window + 1 px halo).
  const float* win = patches + (size_t)i * p * p +
                     (size_t)(cy0 - HALF - 1) * p + (cx0 - HALF - 1);
  float gx[S * S], gy[S * S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
#pragma unroll
    for (int c = 0; c < S; ++c) {
      gy[r * S + c] = 0.5f * (__ldg(win + (r + 2) * p + c + 1) -
                              __ldg(win + r * p + c + 1));
      gx[r * S + c] = 0.5f * (__ldg(win + (r + 1) * p + c + 2) -
                              __ldg(win + (r + 1) * p + c));
    }
  }

  float cy = 0.0f, cx = 0.0f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    float a = 0.0f, b = 0.0f, c = 0.0f, bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int col = 0; col < S; ++col) {
        const float px = (float)(col - HALF);
        const float py = (float)(r - HALF);
        const float dx = px - cx;
        const float dy = py - cy;
        const float wgt = expf(-(dx * dx + dy * dy) / TWO_SIGMA2);
        const float g_x = gx[r * S + col];
        const float g_y = gy[r * S + col];
        const float gxx = g_x * g_x;
        const float gyy = g_y * g_y;
        const float gxy = g_x * g_y;
        a += wgt * gxx;
        b += wgt * gxy;
        c += wgt * gyy;
        bx += wgt * (gxx * px + gxy * py);
        by += wgt * (gxy * px + gyy * py);
      }
    }
    const float det = a * c - b * b;
    const float s = fmaxf(a + c, 1e-12f);
    if (det > 1e-6f * (s * s)) {
      const float nx = (c * bx - b * by) / det;
      const float ny = (a * by - b * bx) / det;
      cx = fminf(fmaxf(nx, -MAX_OFFSET), MAX_OFFSET);
      cy = fminf(fmaxf(ny, -MAX_OFFSET), MAX_OFFSET);
    }
  }
  out[2 * i] = cy;
  out[2 * i + 1] = cx;
}

}  // namespace

extern "C" int corner_subpix_launch(const void* patches, int k, int p, int cy,
                                    int cx, void* out, void* stream) {
  const int blocks = (k + THREADS - 1) / THREADS;
  subpix_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)patches, k, p, cy, cx, (float*)out);
  return (int)cudaGetLastError();
}
