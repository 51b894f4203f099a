// K5 corner_subpix: subpixel offsets (dy, dx) of K keypoints from their
// pre-gathered [K, P, P] patches (the 31x31 IC-angle windows of K4), the
// keypoint at (cy, cx) of its patch. Replaces the Pallas kernel
// orb_slam2_commit_tpu/ops/subpix.py:corner_subpix_from_patches_pallas
// (_subpix_kernel). The main paths refine inside the fused K4 + K5 launch
// (csrc/patches.cu, describe_patches); this standalone form serves callers
// that hold patches already.
//
// What bounds it on the H100: neither resource, really. It needs 81 of the
// 961 pixels of each patch (324 KB at K = 1000) and ~3k float operations
// per keypoint, a few microseconds of work at most; latency dominates.
// Design: one warp per keypoint (subpix_solve.cuh: two of the 49 terms a
// lane, each iteration's sums by warp reductions), 4 warps a block, so
// 1000 keypoints spread over 250 blocks on every SM instead of one serial
// thread each on 8 SMs. Only the two offsets are written back.

#include <cuda_runtime.h>

#include "subpix_solve.cuh"

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
subpix_kernel(const float* __restrict__ patches, int k, int p, int cy0, int cx0,
              float* __restrict__ out) {
  const int i = blockIdx.x * WARPS + threadIdx.x / 32;
  if (i >= k) return;
  // Top-left corner of the 9x9 window (window + 1 px halo).
  const float* win = patches + (size_t)i * p * p +
                     (size_t)(cy0 - subpix::HALF - 1) * p + (cx0 - subpix::HALF - 1);
  const float2 o = subpix::solve_warp([&](int r, int c) { return __ldg(win + r * p + c); });
  if ((threadIdx.x & 31) == 0) reinterpret_cast<float2*>(out)[i] = o;
}

}  // namespace

extern "C" int corner_subpix_launch(const void* patches, int k, int p, int cy,
                                    int cx, void* out, void* stream) {
  if (k > 0) {
    subpix_kernel<<<(k + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)patches, k, p, cy, cx, (float*)out);
  }
  return (int)cudaGetLastError();
}
