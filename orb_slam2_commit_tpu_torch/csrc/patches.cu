// K4 extract_patches: [K, P, P] windows around integer keypoint centres
// (row, col), with edge-replicated borders. Replaces the Pallas kernel
// orb_slam2_commit_tpu/ops/pallas_patches.py:extract_patches
// (_patch_kernel). The output is exactly [K, P, P]; the Pallas kernel's
// lane padding is a TPU layout and is not reproduced.
//
// Semantics: the centre is first clamped into the image, then every
// window pixel clamps its own row and column:
//   out[k, i, j] = img[clamp(yc - P/2 + i), clamp(xc - P/2 + j)].
//
// What bounds it on the H100: memory, and mostly the writes (1000 x 39 x 39
// floats = 6.1 MB; the reads hit a few MB of the image, much of it twice
// through L2). Design: one block per keypoint, threads over the P x P
// window in row-major order, so each warp reads consecutive pixels of one
// image row and writes consecutive output words; clamped indices replace
// the padded copy of the image the Pallas kernel needed.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void patch_kernel(const float* __restrict__ img, int h, int w,
                             const int* __restrict__ yx, int p,
                             float* __restrict__ out) {
  const int k = blockIdx.x;
  const int half = p / 2;
  const int yc = clampi(yx[2 * k], 0, h - 1);
  const int xc = clampi(yx[2 * k + 1], 0, w - 1);
  float* dst = out + (size_t)k * p * p;
  for (int i = threadIdx.x; i < p * p; i += blockDim.x) {
    const int r = i / p;
    const int c = i % p;
    const int y = clampi(yc - half + r, 0, h - 1);
    const int x = clampi(xc - half + c, 0, w - 1);
    dst[i] = img[(size_t)y * w + x];
  }
}

}  // namespace

extern "C" int extract_patches_launch(const void* img, int h, int w,
                                      const void* yx, int k, int p, void* out,
                                      void* stream) {
  if (k > 0) {
    patch_kernel<<<k, 256, 0, (cudaStream_t)stream>>>(
        (const float*)img, h, w, (const int*)yx, p, (float*)out);
  }
  return (int)cudaGetLastError();
}
