// K4 extract_patches: [K, P, P] windows around integer keypoint centres
// (row, col), with edge-replicated borders. Replaces the Pallas kernel
// orb_slam2_commit_tpu/ops/pallas_patches.py:extract_patches
// (_patch_kernel). The output is exactly [K, P, P]; the Pallas kernel's
// lane padding is a TPU layout and is not reproduced.
//
// Two entry points:
// - describe_patches_launch, the main paths' one launch per extraction:
//   each keypoint's 31x31 IC-angle window of the canvas, its 39x39 BRIEF
//   window of the blurred canvas (K1's output, which may carry pad rows
//   and columns past the canvas: each window clamps to its own image, as
//   two K4 calls would) and, when asked, K5's subpixel offsets
//   (replacing orb_slam2_commit_tpu/ops/subpix.py:
//   corner_subpix_from_patches_pallas, whose solve is
//   subpix_solve.cuh's, shared with csrc/subpix.cu);
// - extract_patches_launch, one window size per launch: compiled for
//   P = 31 and 39, and a loop over a run-time P for any other odd size.
//
// Semantics: the centre is first clamped into the image, then every
// window pixel clamps its own row and column:
//   out[k, i, j] = img[clamp(yc - P/2 + i), clamp(xc - P/2 + j)].
// K5 reads the 9x9 centre of the 31x31 window, i.e. img[clamp(yc - 4 + r),
// clamp(xc - 4 + c)], straight from the image.
//
// What bounds it on the H100: memory, and mostly the writes (1000 x
// (31^2 + 39^2) floats = 9.9 MB; the reads hit a few MB of the image in
// L2, but each window reads its own copy of its pixels: ~10 MB of scalar
// loads, so L2 traffic rather than device memory sets the time). Design:
// one launch of 2K blocks, the first K each copying one keypoint's 31x31
// window, the other K its 39x39 window; COPY = 128 threads walk a window
// in row-major order with P a compile-time constant (row and column by a
// constant division), so each warp reads consecutive pixels of an image
// row and writes consecutive output words, every thread loading all its
// pixels into registers first (a fixed count, all loads in flight) and
// then storing them. Beside the copying threads of a 31x31 block, a warp
// of its own runs K5's solve on the 81 pixels of the window's centre (L1
// and L2 hits, the copy reads them too) and writes only the two offsets,
// so the solve overlaps the copy. One launch replaces the three of the
// separate kernels (two K4, one K5) and K5's re-read of the patches.

#include <cuda_runtime.h>

#include "subpix_solve.cuh"

namespace {

constexpr int IC = 31;      // IC-angle window (and K5's source)
constexpr int BRIEF = 39;   // BRIEF window, on the blurred canvas
// describe_kernel's layout (scripts/kernel_variants.py patches-k4k5 times
// others): KPB keypoints per block, COPY threads per keypoint copying its
// window, and the K5 solve on a warp of its own beside them (OWN_SOLVER)
// or on the last copying warp after its copies.
constexpr int KPB = 1;
constexpr int COPY = 128;
constexpr bool OWN_SOLVER = true;
constexpr int TPK = COPY + (OWN_SOLVER ? 32 : 0);   // threads per keypoint
constexpr int THREADS = 256;  // threads per keypoint of patch_kernel

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Trips of T threads over a P x P window.
template <int P, int T>
__host__ __device__ constexpr int trips() { return (P * P + T - 1) / T; }

// Thread tid of T loads entries tid, tid + T, ... of the P x P window
// (row-major) around the clamped centre (yc, xc) into v.
template <int P, int T>
__device__ __forceinline__ void load_window(const float* __restrict__ img, int h, int w,
                                            int yc, int xc, int tid,
                                            float (&v)[trips<P, T>()]) {
#pragma unroll
  for (int t = 0; t < trips<P, T>(); ++t) {
    const int i = tid + t * T;
    if (t + 1 < trips<P, T>() || i < P * P) {   // only the last trip is partial
      const int r = i / P, c = i - r * P;
      const int y = clampi(yc - P / 2 + r, 0, h - 1);
      const int x = clampi(xc - P / 2 + c, 0, w - 1);
      v[t] = __ldg(img + (size_t)y * w + x);
    }
  }
}

template <int P, int T>
__device__ __forceinline__ void store_window(const float (&v)[trips<P, T>()], int tid,
                                             float* __restrict__ dst) {
#pragma unroll
  for (int t = 0; t < trips<P, T>(); ++t) {
    const int i = tid + t * T;
    if (t + 1 < trips<P, T>() || i < P * P) dst[i] = v[t];
  }
}

__global__ void __launch_bounds__(KPB * TPK)
describe_kernel(const float* __restrict__ canvas, int h, int w,
                const float* __restrict__ blur, int hb, int wb, const int* __restrict__ yx,
                int k, float* __restrict__ ic, float* __restrict__ brief,
                float* __restrict__ offsets) {
  // The grid's first half copies the 31x31 windows, its second the 39x39.
  const int nb = (k + KPB - 1) / KPB;
  const bool brief_part = (int)blockIdx.x >= nb;
  const int kp = ((int)blockIdx.x - (brief_part ? nb : 0)) * KPB + threadIdx.x / TPK;
  const int tid = threadIdx.x % TPK;
  if (kp >= k) return;
  const int y = __ldg(yx + 2 * kp), x = __ldg(yx + 2 * kp + 1);
  const int yc = clampi(y, 0, h - 1), xc = clampi(x, 0, w - 1);
  if (tid < COPY) {
    if (brief_part) {
      float b[trips<BRIEF, COPY>()];
      load_window<BRIEF, COPY>(blur, hb, wb, clampi(y, 0, hb - 1), clampi(x, 0, wb - 1), tid, b);
      store_window<BRIEF, COPY>(b, tid, brief + (size_t)kp * BRIEF * BRIEF);
    } else {
      float a[trips<IC, COPY>()];
      load_window<IC, COPY>(canvas, h, w, yc, xc, tid, a);
      store_window<IC, COPY>(a, tid, ic + (size_t)kp * IC * IC);
    }
  }
  if (offsets != nullptr && !brief_part && tid >= TPK - 32) {
    constexpr int R = subpix::HALF + 1;
    const float2 o = subpix::solve_warp([&](int r, int c) {
      return __ldg(canvas + (size_t)clampi(yc - R + r, 0, h - 1) * w +
                   clampi(xc - R + c, 0, w - 1));
    });
    if (tid == TPK - 32) reinterpret_cast<float2*>(offsets)[kp] = o;
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
patch_kernel(const float* __restrict__ img, int h, int w, const int* __restrict__ yx,
             float* __restrict__ out) {
  const int k = blockIdx.x;
  const int yc = clampi(__ldg(yx + 2 * k), 0, h - 1);
  const int xc = clampi(__ldg(yx + 2 * k + 1), 0, w - 1);
  float v[trips<P, THREADS>()];
  load_window<P, THREADS>(img, h, w, yc, xc, threadIdx.x, v);
  store_window<P, THREADS>(v, threadIdx.x, out + (size_t)k * P * P);
}

// Any other odd P, known only at run time: one pixel per thread and trip.
__global__ void __launch_bounds__(THREADS)
patch_kernel_any(const float* __restrict__ img, int h, int w, const int* __restrict__ yx,
                 int p, float* __restrict__ out) {
  const int k = blockIdx.x;
  const int half = p / 2;
  const int yc = clampi(__ldg(yx + 2 * k), 0, h - 1);
  const int xc = clampi(__ldg(yx + 2 * k + 1), 0, w - 1);
  float* dst = out + (size_t)k * p * p;
  for (int i = threadIdx.x; i < p * p; i += THREADS) {
    const int r = i / p, c = i - r * p;
    const int y = clampi(yc - half + r, 0, h - 1);
    const int x = clampi(xc - half + c, 0, w - 1);
    dst[i] = __ldg(img + (size_t)y * w + x);
  }
}

}  // namespace

extern "C" int describe_patches_launch(const void* canvas, int h, int w, const void* blur,
                                       int hb, int wb, const void* yx, int k, void* ic,
                                       void* brief, void* offsets, void* stream) {
  if (k > 0) {
    describe_kernel<<<2 * ((k + KPB - 1) / KPB), KPB * TPK, 0, (cudaStream_t)stream>>>(
        (const float*)canvas, h, w, (const float*)blur, hb, wb, (const int*)yx, k,
        (float*)ic, (float*)brief, (float*)offsets);
  }
  return (int)cudaGetLastError();
}

extern "C" int extract_patches_launch(const void* img, int h, int w,
                                      const void* yx, int k, int p, void* out,
                                      void* stream) {
  if (k > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const float* src = (const float*)img;
    const int* c = (const int*)yx;
    float* dst = (float*)out;
    if (p == IC) {
      patch_kernel<IC><<<k, THREADS, 0, s>>>(src, h, w, c, dst);
    } else if (p == BRIEF) {
      patch_kernel<BRIEF><<<k, THREADS, 0, s>>>(src, h, w, c, dst);
    } else {
      patch_kernel_any<<<k, THREADS, 0, s>>>(src, h, w, c, p, dst);
    }
  }
  return (int)cudaGetLastError();
}
