// K3 cell_topk: exact per-row top-k of a [C, S] float32 matrix (one row per
// 32x32 scoring cell of the packed canvas), values descending and ties to
// the lowest index. Replaces the Pallas kernel
// orb_slam2_commit_tpu/ops/pallas_select.py:cell_topk (_cell_topk_kernel).
//
// Semantics follow the Pallas kernel exactly: each row is padded with -inf
// to a multiple of 128 columns, then k rounds of (max, lowest index holding
// the max, set that entry to -inf). When fewer than k finite entries
// remain, a round returns -inf at the lowest index holding -inf, which may
// be one masked by an earlier round, just as the Pallas kernel does.
//
// What bounds it on the H100: memory. It reads the matrix once (~6 MB at
// 1480 x 1024) and writes 2 x C x k words; the k rounds of compares are
// cheap. Design: one warp per row; the warp stages its row in shared
// memory once (4 KB for S = 1024), then runs the k rounds there, each a
// strided scan per lane and a 5-step shuffle reduction on
// (value descending, index ascending).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void cell_topk_kernel(const float* __restrict__ x, int c, int s,
                                 int s_pad, int k, float* __restrict__ vals,
                                 int* __restrict__ args) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= c) return;
  float* buf = smem + (size_t)warp * s_pad;
  const float* src = x + (size_t)row * s;
  for (int i = lane; i < s_pad; i += 32) buf[i] = i < s ? src[i] : -INFINITY;
  __syncwarp();

  for (int round = 0; round < k; ++round) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = lane; i < s_pad; i += 32) {
      const float v = buf[i];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    bv = __shfl_sync(0xffffffffu, bv, 0);
    bi = __shfl_sync(0xffffffffu, bi, 0);
    if (lane == 0) {
      vals[(size_t)row * k + round] = bv;
      args[(size_t)row * k + round] = bi;
    }
    if (lane == (bi & 31)) buf[bi] = -INFINITY;
    __syncwarp();
  }
}

}  // namespace

extern "C" int cell_topk_launch(const void* x, int c, int s, int s_pad, int k,
                                void* vals, void* args, void* stream) {
  const int smem = WARPS * s_pad * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cell_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (c + WARPS - 1) / WARPS;
  cell_topk_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)x, c, s, s_pad, k, (float*)vals, (int*)args);
  return (int)cudaGetLastError();
}
