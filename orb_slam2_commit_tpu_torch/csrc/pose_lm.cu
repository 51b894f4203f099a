// K8 pose_lm: the whole pose-only bundle adjustment in one launch: up to
// n_rounds chi2 rounds of up to iters Levenberg-Marquardt iterations,
// Huber weights (5.991 mono / 7.815 stereo), the depth gate, a 6x6
// Cholesky solve, the SE3 exponential, accept/reject damping, and the
// inlier classification after each round. Replaces the Pallas kernel
// orb_slam2_commit_tpu/optim/pallas_pose_opt.py:pose_optimization_pallas
// (_pose_lm_kernel).
//
// Semantics follow the plain version (optim/pose_opt.py, the JAX package's
// XLA route), where that route and the TPU kernel differ: the convergence
// test is |step|^2 < 1e-10 (the TPU kernel's 1e-16 is never reached in
// float32), and a round whose active set equals the previous round's and
// whose start already settled (converged, or damping >= 1e8) is skipped,
// which makes every later round a skip too. A step whose Cholesky factor
// fails (a pivot <= 0) is rejected, as the plain version rejects its NaN
// step. Mono rows use (u, v), stereo rows (u, v, u_right); the depth guard
// is |z| > 1e-9, and rows with z <= 0 get no weight. The sums over the
// observations run in another order than the plain version's, so poses
// agree to float32 rounding, not bit for bit.
//
// What bounds it on the H100: latency, not bytes or operations. The work is
// ~40 sequential evaluations of ~1000 observations (~150 float operations
// each, ~6 MFLOP in all) over ~36 KB of inputs; each iteration's 6x6 solve
// depends on the previous evaluation. The plain version issues ~9k tiny
// launches for it. Design: one block of 256 threads; each evaluation loops
// over the observations, reduces the 21 upper H entries, the 6 b entries
// and the cost by warp shuffles and one shared-memory pass, and thread 0
// then solves, exponentiates and accepts or rejects while the block waits
// at a barrier. The early exits are loop exits inside the kernel, so the
// host never waits on the LM. Besides the pose (12 floats) the kernel
// writes the work it did (evaluations, active observations summed over
// them, rounds run), so a caller can count the operations this input
// needed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NH = 21;            // upper triangle of the 6x6 H
constexpr int NSUM = NH + 6 + 1;  // H, b, cost
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr float STEP_EPS = 1e-10f;

struct Problem {
  const float* points;     // [O, 3] world
  const float* uvr;        // [O, 3] observed (u, v, u_right)
  const float* info;       // [O] inv_sigma2
  const uint8_t* stereo;   // [O]
  const uint8_t* valid;    // [O]
  uint8_t* flags;          // [O] active set of the round, then its inliers
  int o;
  float fx, fy, cx, cy, bf;
};

struct Proj {
  float px, py, pz, inv_z, u, v, ur;
};

__device__ __forceinline__ Proj project(const Problem& p, const float* R,
                                        const float* t, int i) {
  const float X = __ldg(p.points + 3 * i);
  const float Y = __ldg(p.points + 3 * i + 1);
  const float Z = __ldg(p.points + 3 * i + 2);
  Proj q;
  q.px = R[0] * X + R[1] * Y + R[2] * Z + t[0];
  q.py = R[3] * X + R[4] * Y + R[5] * Z + t[1];
  q.pz = R[6] * X + R[7] * Y + R[8] * Z + t[2];
  const float zs = fabsf(q.pz) > 1e-9f ? q.pz : 1e-9f;
  q.inv_z = 1.0f / zs;
  q.u = p.fx * q.px * q.inv_z + p.cx;
  q.v = p.fy * q.py * q.inv_z + p.cy;
  q.ur = q.u - p.bf * q.inv_z;
  return q;
}

// chi2 of observation i at (R, t).
__device__ __forceinline__ float chi2_of(const Problem& p, const Proj& q, int i,
                                         bool st) {
  const float eu = __ldg(p.uvr + 3 * i) - q.u;
  const float ev = __ldg(p.uvr + 3 * i + 1) - q.v;
  const float er = st ? __ldg(p.uvr + 3 * i + 2) - q.ur : 0.0f;
  return __ldg(p.info + i) * (eu * eu + ev * ev + er * er);
}

// Block-wide H (upper 21), b (6) and robust cost at (R, t) over the active
// observations -> tot[NSUM] in shared memory (all threads see it after the
// final barrier).
__device__ void evaluate(const Problem& p, const float* R, const float* t,
                         bool robust, float (*part)[NSUM], float* tot) {
  float acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.0f;
  for (int i = threadIdx.x; i < p.o; i += THREADS) {
    if (!p.flags[i]) continue;
    const Proj q = project(p, R, t, i);
    if (!(q.pz > 0.0f)) continue;            // depth gate: no weight, no cost
    const bool st = p.stereo[i] != 0;
    const float eu = __ldg(p.uvr + 3 * i) - q.u;
    const float ev = __ldg(p.uvr + 3 * i + 1) - q.v;
    const float er = st ? __ldg(p.uvr + 3 * i + 2) - q.ur : 0.0f;
    const float info = __ldg(p.info + i);
    const float chi2 = info * (eu * eu + ev * ev + er * er);
    const float delta2 = st ? CHI2_STEREO : CHI2_MONO;
    const float delta = sqrtf(delta2);
    const float sqrt_c = sqrtf(fmaxf(chi2, 1e-12f));
    const float huber = robust ? fminf(delta / sqrt_c, 1.0f) : 1.0f;
    const float w = info * huber;
    acc[NSUM - 1] += robust && !(chi2 <= delta2) ? 2.0f * delta * sqrt_c - delta2 : chi2;

    // d(u, v, u_r)/d P_cam, then J = -A [-hat(P) | I] over [omega, upsilon].
    const float inv_z2 = q.inv_z * q.inv_z;
    const float a0 = p.fx * q.inv_z;
    const float a2 = -p.fx * q.px * inv_z2;
    const float b1 = p.fy * q.inv_z;
    const float b2 = -p.fy * q.py * inv_z2;
    const float r2 = a2 + p.bf * inv_z2;
    const float ju[6] = {-a2 * q.py, -a0 * q.pz + a2 * q.px, a0 * q.py, -a0, 0.0f, -a2};
    const float jv[6] = {b1 * q.pz - b2 * q.py, b2 * q.px, -b1 * q.px, 0.0f, -b1, -b2};
    const float jr[6] = {-r2 * q.py, -a0 * q.pz + r2 * q.px, a0 * q.py, -a0, 0.0f, -r2};
    const float wr = st ? w : 0.0f;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 6; ++c) {
        acc[k++] += w * ju[a] * ju[c] + w * jv[a] * jv[c] + wr * jr[a] * jr[c];
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      acc[NH + a] += w * ju[a] * eu + w * jv[a] * ev + wr * jr[a] * er;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Solve (H + lam diag(H) + 1e-9 I) x = b by Cholesky; false if a pivot is
// not positive (the plain version's failed factor).
__device__ bool lm_solve(const float* Hu, const float* b, float lam, float* x) {
  float H[6][6];
  int k = 0;
  for (int a = 0; a < 6; ++a) {
    for (int c = a; c < 6; ++c) {
      H[a][c] = Hu[k];
      H[c][a] = Hu[k];
      ++k;
    }
  }
  for (int a = 0; a < 6; ++a) H[a][a] = H[a][a] + lam * H[a][a] + 1e-9f;
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
    for (int q = 0; q < j; ++q) s -= L[j][q] * L[j][q];
    if (!(s > 0.0f)) return false;
    const float d = sqrtf(s);
    L[j][j] = d;
    for (int i = j + 1; i < 6; ++i) {
      float s2 = H[i][j];
      for (int q = 0; q < j; ++q) s2 -= L[i][q] * L[j][q];
      L[i][j] = s2 / d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int q = 0; q < i; ++q) s -= L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int q = i + 1; q < 6; ++q) s -= L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
  return true;
}

// exp of [omega, upsilon] applied on the left: (R, t) <- exp(xi) (R, t),
// with ops/lie.py's coefficients and small-angle branches.
__device__ void se3_left_update(const float* xi, const float* R, const float* t,
                                float* Rn, float* tn) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float ka = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float kb = small ? 0.5f - theta2 / 24.0f : (1.0f - c) / (theta2 + 1e-16f);
  const float kc = small ? 1.0f / 6.0f - theta2 / 120.0f
                         : (theta - s) / (theta2 * theta + 1e-8f);
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
  float dR[9], J[9];
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    dR[k] = eye + ka * W[k] + kb * W2[k];
    J[k] = eye + kb * W[k] + kc * W2[k];
  }
  for (int i = 0; i < 3; ++i) {
    const float dt = J[3 * i] * xi[3] + J[3 * i + 1] * xi[4] + J[3 * i + 2] * xi[5];
    tn[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] + dt;
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j] + dR[3 * i + 2] * R[6 + j];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
pose_lm_kernel(Problem p, const float* __restrict__ R0, const float* __restrict__ t0,
               int n_rounds, int iters, float* __restrict__ pose_out) {
  __shared__ float part[WARPS][NSUM];
  __shared__ float tot[NSUM];
  __shared__ float R[9], t[3], Rn[9], tn[3];
  __shared__ float H[NH], bvec[6], cost;
  __shared__ int go, try_step, s_settled, n_active;
  // Work done, for the caller's operation count: evaluations, active
  // observations summed over evaluations, rounds run (thread 0's count).
  float n_evals = 0.0f, obs_evals = 0.0f, rounds = 0.0f;

  if (threadIdx.x < 9) R[threadIdx.x] = R0[threadIdx.x];
  if (threadIdx.x < 3) t[threadIdx.x] = t0[threadIdx.x];
  for (int i = threadIdx.x; i < p.o; i += THREADS) p.flags[i] = p.valid[i];
  __syncthreads();

  bool settled = false, changed = true;
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    // A settled start with an unchanged active set: this round and every
    // later one change nothing.
    if (rnd > 0 && settled && !changed) break;
    const bool robust = rnd < n_rounds - 1;
    if (threadIdx.x == 0) n_active = 0;
    __syncthreads();
    int mine = 0;
    for (int i = threadIdx.x; i < p.o; i += THREADS) mine += p.flags[i];
    atomicAdd(&n_active, mine);

    evaluate(p, R, t, robust, part, tot);
    float lam = 1e-3f, step2 = 0.0f;
    bool converged = false;
    if (threadIdx.x == 0) {
      for (int k = 0; k < NH; ++k) H[k] = tot[k];
      for (int k = 0; k < 6; ++k) bvec[k] = tot[NH + k];
      cost = tot[NSUM - 1];
      n_evals += 1.0f;
      obs_evals += (float)n_active;
      rounds += 1.0f;
    }
    for (int it = 0;; ++it) {
      if (threadIdx.x == 0) {
        go = it < iters && !converged && lam < 1e8f;
        try_step = 0;
        if (go) {
          float x[6];
          if (lm_solve(H, bvec, lam, x)) {
            float xi[6];
            step2 = 0.0f;
            for (int k = 0; k < 6; ++k) {
              xi[k] = -x[k];
              step2 += xi[k] * xi[k];
            }
            se3_left_update(xi, R, t, Rn, tn);
            try_step = 1;
          }
        }
      }
      __syncthreads();
      if (!go) break;
      if (try_step) evaluate(p, Rn, tn, robust, part, tot);
      if (threadIdx.x == 0) {
        if (try_step) {
          n_evals += 1.0f;
          obs_evals += (float)n_active;
        }
        const bool accept = try_step && tot[NSUM - 1] < cost;
        if (accept) {
          for (int k = 0; k < 9; ++k) R[k] = Rn[k];
          for (int k = 0; k < 3; ++k) t[k] = tn[k];
          for (int k = 0; k < NH; ++k) H[k] = tot[k];
          for (int k = 0; k < 6; ++k) bvec[k] = tot[NH + k];
          cost = tot[NSUM - 1];
        }
        lam = accept ? lam * 0.5f : lam * 4.0f;
        converged = accept && step2 < STEP_EPS;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) s_settled = converged || lam >= 1e8f;
    __syncthreads();
    settled = s_settled != 0;

    // Reclassify every valid observation at the round's pose; the new
    // inlier set is the next round's active set.
    int diff = 0;
    for (int i = threadIdx.x; i < p.o; i += THREADS) {
      uint8_t inl = 0;
      if (p.valid[i]) {
        const Proj q = project(p, R, t, i);
        const bool st = p.stereo[i] != 0;
        inl = chi2_of(p, q, i, st) <= (st ? CHI2_STEREO : CHI2_MONO) && q.pz > 0.0f;
      }
      diff |= inl != p.flags[i];
      p.flags[i] = inl;
    }
    changed = __syncthreads_or(diff) != 0;
  }
  if (threadIdx.x < 9) pose_out[threadIdx.x] = R[threadIdx.x];
  if (threadIdx.x < 3) pose_out[9 + threadIdx.x] = t[threadIdx.x];
  if (threadIdx.x == 0) {
    pose_out[12] = n_evals;
    pose_out[13] = obs_evals;
    pose_out[14] = rounds;
  }
}

}  // namespace

extern "C" int pose_lm_launch(
    const void* R0, const void* t0, const void* points, const void* uvr,
    const void* inv_sigma2, const void* is_stereo, const void* valid, int o,
    float fx, float fy, float cx, float cy, float bf, int n_rounds, int iters,
    void* pose_out, void* inliers_out, void* stream) {
  Problem p;
  p.points = (const float*)points;
  p.uvr = (const float*)uvr;
  p.info = (const float*)inv_sigma2;
  p.stereo = (const uint8_t*)is_stereo;
  p.valid = (const uint8_t*)valid;
  p.flags = (uint8_t*)inliers_out;
  p.o = o;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.bf = bf;
  pose_lm_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      p, (const float*)R0, (const float*)t0, n_rounds, iters, (float*)pose_out);
  return (int)cudaGetLastError();
}
