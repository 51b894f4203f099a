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
// is |z| > 1e-9, and rows with z <= 0 get no weight. The last round is not
// robust. The sums over the observations run in another order than the
// plain version's (and may contract into FMA), so poses agree to float32
// rounding, not bit for bit; two launches on one input give the same bits.
//
// What bounds it on the H100: latency. The work is ~30-40 evaluations of
// ~1000 observations per launch (~13 Mop per pair over ~36 KB of inputs),
// and each one depends on the 6x6 solve of the one before, so the time is
// the length of that chain: one evaluation's pass over the observations,
// its block reduction, the solve and the SE3 update. Design, per
// evaluation:
// - One block of 256 threads, ~4 observations per thread at O = 1000.
//   Clock counts per trial evaluation on an H100 at 700 W, mono rows, at
//   128 / 256 / 384 / 512 threads (scripts/kernel_variants.py
//   pose_lm-threads): pass 2989 / 2302 / 2291 / 2170 cycles, block
//   reduction 330 / 510 / 594 / 886, solve 409 / 510 / 658 / 844, SE3 309 /
//   427 / 633 / 869; 2.30 / 2.09 / 2.30 / 2.60 us per evaluation. The pass
//   stops getting faster past 256 threads, while the solve, the SE3 update
//   and the reduction, which every warp repeats, get slower; 1024 threads
//   would also cap the registers at 64 (this kernel uses ~110, no spill).
//   Not a cluster: it would split the pass, but add a cluster barrier and
//   a distributed-shared-memory exchange to every evaluation of the chain.
// - The problem is staged in dynamic shared memory at launch as structure
//   of arrays (X, Y, Z, u, v, u_r, inv_sigma2 and one flag byte: valid,
//   stereo, active; 29 B per observation), so every pass reads shared
//   memory only. Rows beyond MAX_STAGED are read from global memory by the
//   same code, with their active flag in the inlier output.
// - A row's contribution is computed without branches (inactive rows and
//   rows behind the camera add zero through a zero weight, each sum term
//   is one FMA); the stereo row is compiled in only when the problem has
//   stereo rows.
// - The 30 per-thread sums (21 of H, 6 of b, the cost, the active count,
//   the flags that changed) are reduce-scattered within each warp in 31
//   shuffles, so lane k holds the warp's sum k; lane k writes it to a
//   [warps][32] array, and after one barrier every warp sums each column
//   in the same fixed order. No atomics: two launches give the same bits.
//   The buffer alternates between evaluations, so one barrier per
//   evaluation suffices.
// - Every thread then takes the totals by shuffles and runs the damped
//   6x6 Cholesky (rsqrt pivots), both triangular solves and the SE3
//   exponential (one sincospif) itself, fully unrolled in registers: all
//   threads reach the same step and the same accept decision, and no
//   barrier hands them out. No stack frame.
// - The counts ride in the reduction instead of __syncthreads_count (an
//   observation loop gives a thread several rows, and the reduction's
//   spare slots cost nothing), and each round's inlier classification is
//   folded into the next round's first pass, which starts at the same pose.
// Besides the pose (12 floats) the kernel writes the work it did
// (evaluations, active observations summed over them, rounds run) and the
// inlier count. Built without -fmad=false: FMA contraction is allowed here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// Reduction slots: 21 upper H entries, 6 of b, then these (2 spare).
constexpr int S_B = 21;
constexpr int S_COST = 27;
constexpr int S_COUNT = 28;
constexpr int S_CHANGED = 29;
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr float STEP_EPS = 1e-10f;
// At most this many observations are staged in shared memory (~203 KB).
constexpr int MAX_STAGED = 7000;
constexpr int BYTES_PER_OBS = 7 * 4 + 1;
constexpr uint8_t VALID = 1, STEREO = 2, ACTIVE = 4;

struct Problem {
  const float* points;     // [O, 3] world
  const float* uvr;        // [O, 3] observed (u, v, u_right)
  const float* info;       // [O] inv_sigma2
  const uint8_t* stereo;   // [O]
  const uint8_t* valid;    // [O]
  uint8_t* inliers;        // [O] out; the active set of unstaged rows
  int o, staged;
  float fx, fy, cx, cy, bf;
};

struct Stage {
  float *X, *Y, *Z, *u, *v, *ur, *info;
  uint8_t* flag;
};

struct Obs {
  float X, Y, Z, u, v, ur, info;
  uint8_t flag;
};

// One observation's contribution at (R, t), straight-line code without
// branches. CLASSIFY: the row's active flag becomes valid, chi2 within the
// Huber bound, and in front of the camera (the flag byte comes back in
// flag). Active rows are counted; with accumulate, those in front of the
// camera add to H, b and the (robust) cost, others add zero through a zero
// weight. ST_ROWS: the problem has stereo rows.
template <bool CLASSIFY, bool ST_ROWS>
__device__ __forceinline__ void row(const Problem& p, const Obs& ob, const float (&R)[9],
                                    const float (&t)[3], bool accumulate, bool robust,
                                    float (&acc)[32], uint8_t& flag) {
  const float px = R[0] * ob.X + R[1] * ob.Y + R[2] * ob.Z + t[0];
  const float py = R[3] * ob.X + R[4] * ob.Y + R[5] * ob.Z + t[1];
  const float pz = R[6] * ob.X + R[7] * ob.Y + R[8] * ob.Z + t[2];
  const float inv_z = 1.0f / (fabsf(pz) > 1e-9f ? pz : 1e-9f);
  const float u = p.fx * px * inv_z + p.cx;
  const float v = p.fy * py * inv_z + p.cy;
  const bool st = ST_ROWS && (ob.flag & STEREO);
  const float eu = ob.u - u;
  const float ev = ob.v - v;
  const float er = st ? ob.ur - (u - p.bf * inv_z) : 0.0f;
  const float chi2 = ob.info * (eu * eu + ev * ev + er * er);
  const float delta2 = st ? CHI2_STEREO : CHI2_MONO;
  const bool front = pz > 0.0f;
  bool active = (ob.flag & ACTIVE) != 0;
  if (CLASSIFY) {
    const bool inl = (ob.flag & VALID) && chi2 <= delta2 && front;
    acc[S_CHANGED] += inl != active ? 1.0f : 0.0f;
    active = inl;
    flag = (uint8_t)(inl ? (ob.flag | ACTIVE) : (ob.flag & ~ACTIVE));
  }
  acc[S_COUNT] += active ? 1.0f : 0.0f;
  const bool use = accumulate && active && front;   // the depth gate

  const float delta = st ? sqrtf(CHI2_STEREO) : sqrtf(CHI2_MONO);   // folded
  const float c = fmaxf(chi2, 1e-12f);
  const float inv_sqrt_c = rsqrtf(c);
  const float huber = robust ? fminf(delta * inv_sqrt_c, 1.0f) : 1.0f;
  const float w = use ? ob.info * huber : 0.0f;
  const float rho = robust && !(chi2 <= delta2) ? 2.0f * delta * (c * inv_sqrt_c) - delta2 : chi2;
  acc[S_COST] += use ? rho : 0.0f;

  // d(u, v, u_r)/d P_cam, then J = -A [-hat(P) | I] over [omega, upsilon].
  const float inv_z2 = inv_z * inv_z;
  const float a0 = p.fx * inv_z;
  const float a2 = -p.fx * px * inv_z2;
  const float b1 = p.fy * inv_z;
  const float b2 = -p.fy * py * inv_z2;
  const float ju[6] = {-a2 * py, -a0 * pz + a2 * px, a0 * py, -a0, 0.0f, -a2};
  const float jv[6] = {b1 * pz - b2 * py, b2 * px, -b1 * px, 0.0f, -b1, -b2};
  // acc += w J^T J and w J^T e, one FMA per term.
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wju = w * ju[a], wjv = w * jv[a];
#pragma unroll
    for (int c2 = a; c2 < 6; ++c2, ++k) acc[k] = fmaf(wjv, jv[c2], fmaf(wju, ju[c2], acc[k]));
    acc[S_B + a] = fmaf(wjv, ev, fmaf(wju, eu, acc[S_B + a]));
  }
  if (ST_ROWS) {   // the u_right row, with zero weight on mono rows
    const float r2 = a2 + p.bf * inv_z2;
    const float jr[6] = {-r2 * py, -a0 * pz + r2 * px, a0 * py, -a0, 0.0f, -r2};
    const float wr = st ? w : 0.0f;
    k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wjr = wr * jr[a];
#pragma unroll
      for (int c2 = a; c2 < 6; ++c2, ++k) acc[k] = fmaf(wjr, jr[c2], acc[k]);
      acc[S_B + a] = fmaf(wjr, er, acc[S_B + a]);
    }
  }
}

// One pass over this thread's observations at (R, t) -> acc[32]: the
// staged rows from shared memory, then any others from
// global memory, whose active flags live in the inlier output.
template <bool CLASSIFY, bool ST_ROWS>
__device__ __forceinline__ void pass_rows(const Problem& p, const Stage& s, const float (&R)[9],
                                          const float (&t)[3], bool accumulate, bool robust,
                                          float (&acc)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
  int i = threadIdx.x;
  for (; i < p.staged; i += THREADS) {
    const Obs ob{s.X[i], s.Y[i], s.Z[i], s.u[i], s.v[i], s.ur[i], s.info[i], s.flag[i]};
    uint8_t flag;
    row<CLASSIFY, ST_ROWS>(p, ob, R, t, accumulate, robust, acc, flag);
    if (CLASSIFY) s.flag[i] = flag;
  }
  for (; i < p.o; i += THREADS) {
    const Obs ob{__ldg(p.points + 3 * i), __ldg(p.points + 3 * i + 1),
                 __ldg(p.points + 3 * i + 2), __ldg(p.uvr + 3 * i), __ldg(p.uvr + 3 * i + 1),
                 __ldg(p.uvr + 3 * i + 2), __ldg(p.info + i),
                 (uint8_t)((__ldg(p.valid + i) ? VALID : 0) | (__ldg(p.stereo + i) ? STEREO : 0) |
                           (p.inliers[i] ? ACTIVE : 0))};
    uint8_t flag;
    row<CLASSIFY, ST_ROWS>(p, ob, R, t, accumulate, robust, acc, flag);
    if (CLASSIFY) p.inliers[i] = (flag & ACTIVE) ? 1 : 0;
  }
}

__device__ __forceinline__ void pass(const Problem& p, const Stage& s, const float (&R)[9],
                                     const float (&t)[3], bool classify, bool accumulate,
                                     bool robust, bool has_stereo, float (&acc)[32]) {
  if (classify) {
    if (has_stereo) pass_rows<true, true>(p, s, R, t, accumulate, robust, acc);
    else pass_rows<true, false>(p, s, R, t, accumulate, robust, acc);
  } else {
    if (has_stereo) pass_rows<false, true>(p, s, R, t, accumulate, robust, acc);
    else pass_rows<false, false>(p, s, R, t, accumulate, robust, acc);
  }
}

// One reduce-scatter step over acc[0 .. 2 O): a lane keeps the half whose
// index bit O matches its lane bit and adds the partner's copy of it. A
// template, so every index is a constant and acc stays in registers.
template <int O>
__device__ __forceinline__ void scatter_step(float (&acc)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? acc[j] : acc[j + O];
    const float keep = upper ? acc[j + O] : acc[j];
    acc[j] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// Block sum of acc[32] -> lane k of every warp holds total k, the same
// bits in every warp. part[buf] is written, then buf flips.
__device__ __forceinline__ float block_sum(float (&acc)[32], float (*part)[WARPS][32],
                                           int& buf) {
  const int lane = threadIdx.x & 31;
  // Reduce-scatter in 16 + 8 + 4 + 2 + 1 shuffles: lane k ends with sum k.
  scatter_step<16>(acc, lane);
  scatter_step<8>(acc, lane);
  scatter_step<4>(acc, lane);
  scatter_step<2>(acc, lane);
  scatter_step<1>(acc, lane);
  part[buf][threadIdx.x >> 5][lane] = acc[0];
  __syncthreads();
  float col = part[buf][0][lane];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) col += part[buf][w][lane];
  buf ^= 1;
  return col;
}

__device__ __forceinline__ float total(float col, int k) {
  return __shfl_sync(FULL, col, k);
}

// Index of H[a][c], a <= c, in the 21 upper entries (row by row).
__device__ __forceinline__ constexpr int up(int a, int c) { return a * (11 - a) / 2 + c; }

// Solve (H + lam diag(H) + 1e-9 I) x = b, with H and b the totals held by
// the lanes of cur, by Cholesky; false if a pivot is not positive (the
// plain version's failed factor).
__device__ __forceinline__ bool lm_solve(float cur, float lam, float (&x)[6]) {
  float L[6][6];
  float inv_d[6];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float hjj = total(cur, up(j, j));
    float s = hjj + lam * hjj + 1e-9f;
#pragma unroll
    for (int q = 0; q < j; ++q) s -= L[j][q] * L[j][q];
    ok = ok && s > 0.0f;
    inv_d[j] = rsqrtf(s);   // the solves use 1 / L[j][j] only
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s2 = total(cur, up(j, i));
#pragma unroll
      for (int q = 0; q < j; ++q) s2 -= L[i][q] * L[j][q];
      L[i][j] = s2 * inv_d[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = total(cur, S_B + i);
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[i][q] * y[q];
    y[i] = s * inv_d[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s -= L[q][i] * x[q];
    x[i] = s * inv_d[i];
  }
  return ok;
}

// exp of [omega, upsilon] applied on the left: (R, t) <- exp(xi) (R, t),
// with ops/lie.py's coefficients and small-angle branches; one rsqrt gives
// theta and stands in for two of the three divisions.
__device__ __forceinline__ void se3_left_update(const float (&xi)[6], const float (&R)[9],
                                                const float (&t)[3], float (&Rn)[9],
                                                float (&tn)[3]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float q = theta2 + 1e-16f;
  const float inv_theta = rsqrtf(q);
  const float theta = q * inv_theta;
  const bool small = theta2 < 1e-8f;
  // sincospif has no slow path for huge arguments (sincosf's keeps a local
  // array, a stack frame here); the scaling rounds once.
  float s, c;
  sincospif(theta * 0.318309886f, &s, &c);
  const float ka = small ? 1.0f - theta2 * (1.0f / 6.0f) : s * inv_theta;
  const float kb = small ? 0.5f - theta2 * (1.0f / 24.0f) : (1.0f - c) * (inv_theta * inv_theta);
  const float kc = small ? 1.0f / 6.0f - theta2 * (1.0f / 120.0f)
                         : (theta - s) / (theta2 * theta + 1e-8f);
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float dR[9], J[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = 3 * i + j;
      const float w2k = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
      const float eye = i == j ? 1.0f : 0.0f;
      dR[k] = eye + ka * W[k] + kb * w2k;
      J[k] = eye + kb * W[k] + kc * w2k;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dt = J[3 * i] * xi[3] + J[3 * i + 1] * xi[4] + J[3 * i + 2] * xi[5];
    tn[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] + dt;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j] + dR[3 * i + 2] * R[6 + j];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
pose_lm_kernel(Problem p, const float* __restrict__ R0, const float* __restrict__ t0,
               int n_rounds, int iters, float* __restrict__ pose_out,
               long long* __restrict__ n_inliers_out) {
  extern __shared__ float stage_mem[];
  __shared__ float part[2][WARPS][32];
  const int n = p.staged;
  const Stage s{stage_mem, stage_mem + n, stage_mem + 2 * n, stage_mem + 3 * n,
                stage_mem + 4 * n, stage_mem + 5 * n, stage_mem + 6 * n,
                reinterpret_cast<uint8_t*>(stage_mem + 7 * n)};

  // Stage the problem: coalesced reads of the [O, 3] arrays, split into
  // columns. Every row starts active iff valid.
  for (int e = threadIdx.x; e < 3 * n; e += THREADS) {
    const int i = e / 3, c = e - 3 * i;
    (c == 0 ? s.X : c == 1 ? s.Y : s.Z)[i] = __ldg(p.points + e);
    (c == 0 ? s.u : c == 1 ? s.v : s.ur)[i] = __ldg(p.uvr + e);
  }
  int stereo_rows = 0;
  for (int i = threadIdx.x; i < p.o; i += THREADS) {
    const bool valid = __ldg(p.valid + i) != 0;
    const bool stereo = __ldg(p.stereo + i) != 0;
    stereo_rows |= valid && stereo;
    if (i < n) {
      s.info[i] = __ldg(p.info + i);
      s.flag[i] = (valid ? (VALID | ACTIVE) : 0) | (stereo ? STEREO : 0);
    } else {
      p.inliers[i] = valid ? 1 : 0;
    }
  }
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = __ldg(R0 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = __ldg(t0 + k);
  const bool has_stereo = __syncthreads_or(stereo_rows) != 0;

  // Work done, for the caller's operation count.
  float n_evals = 0.0f, obs_evals = 0.0f, rounds = 0.0f;
  float acc[32];
  float col = 0.0f;
  int buf = 0;
  bool settled = false;
  for (int rnd = 0;; ++rnd) {
    // Round rnd's first pass reclassifies at the pose round rnd - 1 left
    // (its active set) and evaluates there; after the last round it only
    // classifies.
    const bool last = rnd >= n_rounds;
    const bool robust = rnd < n_rounds - 1;
    pass(p, s, R, t, rnd > 0, !last, robust, has_stereo, acc);
    col = block_sum(acc, part, buf);
    if (last) break;
    // A settled start with an unchanged active set: this round and every
    // later one change nothing.
    if (rnd > 0 && settled && total(col, S_CHANGED) == 0.0f) break;
    float cur = col;
    float cost = total(cur, S_COST);
    const float n_active = total(cur, S_COUNT);
    n_evals += 1.0f;
    obs_evals += n_active;
    rounds += 1.0f;
    float lam = 1e-3f;
    bool converged = false;
    for (int it = 0; it < iters && !converged && lam < 1e8f; ++it) {
      float x[6];
      bool accept = false;
      float step2 = 0.0f;
      if (lm_solve(cur, lam, x)) {
        float xi[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          xi[k] = -x[k];
          step2 += xi[k] * xi[k];
        }
        float Rn[9], tn[3];
        se3_left_update(xi, R, t, Rn, tn);
        pass(p, s, Rn, tn, false, true, robust, has_stereo, acc);
        col = block_sum(acc, part, buf);
        n_evals += 1.0f;
        obs_evals += n_active;
        const float new_cost = total(col, S_COST);
        accept = new_cost < cost;
        if (accept) {
#pragma unroll
          for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
          for (int k = 0; k < 3; ++k) t[k] = tn[k];
          cur = col;
          cost = new_cost;
        }
      }
      lam = accept ? lam * 0.5f : lam * 4.0f;
      converged = accept && step2 < STEP_EPS;
    }
    settled = converged || lam >= 1e8f;
  }
  // col is the last classification: its active count is the inlier count.
  const float n_inliers = total(col, S_COUNT);

  for (int i = threadIdx.x; i < n; i += THREADS) p.inliers[i] = (s.flag[i] & ACTIVE) ? 1 : 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) pose_out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) pose_out[9 + k] = t[k];
    pose_out[12] = n_evals;
    pose_out[13] = obs_evals;
    pose_out[14] = rounds;
    *n_inliers_out = (long long)n_inliers;
  }
}

}  // namespace

extern "C" int pose_lm_launch(
    const void* R0, const void* t0, const void* points, const void* uvr,
    const void* inv_sigma2, const void* is_stereo, const void* valid, int o,
    float fx, float fy, float cx, float cy, float bf, int n_rounds, int iters,
    void* pose_out, void* inliers_out, void* n_inliers_out, void* stream) {
  Problem p;
  p.points = (const float*)points;
  p.uvr = (const float*)uvr;
  p.info = (const float*)inv_sigma2;
  p.stereo = (const uint8_t*)is_stereo;
  p.valid = (const uint8_t*)valid;
  p.inliers = (uint8_t*)inliers_out;
  p.o = o;
  p.staged = o < MAX_STAGED ? o : MAX_STAGED;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.bf = bf;
  const int smem = p.staged * BYTES_PER_OBS;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  pose_lm_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      p, (const float*)R0, (const float*)t0, n_rounds, iters, (float*)pose_out,
      (long long*)n_inliers_out);
  return (int)cudaGetLastError();
}
