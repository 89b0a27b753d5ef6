// Whole-solve Levenberg-Marquardt PnP, one thread block cluster per solve.
//
// Replaces the TPU kernel polychase_tpu/kernels/pnp_pallas.py::_make_kernel.
// It computes what that kernel and the plain version
// (polychase_tpu_torch/engine/pnp.py::solve_arrays) compute: pinhole
// residuals and Jacobians with a 1e18 residual for points behind the camera,
// IRLS weights (Trivial, Huber, Cauchy), a 6x6 (pose) or 9x9 (pose + fy with
// fx = aspect*fy, cx, cy; gated on > 3 valid points and clamped to the FOV
// bounds and the image) normal system, a damped Jacobi-equilibrated
// Cholesky solve, a post-multiplied quaternion retraction, the Nielsen
// lambda schedule, the gradient / step / lambda-saturation / function_tol
// exits, and the final inlier ratio.
//
// Layout: params (S, 16) f32 = [q(4) t(3) fx fy cx cy aspect w h sign
// max_inlier_error]; the points where the caller holds them: X (S, N, 3)
// f32, x (S, N, 2) f32, weights (S, N) f32, mask (S, N) bool, all
// contiguous; out (S, 19) f32 = [q(4) t(3) fx fy cx cy iterations
// initial_cost cost lambda invalid_steps step_norm grad_norm inlier_ratio].
//
// What bounds it on the card: latency.  A solve is a chain of LM
// iterations, each a pass over the points, a reduction of its sums and a
// small serial step (the n x n factor, the retraction, the decisions); the
// main path runs one solve at a time, so nothing hides that chain.  The
// design shortens each link:
//
// - One thread block cluster of C blocks per solve (C in 1..16, chosen by
//   the wrapper's launch_shape), each block owning a contiguous slice of the
//   points, so one pass spreads over C SMs.
// - Each block copies its slice into shared memory once (cp.async) and
//   compacts its valid points to the front; every pass reads them there,
//   two points a thread at a time so that their chains of divisions and
//   square roots overlap.  A slice longer than kStageMax points is streamed
//   from global memory (L2), mask and all, instead.
// - One pass per LM iteration, at the trial state: the trial cost, the
//   normal-equation sums and the inlier count in one loop.  On accept they
//   become the current state's; on reject they are dropped (the state, and
//   so its normal equations, is unchanged).  The first pass, at the warm
//   start, also counts the valid points; the carried inlier count of the
//   accepted state replaces a final inlier pass.
// - One reduction round per pass: a reduce-scatter over each warp's lanes
//   (31 shuffles for 32 sums, 63 for 64), the warps summed through the
//   block's shared memory, and each block's sums pushed through distributed
//   shared memory into a slot of every block before one
//   cluster.sync().  Every block then sums the C slots in rank order and
//   decides redundantly, which gives the same bits in every block (the
//   slots are double-buffered, so pass k+1's pushes cannot land before
//   every rank has read pass k's).  Rank 0 alone deciding and writing the
//   trial state into every block before a second cluster.sync() was slower
//   on the card (PERF.md).  Thread 0 of each block runs the serial step on
//   registers; the loop's control flow is uniform over the cluster.
// - Solves of a few dozen points run in one block of one warp: its
//   reduction is the reduce-scatter alone, and its barriers __syncwarp().
//
// What bounds it after this design: the serial step, whose factor is n + 1
// dependent pairs of an IEEE square root and reciprocal (the equilibration,
// then one per column; spreading the factor over a warp puts a shuffle
// between each pivot and its column, so it cannot shorten that chain), then
// the cluster barrier, then the pass.
//
// Numerics: f32 throughout, built without --use_fast_math so that sqrtf,
// division, log1pf and denormals keep their IEEE meaning.  The 1e18 behind
// residual squares to ~1e36, so a few hundred behind-camera points overflow
// the Trivial-loss cost to inf, and the step is then rejected, as in the
// reference.  Sums are taken in another order than the plain version's, so
// iteration counts can differ at exact decision boundaries.

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBehind = 1e18f;
constexpr int kTrivial = 0;
constexpr int kHuber = 1;
constexpr int kCauchy = 2;
constexpr int kMaxCluster = 16;
// Points a block stages in shared memory: X (12 bytes), x (8), weight (4)
// and mask (1) each, 204,800 bytes of the 227 KB a block may use.
constexpr int kStageMax = 8192;
constexpr int kPointBytes = 25;
constexpr int kBlockThreads = 256;
constexpr int kWarpThreads = 32;

struct Options {
  int max_iterations;
  int opt_f;
  int opt_pp;
  float loss_scale;
  float thr2;      // loss_scale^2, rounded from double on the host
  float inv_thr2;  // 1 / loss_scale^2, rounded from double on the host
  float gradient_tol;
  float step_tol;
  float initial_lambda;
  float min_lambda;
  float max_lambda;
  float function_tol;
  float f_low_cv_scale;   // 1 / tan(160 deg / 2), f32
  float f_high_cv_scale;  // 1 / tan(15 deg / 2), f32
};

// jnp.clip: min(max(x, lo), hi), NaN in gives NaN out (fminf/fmaxf alone
// would drop it).
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

template <int LOSS>
__device__ __forceinline__ float loss_value(float r2, const Options& o) {
  if (LOSS == kTrivial) return r2;
  if (LOSS == kHuber) {
    float r = sqrtf(fmaxf(r2, 0.0f));
    return r2 <= o.thr2 ? r2 : o.loss_scale * (2.0f * r - o.loss_scale);
  }
  return o.thr2 * log1pf(r2 / o.thr2);
}

template <int LOSS>
__device__ __forceinline__ float loss_weight(float r2, const Options& o) {
  if (LOSS == kTrivial) return 1.0f;
  if (LOSS == kHuber) {
    float r = sqrtf(fmaxf(r2, 1e-30f));
    return r2 <= o.thr2 ? 1.0f : o.loss_scale / r;
  }
  return fmaxf(1.18e-38f, 1.0f / (1.0f + r2 * o.inv_thr2));
}

// loss_value and loss_weight of one squared residual.  Huber's two square
// roots are one: they differ only below r2 = 1e-30, where r2 <= thr2 for
// any loss scale above 1e-15 and neither is used.
template <int LOSS>
__device__ __forceinline__ void loss_value_weight(float r2, const Options& o, float& value,
                                                  float& weight) {
  if (LOSS == kHuber) {
    const float r = sqrtf(fmaxf(r2, 1e-30f));
    const bool inner = r2 <= o.thr2;
    value = inner ? r2 : o.loss_scale * (2.0f * r - o.loss_scale);
    weight = inner ? 1.0f : o.loss_scale / r;
  } else {
    value = loss_value<LOSS>(r2, o);
    weight = loss_weight<LOSS>(r2, o);
  }
}

__device__ __forceinline__ void quat_to_mat(const float* q, float* r) {
  float xx = q[1] * q[1], yy = q[2] * q[2], zz = q[3] * q[3];
  float xy = q[1] * q[2], xz = q[1] * q[3], yz = q[2] * q[3];
  float wx = q[0] * q[1], wy = q[0] * q[2], wz = q[0] * q[3];
  r[0] = 1.0f - 2.0f * (yy + zz); r[1] = 2.0f * (xy - wz); r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz); r[4] = 1.0f - 2.0f * (xx + zz); r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy); r[7] = 2.0f * (yz + wx); r[8] = 1.0f - 2.0f * (xx + yy);
}

// q * exp(dw): right-multiplicative SO(3) retraction, Taylor form near 0.
__device__ void quat_step_post(const float* a, const float* dw, float* out) {
  float sq = dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2];
  bool small = sq < 1e-12f;
  float angle = sqrtf(small ? 1.0f : sq);
  float half = 0.5f * angle;
  float sh, ch;
  sincosf(half, &sh, &ch);
  float e0 = small ? 1.0f - sq / 8.0f : ch;
  float k = small ? 0.5f - sq / 48.0f : sh / angle;
  float e1 = k * dw[0], e2 = k * dw[1], e3 = k * dw[2];
  out[0] = a[0] * e0 - a[1] * e1 - a[2] * e2 - a[3] * e3;
  out[1] = a[0] * e1 + a[1] * e0 + a[2] * e3 - a[3] * e2;
  out[2] = a[0] * e2 - a[1] * e3 + a[2] * e0 + a[3] * e1;
  out[3] = a[0] * e3 + a[1] * e2 - a[2] * e1 + a[3] * e0;
}

// Camera parameters of one LM state: q(4) t(3) fx fy cx cy.
struct Cam {
  float v[11];
};

// The sums of one pass: [cost, inliers, valid count, the upper triangle of
// JtJ row by row, Jtr], padded to a multiple of the warp's 32 lanes.
template <int NP>
struct Sums {
  static constexpr int kCost = 0, kInl = 1, kCnt = 2, kNE = 3;
  static constexpr int kN = kNE + NP * (NP + 1) / 2 + NP;  // 30 or 57
  static constexpr int kPad = (kN + 31) / 32 * 32;          // 32 or 64
};

// The LM state of a solve; only thread 0 of a block reads or writes it,
// apart from trial and go, which every thread reads after a barrier.  Its normal equations are kept apart (Shared::ne).
template <int NP>
struct State {
  Cam cur;    // accepted state
  Cam trial;  // state the next pass evaluates
  float cost, lam, v, gn, sn, init_cost, count, inliers;
  float trial_sn, expected;  // of the proposed step
  int iters, invalid, done, trial_ok, go, gate;
};

template <int NP, int THREADS>
struct Shared {
  State<NP> st;
  // The accepted state's normal equations, gated, in the layout of the
  // sums from Sums::kNE on.
  float ne[Sums<NP>::kN - Sums<NP>::kNE];
  float tot[Sums<NP>::kPad];  // the pass's totals
  int valid[THREADS / 32];    // each warp's valid points, while staging
  // Each rank's block sums, pushed here by that rank; double-buffered by
  // the pass's parity.
  float part[THREADS == 32 ? 1 : 2][THREADS == 32 ? 1 : kMaxCluster][Sums<NP>::kPad];
  float warp[THREADS / 32][Sums<NP>::kPad];  // each warp's sums
};

// Reduce-scatter over the 32 lanes of a warp: v[0..M) is summed over the
// lanes, and afterwards v[e] of lane l holds the sum of index (M/32)*l + e
// for e < M/32.  Each step hands half of the live values to the partner
// lane and keeps the other half, so M values cost M - M/32 shuffles.
template <int K, int M>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[M], int lane) {
  if constexpr (K > M / 32) {
    constexpr int H = K / 2;
    constexpr int off = H / (M / 32);
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    reduce_scatter_step<H, M>(v, lane);
  }
}

template <int M>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[M]) {
  reduce_scatter_step<M, M>(v, threadIdx.x & 31);
}

template <int THREADS>
__device__ __forceinline__ void block_sync() {
  if (THREADS == 32)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// What a pass needs of its camera: the rotation, the camera, the
// convention's sign, the aspect, max_inlier_error squared and the loss of a
// point behind the camera (its residual is 1e18 on both axes).
struct Proj {
  float r[9];
  Cam c;
  float sign, aspect, mie2, behind_value;
};

// Adds point i's robust cost, inlier, valid count and weighted normal
// equations at camera P.c (engine/pnp._residuals, _residuals_jac,
// _normal_equations) into v.  The intrinsic Jacobian columns are not gated
// here: thread 0 applies the > 3-point gate to the totals.
template <int NP, int LOSS>
__device__ __forceinline__ void point_sums(const float* __restrict__ X,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w, int i,
                                           const Proj& P, const Options& o,
                                           float (&v)[Sums<NP>::kPad]) {
  using Sm = Sums<NP>;
  const float* r = P.r;
  const float fx = P.c.v[7], fy = P.c.v[8];
  const float x0 = X[3 * i], x1 = X[3 * i + 1], x2 = X[3 * i + 2];
  const float Z0 = r[0] * x0 + r[1] * x1 + r[2] * x2 + P.c.v[4];
  const float Z1 = r[3] * x0 + r[4] * x1 + r[5] * x2 + P.c.v[5];
  const float Z2 = r[6] * x0 + r[7] * x1 + r[8] * x2 + P.c.v[6];
  const bool behind = (P.sign * Z2) < 0.0f;
  const float iz = 1.0f / Z2;
  const float r0 = fx * Z0 * iz + P.c.v[9] - x[2 * i];
  const float r1 = fy * Z1 * iz + P.c.v[10] - x[2 * i + 1];
  const float r2 = r0 * r0 + r1 * r1;
  const float wi = w[i];
  float value, weight;
  loss_value_weight<LOSS>(r2, o, value, weight);
  v[Sm::kCost] += wi * (behind ? P.behind_value : value);
  v[Sm::kInl] += (!behind && r2 < P.mie2) ? 1.0f : 0.0f;
  v[Sm::kCnt] += 1.0f;

  const float gx = fx * iz, gy = fy * iz;
  const float hx = -fx * Z0 * iz * iz, hy = -fy * Z1 * iz * iz;
  const float A00 = gx * r[0] + hx * r[6], A01 = gx * r[1] + hx * r[7];
  const float A02 = gx * r[2] + hx * r[8];
  const float A10 = gy * r[3] + hy * r[6], A11 = gy * r[4] + hy * r[7];
  const float A12 = gy * r[5] + hy * r[8];
  float J0[NP], J1[NP];
  J0[0] = A01 * (-x2) + A02 * x1;
  J0[1] = A00 * x2 + A02 * (-x0);
  J0[2] = A00 * (-x1) + A01 * x0;
  J0[3] = gx; J0[4] = 0.0f; J0[5] = hx;
  J1[0] = A11 * (-x2) + A12 * x1;
  J1[1] = A10 * x2 + A12 * (-x0);
  J1[2] = A10 * (-x1) + A11 * x0;
  J1[3] = 0.0f; J1[4] = gy; J1[5] = hy;
  if (NP == 9) {
    J0[6] = o.opt_f ? P.aspect * Z0 * iz : 0.0f;
    J1[6] = o.opt_f ? Z1 * iz : 0.0f;
    J0[7] = o.opt_pp ? 1.0f : 0.0f;
    J1[7] = 0.0f;
    J0[8] = 0.0f;
    J1[8] = o.opt_pp ? 1.0f : 0.0f;
  }
  const float wl = wi * weight;
  int k = Sm::kNE;
#pragma unroll
  for (int a = 0; a < NP; ++a) {
#pragma unroll
    for (int b = a; b < NP; ++b) v[k++] += wl * (J0[a] * J0[b] + J1[a] * J1[b]);
  }
#pragma unroll
  for (int a = 0; a < NP; ++a) v[k++] += wl * (J0[a] * r0 + J1[a] * r1);
}

// One pass over this thread's points of the block's staged slice, which
// holds only valid points: two points an iteration, so that their chains
// of divisions and square roots overlap.
template <int NP, int LOSS, int THREADS>
__device__ __forceinline__ void pass_staged(const float* __restrict__ X,
                                            const float* __restrict__ x,
                                            const float* __restrict__ w, int nv,
                                            const Proj& P, const Options& o,
                                            float (&v)[Sums<NP>::kPad]) {
  int i = threadIdx.x;
  for (; i + THREADS < nv; i += 2 * THREADS) {
    point_sums<NP, LOSS>(X, x, w, i, P, o, v);
    point_sums<NP, LOSS>(X, x, w, i + THREADS, P, o, v);
  }
  if (i < nv) point_sums<NP, LOSS>(X, x, w, i, P, o, v);
}

// The same over a slice streamed from global memory, mask and all.
template <int NP, int LOSS, int THREADS>
__device__ __forceinline__ void pass_streamed(const float* __restrict__ X,
                                              const float* __restrict__ x,
                                              const float* __restrict__ w,
                                              const uint8_t* __restrict__ m, int cnt,
                                              const Proj& P, const Options& o,
                                              float (&v)[Sums<NP>::kPad]) {
  for (int i = threadIdx.x; i < cnt; i += THREADS)
    if (m[i]) point_sums<NP, LOSS>(X, x, w, i, P, o, v);
}

// The totals' normal equations into (A, b), gated: the intrinsic columns
// zeroed unless more than 3 points are valid; also stored in ne.
template <int NP>
__device__ __forceinline__ void take_normal_equations(const float* __restrict__ tot, bool gate,
                                                      float (&A)[NP][NP], float (&b)[NP],
                                                      float* __restrict__ ne) {
  int k = Sums<NP>::kNE;
#pragma unroll
  for (int a = 0; a < NP; ++a)
#pragma unroll
    for (int c = a; c < NP; ++c) {
      const float s = (NP == 9 && !gate && c >= 6) ? 0.0f : tot[k];
      A[a][c] = A[c][a] = s;
      ne[k++ - Sums<NP>::kNE] = s;
    }
#pragma unroll
  for (int a = 0; a < NP; ++a) {
    b[a] = (NP == 9 && !gate && a >= 6) ? 0.0f : tot[k];
    ne[k++ - Sums<NP>::kNE] = b[a];
  }
}

// The accepted state's normal equations, as take_normal_equations stored.
template <int NP>
__device__ __forceinline__ void load_normal_equations(const float* __restrict__ ne,
                                                      float (&A)[NP][NP], float (&b)[NP]) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < NP; ++a)
#pragma unroll
    for (int c = a; c < NP; ++c) A[a][c] = A[c][a] = ne[k++];
#pragma unroll
  for (int a = 0; a < NP; ++a) b[a] = ne[k++];
}

// Damped, Jacobi-equilibrated Cholesky solve of (JtJ, Jtr).  Returns false
// (and a zero step) when any factor or step entry is not finite
// (engine/levmarq.damped_cholesky_solve).
// Every loop is unrolled, so that the factor lives in registers: this
// dependent chain of divisions and square roots is the longest link of an
// LM iteration.
template <int NP>
__device__ __forceinline__ bool chol_solve(const float (&A)[NP][NP], const float (&b)[NP],
                                           float lam, float (&step)[NP]) {
  float d[NP], As[NP][NP], L[NP][NP], y[NP], x[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float dd = clip(A[i][i], 1e-6f, 1e32f) * (1.0f + lam);
    d[i] = __frcp_rn(sqrtf(dd));
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    As[i][i] = 1.0f;
#pragma unroll
    for (int j = i + 1; j < NP; ++j) As[i][j] = A[i][j] * d[i] * d[j];
  }
  // inv[j] = 1 / L[j][j], correctly rounded (__frcp_rn is 1.0f / x) once
  // per column; the two substitutions multiply by it, so that their chains
  // hold no division.
  float inv[NP];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float s = As[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
    ok = ok && isfinite(L[j][j]);
    inv[j] = __frcp_rn(L[j][j]);
#pragma unroll
    for (int i = j + 1; i < NP; ++i) {
      float t = As[j][i];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv[j];
      ok = ok && isfinite(L[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float s = b[i] * d[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NP; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    step[i] = -(x[i] * d[i]);
    ok = ok && isfinite(step[i]);
  }
  if (!ok)
#pragma unroll
    for (int i = 0; i < NP; ++i) step[i] = 0.0f;
  return ok;
}

// The per-solve constants of the step: the fixed intrinsics and the FOV
// bounds of the focal (camera.intrinsics_bounds; OpenGL focals are
// negative, so the bounds flip sign).
struct Fixed {
  float aspect, width, height, f_low, f_high;
};

// The serial step of an LM iteration, on one thread, from the totals of the
// pass just made at camera c: on the first pass (at the warm start) the
// initial state; after a later one the accept / reject decision and the
// exits; then, if the solve goes on, the next step and its trial state.
// Sets go.  It works on a register copy of the state, written back once:
// on the shared copy every load after a store would wait for it.
template <int NP>
__device__ __forceinline__ void decide(State<NP>& shared_st, float* __restrict__ ne,
                                       const float* __restrict__ tot, bool first,
                                       const Cam& c, const Fixed& fx, const Options& o) {
  using Sm = Sums<NP>;
  State<NP> st = shared_st;
  bool take = first, done = false;
  if (first) {
    st.count = tot[Sm::kCnt];
    st.gate = st.count > 3.0f;
    st.cur = c;
    st.inliers = tot[Sm::kInl];
    st.cost = tot[Sm::kCost];
    st.init_cost = st.cost;
    st.lam = o.initial_lambda;
    st.v = 2.0f;
    st.sn = -1.0f;
    st.iters = 0;
    st.invalid = 0;
  } else {
    const float cost_new = tot[Sm::kCost];
    const bool ok = st.trial_ok;
    const float cost = st.cost, lam = st.lam, v = st.v;
    const bool improved = ok && (cost_new < cost);
    const bool tiny = ok && (st.trial_sn < o.step_tol);
    const float actual = cost_new - cost;
    const float rho = actual / st.expected;
    const float u = 2.0f * rho - 1.0f;
    const float factor = fmaxf(1.0f / 3.0f, 1.0f - u * u * u);
    const float lam_accept =
        rho > 0.0f ? clip(lam * factor, o.min_lambda, o.max_lambda) : lam;
    const bool lam_saturated = lam >= o.max_lambda;
    const float lam_reject = fminf(o.max_lambda, lam * v);
    const bool accept = improved && !tiny;
    done = tiny || (!improved && !tiny && lam_saturated);
    if (o.function_tol > 0.0f) {
      const bool stagnated = fabsf(actual) <= o.function_tol * cost;
      done = done || ((accept || (!improved && !tiny)) && stagnated);
    }
    if (accept) {
      // The pass was at the trial state: its sums are the new state's.
      st.cur = st.trial;
      st.cost = cost_new;
      st.lam = lam_accept;
      st.v = 2.0f;
      st.inliers = tot[Sm::kInl];
    } else {
      st.lam = lam_reject;
      st.v = 2.0f * v;
    }
    st.invalid += (improved || tiny) ? 0 : 1;
    st.sn = st.trial_sn;
    st.iters += 1;
    take = accept;
  }
  // A rejected step leaves the state, and so its normal equations, as they
  // were; after the first pass or an accepted step they are the pass's.
  float A[NP][NP], b[NP];
  if (take) {
    take_normal_equations<NP>(tot, st.gate, A, b, ne);
    float g = 0.0f;
#pragma unroll
    for (int a = 0; a < NP; ++a) g += b[a] * b[a];
    st.gn = sqrtf(g);
    done = (!first && done) || st.gn < o.gradient_tol;
  } else {
    load_normal_equations<NP>(ne, A, b);
  }
  st.done = done;
  st.go = !st.done && st.iters < o.max_iterations;
  if (!st.go) {
    shared_st = st;
    return;
  }

  float step[NP];
  st.trial_ok = chol_solve<NP>(A, b, st.lam, step);
  float sn2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NP; ++i) sn2 += step[i] * step[i];
  st.trial_sn = sqrtf(sn2);
  // engine/pnp._step: retraction, clamped intrinsics, gated.
  Cam t = st.cur;
  quat_step_post(st.cur.v, step, t.v);
  t.v[4] = st.cur.v[4] + step[3];
  t.v[5] = st.cur.v[5] + step[4];
  t.v[6] = st.cur.v[6] + step[5];
  if (NP == 9 && st.gate) {
    if (o.opt_f) {
      float fy = clip(st.cur.v[8] + step[6], fx.f_low, fx.f_high);
      t.v[8] = fy;
      t.v[7] = clip(fy * fx.aspect, fx.f_low, fx.f_high);
    }
    if (o.opt_pp) {
      t.v[9] = clip(st.cur.v[9] + step[7], 0.0f, fx.width);
      t.v[10] = clip(st.cur.v[10] + step[8], 0.0f, fx.height);
    }
  }
  st.trial = t;
  // Predicted change step . (2 Jtr + JtJ step), for the gain ratio.
  float expected = 0.0f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float Ai = 0.0f;
#pragma unroll
    for (int j = 0; j < NP; ++j) Ai += A[i][j] * step[j];
    expected += step[i] * (2.0f * b[i] + Ai);
  }
  st.expected = expected;
  shared_st = st;
}

// Grid: S clusters of C blocks (C = 1 for THREADS = 32); rank r of solve s
// owns points [r * per_block, min(n, (r + 1) * per_block)).
template <int NP, int LOSS, int THREADS>
__global__ void __launch_bounds__(THREADS)
    pnp_lm_kernel(const float* __restrict__ params, const float* __restrict__ Xg,
                  const float* __restrict__ xg, const float* __restrict__ wg,
                  const uint8_t* __restrict__ mg, float* __restrict__ out, int n,
                  int per_block, int staged, Options o) {
  using Sm = Sums<NP>;
  constexpr int E = Sm::kPad / 32;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared<NP, THREADS> sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = params + (size_t)s * 16;

  const int lo = rank * per_block;
  const int cnt = max(0, min(n, lo + per_block) - lo);
  const size_t first_pt = (size_t)s * n + lo;
  const float* gX = Xg + first_pt * 3;
  const float* gx = xg + first_pt * 2;
  const float* gw = wg + first_pt;
  const uint8_t* gm = mg + first_pt;
  float* sX = reinterpret_cast<float*>(dyn);
  float* sx = sX + 3 * per_block;
  float* sw = sx + 2 * per_block;
  uint8_t* sm = reinterpret_cast<uint8_t*>(sw + per_block);
  int nv = 0;  // valid points of the staged slice
  if (staged) {
    for (int j = tid; j < 3 * cnt; j += THREADS) cp_async4(sX + j, gX + j);
    for (int j = tid; j < 2 * cnt; j += THREADS) cp_async4(sx + j, gx + j);
    for (int j = tid; j < cnt; j += THREADS) cp_async4(sw + j, gw + j);
    for (int j = tid; j < cnt; j += THREADS) sm[j] = gm[j];
    cp_async_wait_all();
    block_sync<THREADS>();
    // Compact the valid points to the front of the slice, in order, a
    // block-wide chunk at a time: a point only moves down, past points of
    // its own chunk or earlier ones, which were all read before the move.
    for (int j0 = 0; j0 < cnt; j0 += THREADS) {
      const int i = j0 + tid;
      const bool valid = i < cnt && sm[i];
      float pt[6];
      if (valid) {
        pt[0] = sX[3 * i]; pt[1] = sX[3 * i + 1]; pt[2] = sX[3 * i + 2];
        pt[3] = sx[2 * i]; pt[4] = sx[2 * i + 1]; pt[5] = sw[i];
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) sh.valid[warp] = __popc(ballot);
      block_sync<THREADS>();
      int dst = nv + __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        dst += w < warp ? sh.valid[w] : 0;
        total += sh.valid[w];
      }
      block_sync<THREADS>();
      if (valid) {
        sX[3 * dst] = pt[0]; sX[3 * dst + 1] = pt[1]; sX[3 * dst + 2] = pt[2];
        sx[2 * dst] = pt[3]; sx[2 * dst + 1] = pt[4]; sw[dst] = pt[5];
      }
      nv += total;
    }
  }
  const float sign = p[14], aspect = p[11], mie = p[15];
  Fixed fixed;
  {
    const float half_w = p[12] * 0.5f;
    const float f_low_cv = half_w * o.f_low_cv_scale;
    const float f_high_cv = half_w * o.f_high_cv_scale;
    const bool is_gl = sign < 0.0f;
    fixed = Fixed{aspect, p[12], p[13], is_gl ? -f_high_cv : f_low_cv,
                  is_gl ? -f_low_cv : f_high_cv};
  }
  Proj P;
  for (int k = 0; k < 11; ++k) P.c.v[k] = p[k];
  P.sign = sign;
  P.aspect = aspect;
  P.mie2 = mie * mie;
  {
    const float behind2 = kBehind * kBehind + kBehind * kBehind;
    float weight;
    loss_value_weight<LOSS>(behind2, o, P.behind_value, weight);
  }
  block_sync<THREADS>();

  for (int pass = 0;; ++pass) {
    float v[Sm::kPad];
#pragma unroll
    for (int k = 0; k < Sm::kPad; ++k) v[k] = 0.0f;
    quat_to_mat(P.c.v, P.r);
    if (staged)
      pass_staged<NP, LOSS, THREADS>(sX, sx, sw, nv, P, o, v);
    else
      pass_streamed<NP, LOSS, THREADS>(gX, gx, gw, gm, cnt, P, o, v);
    warp_reduce_scatter<Sm::kPad>(v);
    if (THREADS == 32) {
#pragma unroll
      for (int e = 0; e < E; ++e) sh.tot[E * lane + e] = v[e];
      __syncwarp();
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) sh.warp[warp][E * lane + e] = v[e];
      __syncthreads();
      const int buf = pass & 1;
      if (tid < Sm::kN) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) acc += sh.warp[w][tid];
        if (C == 1) {
          sh.tot[tid] = acc;
        } else {
          // Push this block's sums into the slot of its rank in every
          // block: remote stores do not wait, and after the cluster
          // barrier each block reads only its own shared memory.
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            if (r < C) *cluster.map_shared_rank(&sh.part[buf][rank][tid], r) = acc;
        }
      }
      if (C > 1) {
        cluster.sync();
        if (tid < Sm::kN) {
          float acc = 0.0f;
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            if (r < C) acc += sh.part[buf][r][tid];
          sh.tot[tid] = acc;
        }
      }
      __syncthreads();
    }
    if (tid == 0) decide<NP>(sh.st, sh.ne, sh.tot, pass == 0, P.c, fixed, o);
    block_sync<THREADS>();
    if (!sh.st.go) break;
    P.c = sh.st.trial;
  }
  // No block may exit while another can still read its shared memory.
  if (THREADS != 32 && C > 1) cluster.sync();

  if (rank == 0 && tid == 0) {
    const State<NP>& st = sh.st;
    float* o_row = out + (size_t)s * 19;
    for (int k = 0; k < 11; ++k) o_row[k] = st.cur.v[k];
    o_row[11] = (float)st.iters;
    o_row[12] = st.init_cost;
    o_row[13] = st.cost;
    o_row[14] = st.lam;
    o_row[15] = (float)st.invalid;
    o_row[16] = st.sn;
    o_row[17] = st.gn;
    // Inlier ratio at max_inlier_error (cpp/pnp/solvers.cc:30-47).
    o_row[18] = mie > 0.0f ? st.inliers / fmaxf(st.count, 1.0f) : 0.0f;
  }
}

size_t stage_bytes(int per_block, int staged) {
  return staged ? ((size_t)per_block * kPointBytes + 15) / 16 * 16 : 0;
}

// Allows the largest staged slice and, for blocks that form clusters,
// cluster sizes above the portable 8; once per instantiation and device.
// A function's attributes belong to the device that is current when they
// are set, so a process that launches on several cards sets them on each.
constexpr int kMaxDevices = 64;

template <int NP, int LOSS, int THREADS>
cudaError_t prepare() {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  auto kern = pnp_lm_kernel<NP, LOSS, THREADS>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)stage_bytes(kStageMax, 1));
  if (e == cudaSuccess && THREADS != 32)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return e;
}

cudaLaunchConfig_t config(int blocks, int threads, int cluster, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Launch {
  const float* params;
  const float* X;
  const float* x;
  const float* w;
  const uint8_t* m;
  float* out;
  int S, n, cluster, per_block, staged;
};

template <int NP, int LOSS, int THREADS>
cudaError_t launch(const Launch& a, const Options& o, cudaStream_t stream) {
  cudaError_t e = prepare<NP, LOSS, THREADS>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(a.S * a.cluster, THREADS, a.cluster,
                                  stage_bytes(a.per_block, a.staged), stream, attr);
  e = cudaLaunchKernelEx(&cfg, pnp_lm_kernel<NP, LOSS, THREADS>, a.params, a.X, a.x, a.w,
                         a.m, a.out, a.n, a.per_block, a.staged, o);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NP, int LOSS>
cudaError_t launch_threads(const Launch& a, int threads, const Options& o,
                           cudaStream_t stream) {
  if (threads == kWarpThreads) return launch<NP, LOSS, kWarpThreads>(a, o, stream);
  return launch<NP, LOSS, kBlockThreads>(a, o, stream);
}

template <int NP>
cudaError_t launch_loss(const Launch& a, int loss, int threads, const Options& o,
                        cudaStream_t stream) {
  switch (loss) {
    case kTrivial: return launch_threads<NP, kTrivial>(a, threads, o, stream);
    case kHuber: return launch_threads<NP, kHuber>(a, threads, o, stream);
    case kCauchy: return launch_threads<NP, kCauchy>(a, threads, o, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The largest cluster size <= want that the card can schedule for blocks of
// kBlockThreads threads with smem bytes of staged points.
template <int NP, int LOSS>
int max_cluster(int want, size_t smem) {
  if (prepare<NP, LOSS, kBlockThreads>() != cudaSuccess) return -1;
  for (int c = want; c > 1; c >>= 1) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(c, kBlockThreads, c, smem, 0, attr);
    int active = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(
        &active, pnp_lm_kernel<NP, LOSS, kBlockThreads>, &cfg);
    if (e != cudaSuccess) cudaGetLastError();
    if (e == cudaSuccess && active > 0) return c;
  }
  return 1;
}

bool valid_shape(int n, int cluster, int threads, int per_block, int staged) {
  const bool pow2 = cluster >= 1 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0;
  if (!pow2 || per_block < 0 || (long long)cluster * per_block < n) return false;
  if (staged && per_block > kStageMax) return false;
  return threads == kBlockThreads || (threads == kWarpThreads && cluster == 1);
}

}  // namespace

// Plain C entry points, loaded with ctypes.

// Launches S solves as S clusters of `cluster` blocks of `threads` threads
// (32: one warp, cluster 1; or 256), each block owning `per_block` points,
// staged in shared memory when `staged`.  Returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int pnp_lm_launch(const float* params, const float* X, const float* x,
                             const float* w, const uint8_t* mask, float* out, int S, int n,
                             int cluster, int threads, int per_block, int staged,
                             int np_, int loss, int opt_f, int opt_pp,
                             int max_iterations, float loss_scale, float thr2,
                             float inv_thr2, float gradient_tol, float step_tol,
                             float initial_lambda, float min_lambda, float max_lambda,
                             float function_tol, float f_low_cv_scale,
                             float f_high_cv_scale, void* stream) {
  if (S <= 0) return 0;
  if (!valid_shape(n, cluster, threads, per_block, staged)) return (int)cudaErrorInvalidValue;
  Options o{max_iterations, opt_f,          opt_pp,     loss_scale,   thr2,
            inv_thr2,       gradient_tol,   step_tol,   initial_lambda, min_lambda,
            max_lambda,     function_tol,   f_low_cv_scale, f_high_cv_scale};
  Launch a{params, X, x, w, mask, out, S, n, cluster, per_block, staged};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (np_ == 6) return (int)launch_loss<6>(a, loss, threads, o, st);
  if (np_ == 9) return (int)launch_loss<9>(a, loss, threads, o, st);
  return (int)cudaErrorInvalidValue;
}

// The largest cluster size <= want (a power of two up to 16) that the card
// can schedule for a block of 256 threads with `per_block` points, staged
// or not; -1 on an error.
extern "C" int pnp_lm_max_cluster(int np_, int loss, int want, int per_block, int staged) {
  const size_t smem = stage_bytes(per_block, staged);
  switch (np_ * 3 + loss) {
    case 18: return max_cluster<6, kTrivial>(want, smem);
    case 19: return max_cluster<6, kHuber>(want, smem);
    case 20: return max_cluster<6, kCauchy>(want, smem);
    case 27: return max_cluster<9, kTrivial>(want, smem);
    case 28: return max_cluster<9, kHuber>(want, smem);
    case 29: return max_cluster<9, kCauchy>(want, smem);
    default: return -1;
  }
}
