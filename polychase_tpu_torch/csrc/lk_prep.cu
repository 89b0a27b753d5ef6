// K2: the LK source-frame prep of one pyramid level, for every feature.
//
// Replaces the TPU kernel polychase_tpu/kernels/lk_pallas.py
// ::_make_extract_kernel together with the XLA tail of lk_prepare_level
// (bilinear blend, normal matrix, gate).  The TPU extracted the integer
// windows alone and left the blend to XLA because image, dx and dy did not
// fit its VMEM together; here one thread per feature does all of it:
//
//   1. the (win+1)² integer window at floor(pt - (win-1)/2) of the padded
//      image, its Scharr dx and its Scharr dy (origin clamped into the
//      buffer, as the reference's dynamic_slice clamps it);
//   2. the bilinear blend of each to win×win, written feature-minor
//      (plane, win*win, N), so a warp's stores and K3's later reads of the
//      template coalesce;
//   3. A11, A12, A22 scaled by 2^-20, the gate (bounds, min eigenvalue >=
//      thr, det >= FLT_EPSILON), invD and ok.
//
// What bounds it on the card: the window reads, 3·2·(win+1)·win loads of
// scattered rows per feature that the L1 and L2 caches serve (spatially
// sorted features share rows).  It runs once per level per source frame,
// shared by every target.  The blend is written with round-to-nearest
// intrinsics so nvcc does not contract it into FMAs: the patches then
// equal the plain torch version's to the bit, and only the order of the
// A sums differs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kFltScale = 1.0f / (1 << 20);
constexpr float kFltEpsilon = 1.1920929e-07f;

// Window origin in the padded buffer, clamped to [0, hi]; NaN goes to 0.
__device__ __forceinline__ int clamp_origin(float v, int hi) {
    return static_cast<int>(fminf(fmaxf(v, 0.0f), static_cast<float>(hi)));
}

__device__ __forceinline__ float blend(float w00, float w01, float w10,
                                       float w11, float p00, float p01,
                                       float p10, float p11) {
    return __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(w00, p00), __fmul_rn(w01, p01)),
                  __fmul_rn(w10, p10)),
        __fmul_rn(w11, p11));
}

__global__ void __launch_bounds__(128)
lk_prep_kernel(const float* __restrict__ img, const float* __restrict__ gx,
               const float* __restrict__ gy, const float* __restrict__ pts,
               float* __restrict__ patches, float* __restrict__ vec,
               unsigned char* __restrict__ ok, int n, int hp, int wp, int h,
               int w, int win, float min_eig_thr) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float half = (win - 1) * 0.5f;
    const int pad = win + 2;
    const float px = pts[2 * i], py = pts[2 * i + 1];
    const float fx = floorf(px - half), fy = floorf(py - half);
    const float ax = px - half - fx, ay = py - half - fy;
    const bool in_bounds = fx >= -win && fx < w && fy >= -win && fy < h;
    const int x0 = clamp_origin(fx + pad, wp - (win + 1));
    const int y0 = clamp_origin(fy + pad, hp - (win + 1));
    const float w00 = __fmul_rn(1.0f - ax, 1.0f - ay);
    const float w01 = __fmul_rn(ax, 1.0f - ay);
    const float w10 = __fmul_rn(1.0f - ax, ay);
    const float w11 = __fmul_rn(ax, ay);

    const size_t plane = static_cast<size_t>(win) * win * n;
    float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
    for (int r = 0; r < win; ++r) {
        const size_t row = static_cast<size_t>(y0 + r) * wp + x0;
        const float* i0 = img + row;
        const float* x0p = gx + row;
        const float* y0p = gy + row;
        float ia = __ldg(i0), ib = __ldg(i0 + wp);
        float xa = __ldg(x0p), xb = __ldg(x0p + wp);
        float ya = __ldg(y0p), yb = __ldg(y0p + wp);
        for (int c = 0; c < win; ++c) {
            const float ia1 = __ldg(i0 + c + 1), ib1 = __ldg(i0 + wp + c + 1);
            const float xa1 = __ldg(x0p + c + 1), xb1 = __ldg(x0p + wp + c + 1);
            const float ya1 = __ldg(y0p + c + 1), yb1 = __ldg(y0p + wp + c + 1);
            const float I = blend(w00, w01, w10, w11, ia, ia1, ib, ib1);
            const float X = blend(w00, w01, w10, w11, xa, xa1, xb, xb1);
            const float Y = blend(w00, w01, w10, w11, ya, ya1, yb, yb1);
            const size_t o = static_cast<size_t>(r * win + c) * n + i;
            patches[o] = I;
            patches[plane + o] = X;
            patches[2 * plane + o] = Y;
            a11 += X * X;
            a12 += X * Y;
            a22 += Y * Y;
            ia = ia1; ib = ib1; xa = xa1; xb = xb1; ya = ya1; yb = yb1;
        }
    }
    a11 *= kFltScale;
    a12 *= kFltScale;
    a22 *= kFltScale;
    const float D = a11 * a22 - a12 * a12;
    const float d = a11 - a22;
    const float min_eig = (a22 + a11 - sqrtf(d * d + 4.0f * a12 * a12)) /
                          (2.0f * static_cast<float>(win * win));
    const bool good = in_bounds && min_eig >= min_eig_thr && D >= kFltEpsilon;
    vec[i] = a11;
    vec[n + i] = a12;
    vec[2 * n + i] = a22;
    vec[3 * n + i] = good ? 1.0f / D : 0.0f;
    ok[i] = good ? 1 : 0;
}

}  // namespace

// img, gx, gy: (hp, wp) f32, the level padded by win + 2 on every side;
// pts: (n, 2) f32 at the level's scale.  Outputs: patches (3, win, win, n)
// f32 (image, dx, dy), vec (4, n) f32 (a11, a12, a22, invD), ok (n) bool.
// Returns the CUDA error of the launch (0 on success).
extern "C" int lk_prep_launch(const void* img, const void* gx, const void* gy,
                              const void* pts, void* patches, void* vec,
                              void* ok, int n, int hp, int wp, int h, int w,
                              int win, float min_eig_thr, void* stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    lk_prep_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), static_cast<const float*>(gx),
        static_cast<const float*>(gy), static_cast<const float*>(pts),
        static_cast<float*>(patches), static_cast<float*>(vec),
        static_cast<unsigned char*>(ok), n, hp, wp, h, w, win, min_eig_thr);
    return static_cast<int>(cudaGetLastError());
}
