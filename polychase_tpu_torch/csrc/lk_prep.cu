// K2: the LK source-frame prep of one pyramid level, for every feature.
//
// Replaces the TPU kernel polychase_tpu/kernels/lk_pallas.py
// ::_make_extract_kernel together with the XLA tail of lk_prepare_level
// (bilinear blend, normal matrix, gate).  The TPU extracted the integer
// windows alone and left the blend to XLA because image, dx and dy did not
// fit its VMEM together; here one group of kLanes lanes per feature does all
// of it:
//
//   1. the window at floor(pt - (win-1)/2) of the padded image, its Scharr
//      dx and its Scharr dy (origin clamped into the buffer, as the
//      reference's dynamic_slice clamps it).  The lanes take neighbouring
//      pixels of the window's rows (pixel p = lane + k*kLanes), so a group's
//      reads of each plane are a few row segments, not 16 scattered
//      windows;
//   2. the bilinear blend of each to win×win, written feature-major: one
//      feature's (3, win, win) values are contiguous, the copy K3 stages
//      into shared memory, and a group's stores coalesce;
//   3. A11, A12, A22 (shuffle reductions over the group) scaled by 2^-20,
//      the gate (bounds, min eigenvalue >= thr, det >= FLT_EPSILON), invD
//      and ok, written by the group's first lane.
//
// What bounds it on the card: bytes.  At level 0 of a 1080p frame with
// ~42k features it writes 12·win²·N = 50.9 MB of patches and reads the
// three padded planes (25.7 MB at most): ~0.023 ms at 3.35 TB/s.  Its
// operations (~30 per pixel and feature, 0.13 GFLOP) take ~2 µs at 67
// TFLOP/s.  The design keeps every store coalesced and the window reads to
// whole row segments, which the L1 serves to the four blend taps.
//
// The blend is written with round-to-nearest intrinsics so nvcc does not
// contract it into FMAs: the patches then equal the plain torch version's
// to the bit, and only the order of the A sums differs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kFltScale = 1.0f / (1 << 20);
constexpr float kFltEpsilon = 1.1920929e-07f;
constexpr int kLanes = 16;                  // lanes per feature
constexpr int kThreads = 128;               // kThreads / kLanes features
constexpr int kFeatures = kThreads / kLanes;

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

// Bilinear sample of `plane` at the texel offset `o` (top-left tap).
__device__ __forceinline__ float sample(const float* __restrict__ plane,
                                        size_t o, int wp, float w00,
                                        float w01, float w10, float w11) {
    return blend(w00, w01, w10, w11, __ldg(plane + o), __ldg(plane + o + 1),
                 __ldg(plane + o + wp), __ldg(plane + o + wp + 1));
}

// Butterfly sum over the group: every lane ends with the same bits.
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
    for (int o = kLanes / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(mask, v, o, kLanes);
    return v;
}

__global__ void __launch_bounds__(kThreads)
lk_prep_kernel(const float* __restrict__ img, const float* __restrict__ gx,
               const float* __restrict__ gy, const float* __restrict__ pts,
               float* __restrict__ patches, float* __restrict__ vec,
               unsigned char* __restrict__ ok, int n, int hp, int wp, int h,
               int w, int win, float min_eig_thr) {
    const int lane = threadIdx.x % kLanes;
    const int i = blockIdx.x * kFeatures + threadIdx.x / kLanes;
    if (i >= n) return;  // whole groups leave together
    const unsigned mask = ((1u << kLanes) - 1u)
                          << ((threadIdx.x & 31) & ~(kLanes - 1));
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

    const int nwin = win * win;
    float* out = patches + static_cast<size_t>(i) * 3 * nwin;
    float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
    // Pixel p = (r, c) of the window; p advances by kLanes per round.
    int r = lane / win, c = lane - (lane / win) * win;
    const int dr = kLanes / win, dc = kLanes % win;
    for (int p = lane; p < nwin; p += kLanes) {
        const size_t o = static_cast<size_t>(y0 + r) * wp + x0 + c;
        const float I = sample(img, o, wp, w00, w01, w10, w11);
        const float X = sample(gx, o, wp, w00, w01, w10, w11);
        const float Y = sample(gy, o, wp, w00, w01, w10, w11);
        out[p] = I;
        out[nwin + p] = X;
        out[2 * nwin + p] = Y;
        a11 += X * X;
        a12 += X * Y;
        a22 += Y * Y;
        r += dr;
        c += dc;
        if (c >= win) {
            c -= win;
            ++r;
        }
    }
    a11 = group_sum(a11, mask) * kFltScale;
    a12 = group_sum(a12, mask) * kFltScale;
    a22 = group_sum(a22, mask) * kFltScale;
    if (lane != 0) return;
    const float D = a11 * a22 - a12 * a12;
    const float d = a11 - a22;
    const float min_eig = (a22 + a11 - sqrtf(d * d + 4.0f * a12 * a12)) /
                          (2.0f * static_cast<float>(nwin));
    const bool good = in_bounds && min_eig >= min_eig_thr && D >= kFltEpsilon;
    vec[i] = a11;
    vec[n + i] = a12;
    vec[2 * n + i] = a22;
    vec[3 * n + i] = good ? 1.0f / D : 0.0f;
    ok[i] = good ? 1 : 0;
}

}  // namespace

// img, gx, gy: (hp, wp) f32, the level padded by win + 2 on every side;
// pts: (n, 2) f32 at the level's scale.  Outputs: patches (n, 3, win, win)
// f32 (image, dx, dy; feature-major), vec (4, n) f32 (a11, a12, a22, invD),
// ok (n) bool.  Returns the CUDA error of the launch (0 on success).
extern "C" int lk_prep_launch(const void* img, const void* gx, const void* gy,
                              const void* pts, void* patches, void* vec,
                              void* ok, int n, int hp, int wp, int h, int w,
                              int win, float min_eig_thr, void* stream) {
    const int blocks = (n + kFeatures - 1) / kFeatures;
    lk_prep_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), static_cast<const float*>(gx),
        static_cast<const float*>(gy), static_cast<const float*>(pts),
        static_cast<float*>(patches), static_cast<float*>(vec),
        static_cast<unsigned char*>(ok), n, hp, wp, h, w, win, min_eig_thr);
    return static_cast<int>(cudaGetLastError());
}
