// K3: the LK iteration of one pyramid level, for every (target, feature).
//
// Replaces the TPU kernel polychase_tpu/kernels/lk_pallas.py
// ::_make_iter_kernel.  That kernel staged a slack patch per 128-lane group
// in VMEM, blended it with tent weights over every possible offset,
// re-extracted escaped lanes and exited per group.  None of that staging
// carries over.  Here one thread owns one (target, feature) pair and loops
// on its own:
//
//   - sample the target image bilinearly at the moving point, straight from
//     global memory through the read-only cache (a window of (win+1)² texels
//     whose rows neighbouring features share once they are spatially
//     sorted);
//   - diff = (J - I)·32 against the template and derivative patches of K2,
//     stored feature-minor (win*win, N) so a warp's reads of them coalesce;
//     b = Σ diff·∇I scaled by 2^-20; solve the 2×2 system and step;
//   - stop on step² <= eps², on oscillation (|d + d_prev| < 0.01 on both
//     axes, then back half a step), or on leaving the image (status 0 at
//     level 0).  A frozen feature never moves again, so the thread's own
//     exit gives the reference's result for it;
//   - at level 0, err = mean |J - I| at the final position.
//
// What bounds it on the card: per iteration each thread reads 2·(win+1)·win
// texels and 3·win² template values; the templates of a level (12·win²·N
// bytes, 3.6 MB at N = 25k, win = 10) stay in L2 for all T targets.  The
// warp runs as long as its slowest feature.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kFltScale = 1.0f / (1 << 20);

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

// Walks the blended window J at origin (x0, y0) of `img` against the
// template: accumulates Σ diff·GX, Σ diff·GY (diff = (J - I)·32) when
// `grad`, else Σ |J - I|.
template <bool grad>
__device__ __forceinline__ void window_sums(
    const float* __restrict__ img, int wp, int x0, int y0, float bx,
    float by, const float* __restrict__ I, const float* __restrict__ GX,
    const float* __restrict__ GY, int n, int i, int win, float* s1,
    float* s2) {
    const float w00 = __fmul_rn(1.0f - bx, 1.0f - by);
    const float w01 = __fmul_rn(bx, 1.0f - by);
    const float w10 = __fmul_rn(1.0f - bx, by);
    const float w11 = __fmul_rn(bx, by);
    float a1 = 0.0f, a2 = 0.0f;
    for (int r = 0; r < win; ++r) {
        const float* p0 = img + static_cast<size_t>(y0 + r) * wp + x0;
        const float* p1 = p0 + wp;
        float pa = __ldg(p0), pb = __ldg(p1);
        for (int c = 0; c < win; ++c) {
            const float pa1 = __ldg(p0 + c + 1), pb1 = __ldg(p1 + c + 1);
            const float J = blend(w00, w01, w10, w11, pa, pa1, pb, pb1);
            const size_t o = static_cast<size_t>(r * win + c) * n + i;
            if (grad) {
                const float diff = (J - __ldg(I + o)) * 32.0f;
                a1 += diff * __ldg(GX + o);
                a2 += diff * __ldg(GY + o);
            } else {
                a1 += fabsf(J - __ldg(I + o));
            }
            pa = pa1;
            pb = pb1;
        }
    }
    *s1 = a1;
    *s2 = a2;
}

__global__ void __launch_bounds__(128)
lk_iter_kernel(const float* __restrict__ imgs, const float* __restrict__ I,
               const float* __restrict__ GX, const float* __restrict__ GY,
               const float* __restrict__ a11v, const float* __restrict__ a12v,
               const float* __restrict__ a22v, const float* __restrict__ invdv,
               const unsigned char* __restrict__ ok,
               const float* __restrict__ pts_in, float* __restrict__ pts_out,
               unsigned char* __restrict__ status, float* __restrict__ err,
               int T, int n, int hp, int wp, int h, int w, int win,
               int max_iters, float eps2, int level_is_zero) {
    const long long gid =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (gid >= static_cast<long long>(T) * n) return;
    const int t = static_cast<int>(gid / n);
    const int i = static_cast<int>(gid % n);
    const float* img = imgs + static_cast<size_t>(t) * hp * wp;
    const float half = (win - 1) * 0.5f;
    const int pad = win + 2;
    const float a11 = a11v[i], a12 = a12v[i], a22 = a22v[i];
    const float invd = invdv[i];
    bool active = ok[i] != 0;
    bool st = level_is_zero ? active : true;
    float x = pts_in[2 * gid], y = pts_in[2 * gid + 1];
    float pdx = 0.0f, pdy = 0.0f;

    for (int j = 0; j < max_iters && active; ++j) {
        const float fx = floorf(x - half), fy = floorf(y - half);
        if (!(fx >= -win && fx < w && fy >= -win && fy < h)) {
            if (level_is_zero) st = false;
            break;
        }
        // In bounds, so the window lies inside the buffer padded by win+2.
        float b1, b2;
        window_sums<true>(img, wp, static_cast<int>(fx) + pad,
                          static_cast<int>(fy) + pad, x - half - fx,
                          y - half - fy, I, GX, GY, n, i, win, &b1, &b2);
        b1 *= kFltScale;
        b2 *= kFltScale;
        // OpenCV's delta (note the sign convention of its solve)
        const float dx = (a12 * b2 - a22 * b1) * invd;
        const float dy = (a12 * b1 - a11 * b2) * invd;
        float nx = x + dx, ny = y + dy;
        const bool converged = dx * dx + dy * dy <= eps2;
        const bool oscillating =
            j > 0 && fabsf(dx + pdx) < 0.01f && fabsf(dy + pdy) < 0.01f;
        if (oscillating) {
            nx = nx - dx * 0.5f;
            ny = ny - dy * 0.5f;
        }
        x = nx;
        y = ny;
        pdx = dx;
        pdy = dy;
        active = !converged && !oscillating;
    }

    pts_out[2 * gid] = x;
    pts_out[2 * gid + 1] = y;
    status[gid] = st ? 1 : 0;
    float e = 0.0f;
    if (level_is_zero) {
        const float fx = floorf(x - half), fy = floorf(y - half);
        float s1, s2;
        window_sums<false>(img, wp, clamp_origin(fx + pad, wp - (win + 1)),
                           clamp_origin(fy + pad, hp - (win + 1)),
                           x - half - fx, y - half - fy, I, GX, GY, n, i,
                           win, &s1, &s2);
        e = s1 / static_cast<float>(win * win);
    }
    err[gid] = e;
}

}  // namespace

// imgs: (T, hp, wp) f32 target levels padded by win + 2; ipatch, dxi, dyi:
// (win, win, n) f32 from K2; a11, a12, a22, invd: (n) f32; ok: (n) bool;
// pts_in: (T, n, 2) f32 guesses at the level's scale.  Outputs: pts_out
// (T, n, 2) f32, status (T, n) bool, err (T, n) f32.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int lk_iter_launch(const void* imgs, const void* ipatch,
                              const void* dxi, const void* dyi,
                              const void* a11, const void* a12,
                              const void* a22, const void* invd,
                              const void* ok, const void* pts_in,
                              void* pts_out, void* status, void* err, int T,
                              int n, int hp, int wp, int h, int w, int win,
                              int max_iters, float eps2, int level_is_zero,
                              void* stream) {
    const int threads = 128;
    const long long total = static_cast<long long>(T) * n;
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    lk_iter_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(imgs), static_cast<const float*>(ipatch),
        static_cast<const float*>(dxi), static_cast<const float*>(dyi),
        static_cast<const float*>(a11), static_cast<const float*>(a12),
        static_cast<const float*>(a22), static_cast<const float*>(invd),
        static_cast<const unsigned char*>(ok),
        static_cast<const float*>(pts_in), static_cast<float*>(pts_out),
        static_cast<unsigned char*>(status), static_cast<float*>(err), T, n,
        hp, wp, h, w, win, max_iters, eps2, level_is_zero);
    return static_cast<int>(cudaGetLastError());
}
