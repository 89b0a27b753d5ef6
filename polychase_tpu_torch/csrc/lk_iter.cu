// K3: the LK iteration of one pyramid level, for every (target, feature).
//
// Replaces the TPU kernel polychase_tpu/kernels/lk_pallas.py
// ::_make_iter_kernel.  That kernel staged a slack patch per 128-lane group
// in VMEM, blended it with tent weights over every possible offset,
// re-extracted escaped lanes and exited per group.  None of that staging
// carries over.  Here:
//
//   - pairs are numbered feature-major (q = i*T + t) and a block owns P
//     consecutive pairs: P = 32 (with T = 8, four features and all of their
//     targets), fewer where their templates and window buffers would not
//     fit in the card's shared memory (large windows).  The block copies
//     the (3, win, win) templates of its features (K2 writes them
//     feature-major, so that is one contiguous, coalesced copy) into shared
//     memory once, and every target and every iteration reads them there;
//   - one group of 16 lanes solves one pair at a time and, when it is done,
//     takes the block's next pair (a shared counter), so a pair that runs
//     to the iteration budget holds up its own group only;
//   - each iteration the group copies the (win+1)² texels of the target
//     level under the window into its buffer in shared memory, as row
//     reads with eight loads in flight per lane, and only when the
//     window's integer origin has moved;
//   - the lanes take neighbouring pixels of the window (pixel p = lane +
//     16k); diff = (J - I)·32; b = Σ diff·∇I scaled by 2^-20 comes from a
//     butterfly shuffle reduction, which leaves the same bits in every
//     lane, so the group computes one step and exits together; OpenCV's
//     solve and step; stop on step² <= eps², on oscillation (|d + d_prev|
//     < 0.01 on both axes, then back half a step), or on leaving the image
//     (status 0 at level 0).  A frozen feature never moves again, so the
//     group's own exit gives the reference's result for the pair;
//   - at level 0, err = mean |J - I| at the final position.
//
// What bounds it on the card (level 0 of a 1080p frame, 8 targets, ~42k
// features): bytes, each read once, are the 50.9 MB of templates, the 68.7
// MB of the 8 padded target levels and ~8 MB of points and results, ~0.038
// ms at 3.35 TB/s; operations are ~1,300 f32 per pair-iteration (100
// pixels × blend, diff and two FMAs), ~2.5M pair-iterations, ~0.05 ms at
// 67 TFLOP/s.  Neither is what holds it: the template staging takes the
// template bytes down from T × iterations passes to one, and the window
// staging keeps the texel loads to one round trip an iteration, so what
// remains is the instructions issued per pixel.  For the main path's
// window (win = 10) the kernel is compiled with the window fixed: each
// lane's pixel offsets are computed once, and a pixel costs its seven
// shared loads and seven f32 instructions (the blend as FMAs: K3 need not
// match its plain version to the bit).  Other windows take a kernel with
// the window as a runtime value.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kFltScale = 1.0f / (1 << 20);
constexpr int kLanes = 16;    // lanes per (target, feature) pair
constexpr int kGroups = 8;    // groups of lanes per block, at most
constexpr int kPairs = 32;    // pairs per block, at most
constexpr int kMainWin = 10;  // the window the kernel is specialised for

__device__ __forceinline__ int clamp_origin(float v, int hi) {
    return static_cast<int>(fminf(fmaxf(v, 0.0f), static_cast<float>(hi)));
}

// Shared floats for the templates of the features `pairs` consecutive
// pairs span (at most (pairs - 1) / T + 2 of them, and never more than
// `pairs`); the groups' window buffers follow them.
__host__ __device__ __forceinline__ int template_floats(int T, int win,
                                                        int pairs) {
    return min(pairs, (pairs - 1) / T + 2) * 3 * win * win;
}

__host__ __device__ __forceinline__ int shared_floats(int T, int win,
                                                      int pairs) {
    return template_floats(T, win, pairs) +
           min(kGroups, pairs) * (win + 1) * (win + 1);
}

// Butterfly sum over a group of kLanes lanes: every lane ends with the same
// bits.
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
    for (int o = kLanes / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(mask, v, o, kLanes);
    return v;
}

// This lane's pixels p = lane + k*kLanes of the win×win window, as offsets
// (row·(win+1) + column) into a (win+1)² texel buffer.  With the window
// fixed at compile time (WIN > 0) they are computed once and kept in
// registers; with WIN = 0 the walk steps through them instead.
template <int WIN>
struct Pixels {
    static constexpr int kRounds = WIN > 0 ? (WIN * WIN + kLanes - 1) / kLanes
                                           : 1;
    int off[kRounds];

    __device__ __forceinline__ explicit Pixels(int lane) {
        if constexpr (WIN > 0) {
#pragma unroll
            for (int k = 0; k < kRounds; ++k) {
                const int p = lane + k * kLanes;
                off[k] = (p / WIN) * (WIN + 1) + p % WIN;
            }
        }
    }
};

// Copies the (win+1)² texels of `img` at origin (x0, y0) into the group's
// window buffer `buf`, row-major: lane l takes texels l, l + kLanes, ...,
// eight loads in flight at a time.  The __syncwarp before keeps every
// lane's reads of the previous window ahead of the writes; the one after
// makes the copy visible to the group.
__device__ __forceinline__ void stage_window(const float* __restrict__ img,
                                             int wp, int x0, int y0, int win,
                                             int lane, unsigned mask,
                                             float* buf) {
    constexpr int kInFlight = 8;
    const int k1 = win + 1, count = k1 * k1;
    const int dr = kLanes / k1, dc = kLanes % k1;
    int r = lane / k1, c = lane - (lane / k1) * k1;
    const float* base = img + static_cast<size_t>(y0) * wp + x0;
    __syncwarp(mask);
    for (int k0 = lane; k0 < count; k0 += kInFlight * kLanes) {
        float v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
            v[u] = k0 + u * kLanes < count
                       ? __ldg(base + static_cast<size_t>(r) * wp + c)
                       : 0.0f;
            r += dr;
            c += dc;
            if (c >= k1) {
                c -= k1;
                ++r;
            }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
            if (k0 + u * kLanes < count) buf[k0 + u * kLanes] = v[u];
    }
    __syncwarp(mask);
}
// One pixel's share of the sums: the bilinear sample J of the texels at q
// against the template at p; Σ (J - I)·GX, Σ (J - I)·GY when `grad`, else
// Σ |J - I| in a1.
template <bool grad>
__device__ __forceinline__ void pixel(const float* q, int k1, float w00,
                                      float w01, float w10, float w11,
                                      const float* I, const float* GX,
                                      const float* GY, int p, float& a1,
                                      float& a2) {
    const float J =
        fmaf(w00, q[0], fmaf(w01, q[1], fmaf(w10, q[k1], w11 * q[k1 + 1])));
    const float d = J - I[p];
    if (grad) {
        a1 = fmaf(d, GX[p], a1);
        a2 = fmaf(d, GY[p], a2);
    } else {
        a1 += fabsf(d);
    }
}

// The group's walk over the blended window J of the staged texels `buf`
// against the staged template: b1, b2 = Σ (J - I)·32·∇I scaled by 2^-20
// when `grad` (the factor 32 is a power of two, so folding it into the
// scale changes no bit), else Σ |J - I| in s1.  (r0, c0) is this lane's
// first pixel.
template <int WIN, bool grad>
__device__ __forceinline__ void window_sums(
    const float* buf, float bx, float by, const float* I, const float* GX,
    const float* GY, int win, int lane, int r0, int c0,
    const Pixels<WIN>& pix, unsigned mask, float* s1, float* s2) {
    const float w00 = (1.0f - bx) * (1.0f - by);
    const float w01 = bx * (1.0f - by);
    const float w10 = (1.0f - bx) * by;
    const float w11 = bx * by;
    const int k1 = win + 1;
    float a1 = 0.0f, a2 = 0.0f;
    if constexpr (WIN > 0) {
#pragma unroll
        for (int k = 0; k < Pixels<WIN>::kRounds; ++k) {
            const int p = lane + k * kLanes;
            if (k + 1 < Pixels<WIN>::kRounds || p < WIN * WIN)
                pixel<grad>(buf + pix.off[k], WIN + 1, w00, w01, w10, w11, I,
                            GX, GY, p, a1, a2);
        }
    } else {
        const int dr = kLanes / win, dc = kLanes % win;
        int r = r0, c = c0;
        for (int p = lane; p < win * win; p += kLanes) {
            pixel<grad>(buf + r * k1 + c, k1, w00, w01, w10, w11, I, GX, GY,
                        p, a1, a2);
            r += dr;
            c += dc;
            if (c >= win) {
                c -= win;
                ++r;
            }
        }
    }
    constexpr float kScale = 32.0f * kFltScale;
    *s1 = group_sum(a1, mask) * (grad ? kScale : 1.0f);
    *s2 = grad ? group_sum(a2, mask) * kScale : 0.0f;
}

// One (target, feature) pair q = i*T + t, solved by a group of kLanes
// lanes against the template I (GX, GY follow it) staged in shared memory; `buf`
// is the group's (win+1)² window buffer, restaged only when the window's
// integer origin moves.
template <int WIN>
__device__ __forceinline__ void solve_pair(
    int q, const float* __restrict__ imgs, const float* I,
    const float* __restrict__ a11v, const float* __restrict__ a12v,
    const float* __restrict__ a22v, const float* __restrict__ invdv,
    const unsigned char* __restrict__ ok, const float* __restrict__ pts_in,
    float* __restrict__ pts_out, unsigned char* __restrict__ status,
    float* __restrict__ err, int T, int n, int hp, int wp, int h, int w,
    int win, int max_iters, float eps2, int level_is_zero, int lane, int r0,
    int c0, const Pixels<WIN>& pix, unsigned mask, float* buf) {
    const int nwin = win * win;
    const float* GX = I + nwin;
    const float* GY = GX + nwin;
    const int i = q / T, t = q - (q / T) * T;
    const size_t pid = static_cast<size_t>(t) * n + i;
    const float* img = imgs + static_cast<size_t>(t) * hp * wp;
    const float half = (win - 1) * 0.5f;
    const int pad = win + 2;
    const float a11 = a11v[i], a12 = a12v[i], a22 = a22v[i];
    const float invd = invdv[i];
    bool active = ok[i] != 0;
    bool st = level_is_zero ? active : true;
    float x = pts_in[2 * pid], y = pts_in[2 * pid + 1];
    float pdx = 0.0f, pdy = 0.0f;
    int sx = -1, sy = -1;  // origin of the staged window (none yet)
    auto stage = [&](int x0, int y0) {
        if (x0 != sx || y0 != sy) {
            stage_window(img, wp, x0, y0, win, lane, mask, buf);
            sx = x0;
            sy = y0;
        }
    };

    for (int j = 0; j < max_iters && active; ++j) {
        const float fx = floorf(x - half), fy = floorf(y - half);
        if (!(fx >= -win && fx < w && fy >= -win && fy < h)) {
            if (level_is_zero) st = false;
            break;
        }
        // In bounds, so the window lies inside the buffer padded by win+2.
        stage(static_cast<int>(fx) + pad, static_cast<int>(fy) + pad);
        float b1, b2;
        window_sums<WIN, true>(buf, x - half - fx, y - half - fy, I, GX, GY,
                               win, lane, r0, c0, pix, mask, &b1, &b2);
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

    float e = 0.0f;
    if (level_is_zero) {
        const float fx = floorf(x - half), fy = floorf(y - half);
        float s1, s2;
        stage(clamp_origin(fx + pad, wp - (win + 1)),
              clamp_origin(fy + pad, hp - (win + 1)));
        window_sums<WIN, false>(buf, x - half - fx, y - half - fy, I, GX, GY,
                                win, lane, r0, c0, pix, mask, &s1, &s2);
        e = s1 / static_cast<float>(nwin);
    }
    if (lane == 0) {
        pts_out[2 * pid] = x;
        pts_out[2 * pid + 1] = y;
        status[pid] = st ? 1 : 0;
        err[pid] = e;
    }
}

template <int WIN>
__global__ void __launch_bounds__(kLanes * kGroups)
lk_iter_kernel(const float* __restrict__ imgs,
               const float* __restrict__ patches,
               const float* __restrict__ a11v, const float* __restrict__ a12v,
               const float* __restrict__ a22v, const float* __restrict__ invdv,
               const unsigned char* __restrict__ ok,
               const float* __restrict__ pts_in, float* __restrict__ pts_out,
               unsigned char* __restrict__ status, float* __restrict__ err,
               int T, int n, int hp, int wp, int h, int w, int win_arg,
               int max_iters, float eps2, int level_is_zero, int pairs) {
    extern __shared__ float tmpl[];
    __shared__ int next;  // the block's next pair not yet taken
    const int win = WIN > 0 ? WIN : win_arg;
    const int nwin = win * win;
    const int groups = blockDim.x / kLanes;
    const int q0 = blockIdx.x * pairs;
    const int q_end = min(q0 + pairs, T * n);
    const int f0 = q0 / T;
    const int f1 = (q_end - 1) / T;

    // Stage the templates of features f0..f1: one contiguous copy.
    const float* src = patches + static_cast<size_t>(f0) * 3 * nwin;
    const int count = (f1 - f0 + 1) * 3 * nwin;
    for (int k = threadIdx.x; k < count; k += blockDim.x)
        tmpl[k] = __ldg(src + k);
    if (threadIdx.x == 0) next = groups;
    __syncthreads();

    float* buf = tmpl + template_floats(T, win, pairs) +
                 (threadIdx.x / kLanes) * (win + 1) * (win + 1);
    const int lane = threadIdx.x % kLanes;
    const unsigned mask = 0xffffu << (threadIdx.x & kLanes);
    const int r0 = lane / win, c0 = lane - (lane / win) * win;
    const Pixels<WIN> pix(lane);
    // Group g takes pair g, then whichever pair is next when it is done.
    for (int q = q0 + threadIdx.x / kLanes; q < q_end;) {
        solve_pair<WIN>(q, imgs, tmpl + (q / T - f0) * 3 * nwin, a11v, a12v,
                        a22v, invdv, ok, pts_in, pts_out, status, err, T, n,
                        hp, wp, h, w, win, max_iters, eps2, level_is_zero,
                        lane, r0, c0, pix, mask, buf);
        int k = 0;
        if (lane == 0) k = atomicAdd(&next, 1);
        q = q0 + __shfl_sync(mask, k, 0, kLanes);
    }
}

}  // namespace

// imgs: (T, hp, wp) f32 target levels padded by win + 2; patches: (n, 3,
// win, win) f32 from K2 (feature-major); a11, a12, a22, invd: (n) f32; ok:
// (n) bool; pts_in: (T, n, 2) f32 guesses at the level's scale; T * n <
// 2^31.  Outputs: pts_out (T, n, 2) f32, status (T, n) bool, err (T, n)
// f32.  Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue when one pair's template and window buffer do not
// fit in a block's shared memory (win above 120).
extern "C" int lk_iter_launch(const void* imgs, const void* patches,
                              const void* a11, const void* a12,
                              const void* a22, const void* invd,
                              const void* ok, const void* pts_in,
                              void* pts_out, void* status, void* err, int T,
                              int n, int hp, int wp, int h, int w, int win,
                              int max_iters, float eps2, int level_is_zero,
                              void* stream) {
    auto kernel = win == kMainWin ? lk_iter_kernel<kMainWin>
                                  : lk_iter_kernel<0>;
    int dev = 0, limit = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    // As many pairs a block as the shared memory, less the kernel's static
    // part, holds the templates and window buffers of.
    limit -= static_cast<int>(attr.sharedSizeBytes);
    int pairs = kPairs;
    const int fit = limit / static_cast<int>(sizeof(float));
    while (pairs > 1 && shared_floats(T, win, pairs) > fit) --pairs;
    const size_t shmem = shared_floats(T, win, pairs) * sizeof(float);
    if (shmem > static_cast<size_t>(limit))
        return static_cast<int>(cudaErrorInvalidValue);
    if (shmem > 48 * 1024) {
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shmem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (T * n + pairs - 1) / pairs;
    kernel<<<blocks, kLanes * min(kGroups, pairs), shmem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(imgs), static_cast<const float*>(patches),
        static_cast<const float*>(a11), static_cast<const float*>(a12),
        static_cast<const float*>(a22), static_cast<const float*>(invd),
        static_cast<const unsigned char*>(ok),
        static_cast<const float*>(pts_in), static_cast<float*>(pts_out),
        static_cast<unsigned char*>(status), static_cast<float*>(err), T, n,
        hp, wp, h, w, win, max_iters, eps2, level_is_zero, pairs);
    return static_cast<int>(cudaGetLastError());
}
