// K5: the closest-hit sweep of raycast_grouped on the card.
//
// A kernel of the port only: the JAX package runs this sweep as XLA (the
// lax.scan over triangle chunks of polychase_tpu/engine/raycast.py:153
// raycast_grouped, scan body :224-271), not as a Pallas kernel.  Its plain
// torch version is polychase_tpu_torch/engine/raycast.py::sweep_plain.
//
// G groups of K rays, one origin o per group, against T triangles (first
// corner v0, edges e1 = p2 - p1, e2 = p3 - p1).  With a shared origin the
// Moller-Trumbore triple products factor into
//   per triangle:            A = e2 x e1
//   per group and triangle:  omv = o - v0, B = e2 x omv, Cq = omv x e1,
//                            sdet = e2 . Cq
//   per ray and triangle:    det = d . A, udet = d . B, vdet = d . Cq
// and ray d hits when, with s the sign of det (+1 at det >= 0),
// |det| > 1e-10, u = s udet >= 0, v = s vdet >= 0, u + v <= |det| and
// s sdet > 0, at t = s sdet / |det| (an IEEE division).  A ray keeps the
// least t, and of equal t's the lowest triangle id, whatever the tiling.
//
// Arithmetic: the plain version's, operation by operation, so that ids and
// t can match it to the bit:
//   - a cross product's a*b - c*d as torch.linalg.cross rounds it on the
//     card and on AVX2 and AVX-512 hosts: c*d rounded, then one fused
//     multiply-add, fma(a, b, -(c*d));
//   - the per-ray dot products as ((d0 x0 + d1 x1) + d2 x2), every
//     product and sum rounded (__fmul_rn and __fadd_rn: nvcc would
//     contract them into FMAs), as the plain version's separate torch ops
//     round them;
//   - sdet, which the plain version sums with torch.sum over the last
//     axis, as that sum rounds on the card: (p0 + p2) + p1 (measured on an
//     H100 with torch 2.11, CUDA 12.8; the CPU's torch.sum takes
//     (p0 + p1) + p2);
//   - the sign normalisation as a select of x or -x, which is exact, like
//     the plain version's multiply by +-1.
//
// Layout: grid (G, ceil(K / threads), splits), one thread per ray.  Each
// block walks its split's range of triangles in tiles of kTile.  For each
// tile the block's threads first compute the per-triangle and
// per-(group, triangle) constants for the group's origin (A, B, Cq, sdet:
// 10 floats a triangle, three float4s) into shared memory, then each thread
// sweeps the tile with its (best t, best id) in registers, reading the
// constants as broadcasts.  With one split a thread writes its ray's result.
// Where G * K is too small to fill the card (a tracking frame: 64 blocks of
// rays), the triangles are split over blockIdx.z: each split writes a
// 64-bit key, t's bits << 32 | id (t >= 0, so its bits order like the
// floats), and a second kernel takes each ray's least key, which is the
// least t and then the lowest id.
//
// What bounds it on the card: operations.  A (ray, triangle) pair costs 15
// products and sums in the three dot products, 4 sign selects, one sum and
// 5 compares, ~25 f32 operations; a (group, triangle) pair 26 and a
// triangle 9.  A tracking frame (8192 rays x 20,224 triangles, 1.66e8
// pairs) is ~4.1e9 operations, 0.062 ms at 67 TFLOP/s, against ~1 MB of
// bytes.  None of the per-pair operations can be an FMA (the plain
// version's rounding), and the peak counts an FMA as two, so at most half
// of that rate is within reach.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 128;        // triangles staged in shared memory a pass
constexpr int kMaxThreads = 128;  // rays a block
constexpr float kEps = 1e-10f;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

std::atomic<long long> launched{0};

struct Params {
    const float* origins;  // (G, 3)
    const float* dirs;     // (G, K, 3)
    const float* v0;       // (T, 3)
    const float* e1;       // (T, 3)
    const float* e2;       // (T, 3)
    float* best_t;         // (G, K)
    int64_t* best_id;      // (G, K)
    unsigned long long* partial;  // (splits, G, K) keys when splits > 1
    int G, K, T, splits, per;     // per: the triangles of one split
};

// a*b - c*d as torch.linalg.cross rounds it.
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// (x0 y0 + x1 y1) + x2 y2, each operation rounded.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                     __fmul_rn(x2, y2));
}

__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(Params p) {
    __shared__ float4 s_a[kTile];  // A, and sdet in w
    __shared__ float4 s_b[kTile];  // B
    __shared__ float4 s_c[kTile];  // Cq
    const int g = blockIdx.x;
    const int k = blockIdx.y * blockDim.x + threadIdx.x;
    const int lo = blockIdx.z * p.per;
    const int hi = min(p.T, lo + p.per);
    const float ox = p.origins[3 * g];
    const float oy = p.origins[3 * g + 1];
    const float oz = p.origins[3 * g + 2];
    const bool live = k < p.K;
    const size_t ray = static_cast<size_t>(g) * p.K + k;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f;
    if (live) {
        d0 = p.dirs[3 * ray];
        d1 = p.dirs[3 * ray + 1];
        d2 = p.dirs[3 * ray + 2];
    }
    float best_t = INFINITY;
    uint32_t best = kInvalid;
    for (int base = lo; base < hi; base += kTile) {
        const int n = min(kTile, hi - base);
        __syncthreads();  // the previous tile is swept
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const size_t j = static_cast<size_t>(base + i) * 3;
            const float e1x = p.e1[j], e1y = p.e1[j + 1], e1z = p.e1[j + 2];
            const float e2x = p.e2[j], e2y = p.e2[j + 1], e2z = p.e2[j + 2];
            const float mx = __fsub_rn(ox, p.v0[j]);
            const float my = __fsub_rn(oy, p.v0[j + 1]);
            const float mz = __fsub_rn(oz, p.v0[j + 2]);
            const float cx = cross_term(my, e1z, mz, e1y);
            const float cy = cross_term(mz, e1x, mx, e1z);
            const float cz = cross_term(mx, e1y, my, e1x);
            s_a[i] = make_float4(cross_term(e2y, e1z, e2z, e1y),
                                 cross_term(e2z, e1x, e2x, e1z),
                                 cross_term(e2x, e1y, e2y, e1x),
                                 dot3(e2x, e2z, e2y, cx, cz, cy));
            s_b[i] = make_float4(cross_term(e2y, mz, e2z, my),
                                 cross_term(e2z, mx, e2x, mz),
                                 cross_term(e2x, my, e2y, mx), 0.f);
            s_c[i] = make_float4(cx, cy, cz, 0.f);
        }
        __syncthreads();
        if (!live) continue;
        for (int i = 0; i < n; ++i) {
            const float4 a = s_a[i];
            const float4 b = s_b[i];
            const float4 c = s_c[i];
            const float det = dot3(d0, d1, d2, a.x, a.y, a.z);
            const float ud = dot3(d0, d1, d2, b.x, b.y, b.z);
            const float vd = dot3(d0, d1, d2, c.x, c.y, c.z);
            const bool pos = det >= 0.f;
            const float adet = pos ? det : -det;
            const float u = pos ? ud : -ud;
            const float v = pos ? vd : -vd;
            const float tn = pos ? a.w : -a.w;
            if (adet > kEps && u >= 0.f && v >= 0.f &&
                __fadd_rn(u, v) <= adet && tn > 0.f) {
                const float t = __fdiv_rn(tn, adet);
                if (t < best_t) {
                    best_t = t;
                    best = static_cast<uint32_t>(base + i);
                }
            }
        }
    }
    if (!live) return;
    if (p.splits == 1) {
        p.best_t[ray] = best_t;
        p.best_id[ray] = static_cast<int64_t>(best);
    } else {
        p.partial[static_cast<size_t>(blockIdx.z) * p.G * p.K + ray] =
            (static_cast<unsigned long long>(__float_as_uint(best_t)) << 32) |
            best;
    }
}

// Each ray's least key over the splits → (t, id).
__global__ void reduce_kernel(const unsigned long long* __restrict__ partial,
                              int splits, size_t rays, float* best_t,
                              int64_t* best_id) {
    const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
    if (r >= rays) return;
    unsigned long long key = partial[r];
    for (int s = 1; s < splits; ++s) {
        const unsigned long long other = partial[s * rays + r];
        key = other < key ? other : key;
    }
    best_t[r] = __uint_as_float(static_cast<uint32_t>(key >> 32));
    best_id[r] = static_cast<int64_t>(static_cast<uint32_t>(key));
}

}  // namespace

// origins (G, 3), dirs (G, K, 3), v0, e1, e2 (T, 3): contiguous float32.
// Outputs best_t (G, K) float32 (infinite on a miss) and best_id (G, K)
// int64 (0xFFFFFFFF on a miss).  threads: rays a block, a multiple of 32 up
// to 128; splits: the triangle ranges of blockIdx.z, from 1; with more than
// one, partial is (splits, G, K) 64-bit scratch and a second kernel reduces
// it.  Queues the launches on the stream; returns the CUDA error (0 on
// success).
extern "C" int raycast_sweep_launch(
    const void* origins, const void* dirs, const void* v0, const void* e1,
    const void* e2, int G, int K, int T, int threads, int splits,
    void* best_t, void* best_id, void* partial, void* stream) {
    if (G < 1 || K < 1 || T < 0 || T >= 0x7FFFFFFF || threads < 32 ||
        threads > kMaxThreads || threads % 32 != 0 || splits < 1 ||
        splits > 65535 || (splits > 1 && partial == nullptr))
        return cudaErrorInvalidValue;
    const int ray_blocks = (K + threads - 1) / threads;
    if (ray_blocks > 65535) return cudaErrorInvalidValue;
    Params p;
    p.origins = static_cast<const float*>(origins);
    p.dirs = static_cast<const float*>(dirs);
    p.v0 = static_cast<const float*>(v0);
    p.e1 = static_cast<const float*>(e1);
    p.e2 = static_cast<const float*>(e2);
    p.best_t = static_cast<float*>(best_t);
    p.best_id = static_cast<int64_t*>(best_id);
    p.partial = static_cast<unsigned long long*>(partial);
    p.G = G;
    p.K = K;
    p.T = T;
    p.splits = splits;
    p.per = (T + splits - 1) / splits;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    sweep_kernel<<<dim3(G, ray_blocks, splits), threads, 0, s>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    launched.fetch_add(1, std::memory_order_relaxed);
    if (splits > 1) {
        const size_t rays = static_cast<size_t>(G) * K;
        const unsigned blocks = static_cast<unsigned>((rays + 255) / 256);
        reduce_kernel<<<blocks, 256, 0, s>>>(p.partial, splits, rays,
                                             p.best_t, p.best_id);
        e = cudaGetLastError();
    }
    return static_cast<int>(e);
}

// The sweeps raycast_sweep_launch has queued in this process (one a call),
// counted here, where the runtime accepted them, apart from the wrapper's
// own count of its calls.
extern "C" long long raycast_sweep_cuda_launches() {
    return launched.load(std::memory_order_relaxed);
}
