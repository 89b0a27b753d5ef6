// K6: grid_raycast on the card, the uniform-grid walk and its hits in one
// launch.
//
// A kernel of the port only: the JAX package runs this cast as XLA, one
// lax.while_loop over all rays in lockstep (polychase_tpu/engine/
// gridcast.py:212-379: the slab entry :170, the candidate block :192, the
// loop body :293-353, the hits :357-379), not as a Pallas kernel.  Its
// plain torch version is polychase_tpu_torch/engine/gridcast.py::
// grid_plain, that loop in torch.
//
// N rays, each with its own origin o and direction d, through a uniform
// grid over a mesh: lo, h, res (3 each), CSR lists cell_start (prod(res)
// + 1) and items (triangle ids, each cell's in ascending id; cells
// x-major, flat = (ix * ry + iy) * rz + iz), and one row a triangle,
// [p1, e1 = p2 - p1, e2 = p3 - p1, 0, 0, 0].  A ray:
//   1. enters the grid's box at t0 (the slab test, directions parallel to
//      an axis handled apart), or misses it;
//   2. starts in the cell of o + max(t0, 0) d, clamped into the grid;
//   3. walks its cells (Amanatides-Woo): an action is a block of up to
//      `block` candidates of its cell, or, once the cell is exhausted, its
//      end (its best t at or before the cell's exit, or the next cell
//      outside the grid) or a step to the next cell;
//   4. tests each candidate by the general Moller-Trumbore test (its own
//      origin, |det| > 1e-10, u, v in the triangle, t > 0), keeping the
//      first strictly smaller t in visiting order;
//   5. stops after `max_iters` actions, as the lockstep stops after
//      max_iters iterations of one action for every active ray;
// then the mask bit (masked triangles still occlude) and the hit: its
// barycentrics the walk's, its position, its normal; zeroed (t infinite,
// id 0xFFFFFFFF) where not valid.
//
// Arithmetic: the plain version's, operation by operation, as torch's CUDA
// ops round it (measured on an H100 for K5, csrc/raycast_sweep.cu), so
// that every field matches it to the bit:
//   - torch.linalg.cross's a*b - c*d as fma(a, b, -(c*d));
//   - torch.sum over 3 as (p0 + p2) + p1, every product rounded;
//   - vector_norm as the square root of the squares summed in that order;
//   - 1.0 / x as an IEEE reciprocal and every / an IEEE division;
//   - every other product and sum rounded on its own (__fmul_rn,
//     __fadd_rn: nvcc would contract them into FMAs);
//   - torch.minimum / maximum / amin / amax propagating NaN, argmin taking
//     the first least value;
//   - the start cell clamped into the grid in float, NaN taking 0.
//
// Layout: one thread a ray, which walks its cells on its own: no lockstep,
// the cost a ray its own candidates and steps.  The grid's arrays and the
// triangle rows are read through the read-only path (__ldg); at the sizes
// the port casts (a mesh of 2M triangles: ~100 MB of items and as much of
// rows) they are L2-resident only in part.  Blocks of 32 to 128 threads,
// the most that still give every SM a block (kernels/grid_cast.py::
// block_threads): a tracking frame's 8192 rays are 256 blocks of 32 on
// 132 SMs.
//
// What bounds it on the card: neither bytes nor operations.  Each action
// is a chain of dependent loads (cell_start, then items, then the row)
// followed by ~54 operations a candidate; the warps of a block diverge
// where their rays take different walks, and a warp runs to its longest.
// The bound counts the inputs read once and the operations the walk of
// this data needs (chip_smoke.py::k6_bound); its share is low by design.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxThreads = 128;
constexpr float kEps = 1e-10f;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

std::atomic<long long> launched{0};

struct Params {
    const float* origins;    // (N, 3)
    const float* dirs;       // (N, 3)
    const int* cell_start;   // (prod(res) + 1,)
    const int* items;        // (n_items,)
    const float4* rows;      // (T, 3) float4: p1, e1, e2, 0 0 0
    const float* lo;         // (3,)
    const float* h;          // (3,)
    const int* res;          // (3,)
    const float* verts;      // (V, 3)
    const int64_t* tris;     // (T, 3)
    const int64_t* words;    // (>= ceil(T / 32),) mask bits, u32 values
    float* pos;              // (N, 3)
    float* normal;           // (N, 3)
    float* bary;             // (N, 2)
    float* t;                // (N,)
    int64_t* prim;           // (N,)
    bool* valid;             // (N,)
    int n, block, max_iters, check_mask;
};

// a*b - c*d as torch.linalg.cross rounds it.
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// x × y as torch.linalg.cross(x, y).
__device__ __forceinline__ void cross3(const float* x, const float* y,
                                       float* out) {
    out[0] = cross_term(x[1], y[2], x[2], y[1]);
    out[1] = cross_term(x[2], y[0], x[0], y[2]);
    out[2] = cross_term(x[0], y[1], x[1], y[0]);
}

// torch.sum(x * y, dim=-1) over 3 as the card rounds it: (p0 + p2) + p1.
__device__ __forceinline__ float tsum3(const float* x, const float* y) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x[0], y[0]), __fmul_rn(x[2], y[2])),
                     __fmul_rn(x[1], y[1]));
}

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.minimum / torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float tmin(float a, float b) {
    return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
    return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}

// The hit of ray r on triangle id at barycentrics (u, v), or none:
// raycast._ray_hits' operations after the mask test.
__device__ void write_hit(const Params& p, long long r, uint32_t id,
                          float best_t, float u, float v) {
    bool valid = id != kInvalid;
    if (valid && p.check_mask)
        valid = ((p.words[id >> 5] >> (id & 31u)) & 1) == 0;
    float pos[3] = {0.f, 0.f, 0.f}, nrm[3] = {0.f, 0.f, 0.f};
    if (valid) {
        const int64_t* tri = p.tris + 3 * static_cast<size_t>(id);
        float q[3][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float* x = p.verts + 3 * tri[c];
            q[c][0] = x[0];
            q[c][1] = x[1];
            q[c][2] = x[2];
        }
        float e1[3], e2[3], ng[3];
        const float w = __fsub_rn(__fsub_rn(1.f, u), v);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            e1[i] = __fsub_rn(q[1][i], q[0][i]);
            e2[i] = __fsub_rn(q[2][i], q[0][i]);
            pos[i] = __fadd_rn(__fadd_rn(__fmul_rn(w, q[0][i]),
                                         __fmul_rn(u, q[1][i])),
                               __fmul_rn(v, q[2][i]));
        }
        cross3(e1, e2, ng);
        const float n = fmaxf(__fsqrt_rn(tsum3(ng, ng)), 1e-20f);
#pragma unroll
        for (int i = 0; i < 3; ++i) nrm[i] = __fdiv_rn(ng[i], n);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        p.pos[3 * r + i] = pos[i];
        p.normal[3 * r + i] = nrm[i];
    }
    p.bary[2 * r] = valid ? u : 0.f;
    p.bary[2 * r + 1] = valid ? v : 0.f;
    p.t[r] = valid ? best_t : INFINITY;
    p.prim[r] = static_cast<int64_t>(valid ? id : kInvalid);
    p.valid[r] = valid;
}

__global__ void __launch_bounds__(kMaxThreads) grid_kernel(Params p) {
    const long long r =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= p.n) return;
    float o[3], d[3], lo[3], hi[3], h[3];
    int res[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = p.origins[3 * r + i];
        d[i] = p.dirs[3 * r + i];
        lo[i] = __ldg(p.lo + i);
        h[i] = __ldg(p.h + i);
        res[i] = __ldg(p.res + i);
        hi[i] = __fadd_rn(lo[i], __fmul_rn(h[i], static_cast<float>(res[i])));
    }

    // The slab entry: t0 = amax of the nears, t1 = amin of the fars (amax
    // over 3 as (a0 max a2) max a1, which NaN aside is any order).
    float a[3], b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const bool z = d[i] == 0.f;
        const float inv = __fdiv_rn(1.f, z ? 1.f : d[i]);
        float near = z ? (o[i] >= lo[i] ? -INFINITY : INFINITY)
                       : __fmul_rn(__fsub_rn(lo[i], o[i]), inv);
        float far = z ? (o[i] <= hi[i] ? INFINITY : -INFINITY)
                      : __fmul_rn(__fsub_rn(hi[i], o[i]), inv);
        if (z && (o[i] < lo[i] || o[i] > hi[i])) near = far = INFINITY;
        a[i] = tmin(near, far);
        b[i] = tmax(near, far);
    }
    const float t0 = tmax(tmax(a[0], a[2]), a[1]);
    const float t1 = tmin(tmin(b[0], b[2]), b[1]);
    const float ts = tmax(t0, 0.f);
    const bool inside = (t1 >= ts) && (t0 < INFINITY);

    float best_t = INFINITY, bu = 0.f, bv = 0.f;
    uint32_t best = kInvalid;
    if (inside && p.max_iters > 0) {
        int cell[3], step[3];
        float tmx[3], tdl[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float ps = __fadd_rn(o[i], __fmul_rn(d[i], ts));
            float c = floorf(__fdiv_rn(__fsub_rn(ps, lo[i]), h[i]));
            if (isnan_(c)) c = 0.f;
            c = fminf(fmaxf(c, 0.f), static_cast<float>(res[i] - 1));
            cell[i] = static_cast<int>(c);
            step[i] = d[i] > 0.f ? 1 : (d[i] < 0.f ? -1 : 0);
            const bool z = d[i] == 0.f;
            const float nb = __fadd_rn(
                lo[i], __fmul_rn(static_cast<float>(cell[i] + (step[i] > 0)),
                                 h[i]));
            tmx[i] = z ? INFINITY : __fdiv_rn(__fsub_rn(nb, o[i]), d[i]);
            tdl[i] = z ? INFINITY : fabsf(__fdiv_rn(h[i], d[i]));
        }
        int flat = (cell[0] * res[1] + cell[1]) * res[2] + cell[2];
        int ptr = __ldg(p.cell_start + flat);
        int end = __ldg(p.cell_start + flat + 1);

        for (int it = 0; it < p.max_iters; ++it) {
            if (ptr < end) {
                // A block of the cell's candidates; of equal t's the
                // first in visiting order stays.
                const int stop = min(ptr + p.block, end);
                for (int k = ptr; k < stop; ++k) {
                    const uint32_t id =
                        static_cast<uint32_t>(__ldg(p.items + k));
                    const float4 r0 = __ldg(p.rows + 3 * id);
                    const float4 r1 = __ldg(p.rows + 3 * id + 1);
                    const float4 r2 = __ldg(p.rows + 3 * id + 2);
                    const float p1[3] = {r0.x, r0.y, r0.z};
                    const float e1[3] = {r0.w, r1.x, r1.y};
                    const float e2[3] = {r1.z, r1.w, r2.x};
                    float rce2[3], s[3], sce1[3];
                    cross3(d, e2, rce2);
                    const float det = tsum3(e1, rce2);
                    const bool ok = fabsf(det) > kEps;
                    // torch: 1.0 / x is reciprocal(x) * 1.0.
                    const float inv_det = ok ? __fdiv_rn(1.f, det) : 0.f;
#pragma unroll
                    for (int i = 0; i < 3; ++i) s[i] = __fsub_rn(o[i], p1[i]);
                    const float u = __fmul_rn(inv_det, tsum3(s, rce2));
                    cross3(s, e1, sce1);
                    const float v = __fmul_rn(inv_det, tsum3(d, sce1));
                    const float t = __fmul_rn(inv_det, tsum3(e2, sce1));
                    const bool hit = ok && u >= 0.f && u <= 1.f && v >= 0.f &&
                                     __fadd_rn(u, v) <= 1.f && t > 0.f;
                    if (hit && t < best_t) {
                        best_t = t;
                        bu = u;
                        bv = v;
                        best = id;
                    }
                }
                ptr = stop;
                continue;
            }
            // The cell is exhausted: end here, or step to the next cell
            // along the axis whose boundary comes first.
            const float t_exit = tmin(tmin(tmx[0], tmx[2]), tmx[1]);
            if (best_t <= t_exit) break;
            const int ax = (tmx[0] <= tmx[1] && tmx[0] <= tmx[2])
                               ? 0
                               : (tmx[1] <= tmx[2] ? 1 : 2);
            // The axis selected without indexing by it, so that the
            // arrays stay in registers.
            bool out = false;
#pragma unroll
            for (int i = 0; i < 3; ++i)
                if (i == ax) {
                    cell[i] += step[i];
                    out = cell[i] < 0 || cell[i] >= res[i];
                    tmx[i] = __fadd_rn(tmx[i], tdl[i]);
                }
            if (out) break;
            flat = (cell[0] * res[1] + cell[1]) * res[2] + cell[2];
            ptr = __ldg(p.cell_start + flat);
            end = __ldg(p.cell_start + flat + 1);
        }
    }
    write_hit(p, r, best, best_t, bu, bv);
}

}  // namespace

// origins, dirs (N, 3), rows (T, 12), lo, h (3,), verts (V, 3): contiguous
// float32; cell_start, items, res (3,): contiguous int32; tris (T, 3) and
// words (ceil(T / 32) or more): contiguous int64.  Writes pos, normal
// (N, 3), bary (N, 2), t (N,) float32, prim (N,) int64 and valid (N,)
// bool: grid_raycast's hits.  block: candidates an action (>= 1);
// max_iters: actions a ray at most (>= 0); threads: threads a block (32,
// 64 or 128).  Queues one launch on the stream; returns the CUDA error (0
// on success).
extern "C" int grid_cast_launch(
    const void* origins, const void* dirs, const void* cell_start,
    const void* items, const void* rows, const void* lo, const void* h,
    const void* res, const void* verts, const void* tris, const void* words,
    int n, int block, int max_iters, int check_mask, int threads, void* pos,
    void* normal, void* bary, void* t, void* prim, void* valid,
    void* stream) {
    if (n < 1 || block < 1 || max_iters < 0 ||
        (threads != 32 && threads != 64 && threads != kMaxThreads))
        return cudaErrorInvalidValue;
    Params p;
    p.origins = static_cast<const float*>(origins);
    p.dirs = static_cast<const float*>(dirs);
    p.cell_start = static_cast<const int*>(cell_start);
    p.items = static_cast<const int*>(items);
    p.rows = static_cast<const float4*>(rows);
    p.lo = static_cast<const float*>(lo);
    p.h = static_cast<const float*>(h);
    p.res = static_cast<const int*>(res);
    p.verts = static_cast<const float*>(verts);
    p.tris = static_cast<const int64_t*>(tris);
    p.words = static_cast<const int64_t*>(words);
    p.pos = static_cast<float*>(pos);
    p.normal = static_cast<float*>(normal);
    p.bary = static_cast<float*>(bary);
    p.t = static_cast<float*>(t);
    p.prim = static_cast<int64_t*>(prim);
    p.valid = static_cast<bool*>(valid);
    p.n = n;
    p.block = block;
    p.max_iters = max_iters;
    p.check_mask = check_mask;
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    grid_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    launched.fetch_add(1, std::memory_order_relaxed);
    return 0;
}

// The launches grid_cast_launch has queued in this process (one a call),
// counted here, where the runtime accepted them, apart from the wrapper's
// own count of its calls.
extern "C" long long grid_cast_cuda_launches() {
    return launched.load(std::memory_order_relaxed);
}
