// K5: raycast_grouped on the card, the closest-hit sweep and its hits in one
// launch.
//
// A kernel of the port only: the JAX package runs this cast as XLA (the
// lax.scan over triangle chunks of polychase_tpu/engine/raycast.py:153
// raycast_grouped, scan body :224-271, and the ops after it), not as a
// Pallas kernel.  Its plain torch version is
// polychase_tpu_torch/engine/raycast.py::cast_plain (sweep_plain, then
// hits_plain).
//
// G groups of K rays, one origin o per group, against the T triangles of a
// mesh (vertices (V, 3), corner indices (T, 3); first corner v0, edges
// e1 = p2 - p1, e2 = p3 - p1).  With a shared origin the Moller-Trumbore
// triple products factor into
//   per triangle:            A = e2 x e1
//   per group and triangle:  omv = o - v0, B = e2 x omv, Cq = omv x e1,
//                            sdet = e2 . Cq
//   per ray and triangle:    det = d . A, udet = d . B, vdet = d . Cq
// and ray d hits when, with s the sign of det (+1 at det >= 0),
// |det| > 1e-10, u = s udet >= 0, v = s vdet >= 0, u + v <= |det| and
// s sdet > 0, at t = s sdet / |det| (an IEEE division).  A ray keeps the
// least t, and of equal t's the lowest triangle id, whatever the tiling.
// Then, for its winner: dropped if the triangle's mask bit is set, its
// barycentrics recomputed (dropped where that determinant is within 1e-10
// of 0), and its position, normal, barycentrics, t and id written, zeroed
// (t infinite, id 0xFFFFFFFF) where not valid.
//
// Arithmetic: the plain version's, operation by operation, so that every
// field can match it to the bit:
//   - a cross product's a*b - c*d as torch.linalg.cross rounds it on the
//     card: c*d rounded, then one fused multiply-add, fma(a, b, -(c*d));
//   - the sweep's dot products as ((d0 x0 + d1 x1) + d2 x2), every product
//     and sum rounded (__fmul_rn and __fadd_rn: nvcc would contract them
//     into FMAs), as the plain version's separate torch ops round them;
//   - torch.sum over 3 (sdet, the hit's determinants) as it rounds on the
//     card: (p0 + p2) + p1 (measured on an H100 with torch 2.11, CUDA 12.8;
//     the CPU's torch.sum takes (p0 + p1) + p2), and vector_norm as the
//     square root of the squares summed in that order;
//   - the sign normalisation folded away.  s sdet > 0 admits only rays
//     whose det has sdet's sign, so the grouped layout's stage stores A, B
//     and Cq negated where sdet < 0 (negation is exact, and so then are
//     det, udet and vdet, which become |det|, u and v wherever a hit is
//     possible), and A zeroed where sdet is 0 or NaN: the pair test is
//     det > 1e-10, u >= 0, v >= 0 and u + v <= det, on the plain
//     version's bits.  The packed layout, whose sdet is a ray's, flips
//     udet, vdet and sdet by det's sign bit (the plain version's multiply
//     by -1; at det = -0 or NaN no test can pass either way).  And
//     t = (s sdet) / (s det) = sdet / det, since IEEE division is symmetric
//     in the signs.
//
// Layout: blocks of kWarps = 16 warps, one block an SM.  A block owns
// 32 R rays, R to a thread (slot j * 32 + lane), and the same rays in every
// warp: the warps split each staged tile of kTile = 512 triangles between
// them, a run of 32 each.  A triangle's constants are read from shared
// memory as three broadcast float4s (the next triangle's while this one is
// tested) and feed R rays; the R rays' tests are one block of branch-free
// work, and the rare hit takes one branch for all of them.  The grouped
// layout (K >= 32) has one group a block: its stage computes A, B, Cq and
// sdet for the group's origin, sign-folded.  The packed layout (K < 32, the sharded
// flat cast's groups of one ray) takes 32 R rays of any groups: the stage
// holds v0, e1, e2 and A, and each ray forms its own B, Cq and sdet with
// the same operations.  Where the rays give too few blocks to fill the card
// (a tracking frame: 64 blocks of 128 rays), C blocks over C ranges of the
// triangles form a thread block cluster.  No more blocks than SMs are
// launched where clusters are used: the scheduler would otherwise stack
// several on some SMs while others idle.
//
// The tiles: each thread stages one triangle of a tile, gathered through
// its indices.  Its indices are loaded two tiles ahead and its corners one
// tile ahead into registers, so both loads are in flight while the block
// sweeps; the ring of two buffers in shared memory takes the next tile's
// constants as soon as the current one is swept, behind one barrier a
// tile.  (The stage is a gather through indices followed by arithmetic,
// not a copy: a bulk copy would only move the gather into shared memory.)
//
// The reduction: a 64-bit key a ray, t's bits << 32 | id (t >= 0, so its
// bits order like the floats), so the least key is the least t and then
// the lowest id.  The warps' keys meet in shared memory (the ring's, once
// it is swept), the cluster's ranks' in rank 0's through distributed
// shared memory, and rank 0 writes the hits.
//
// What bounds it on the card: operations.  In the grouped layout a (ray,
// triangle) pair costs 20: 15 products and sums in the three dot products,
// u + v and 4 compares (the sign fold is done once a (group, triangle), 26
// operations and 12 for the fold); in the packed layout 25, with the 4
// sign flips and the fifth compare, besides its (group, triangle) 26.  A
// triangle costs 15.  A tracking frame (8192 rays x 20,224 triangles,
// 1.66e8 pairs) is ~3.3e9 operations, 0.050 ms at 67 TFLOP/s, against
// ~1 MB of bytes.  None of the per-pair
// operations can be an FMA (the plain version's rounding), and the peak
// counts an FMA as two, so at most half of that rate is within reach.  The
// loop's instructions, not the f32 rate, set its pace: one instruction a
// cycle a scheduler, and ~23 of them a pair at R = 4 (the 15 products and
// sums, u + v, 4 compares, a quarter of the three loads and the loop).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;                  // warps a block, one ray set
constexpr int kThreads = 32 * kWarps;       // one block an SM
constexpr int kTile = kThreads;             // triangles staged, one a thread
constexpr int kWarpTris = kTile / kWarps;   // a warp's run of a tile
constexpr int kMaxRays = 4;                 // rays a thread at most
constexpr int kMaxCluster = 8;
constexpr float kEps = 1e-10f;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

std::atomic<long long> launched{0};

struct Params {
    const float* origins;  // (G, 3)
    const float* dirs;     // (G, K, 3)
    const float* verts;    // (V, 3)
    const int64_t* tris;   // (T, 3)
    const int64_t* words;  // (>= ceil(T / 32),) mask bits, u32 values
    float* pos;            // (G, K, 3)
    float* normal;         // (G, K, 3)
    float* bary;           // (G, K, 2)
    float* t;              // (G, K)
    int64_t* prim;         // (G, K)
    bool* valid;           // (G, K)
    int G, K, T;
    int ray_blocks;  // blocks of a group's rays (grouped layout)
    int per;         // triangles of a cluster rank
    int check_mask;
};

// The ring while the block sweeps, then the warps' keys (48 KB).
union Shared {
    float4 tri[2][3][kTile];
    unsigned long long key[kWarps][32 * kMaxRays];
};

// a*b - c*d as torch.linalg.cross rounds it.
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// x × y as torch.linalg.cross(x, y).
__device__ __forceinline__ float3 cross3(float x0, float x1, float x2,
                                         float y0, float y1, float y2) {
    return make_float3(cross_term(x1, y2, x2, y1), cross_term(x2, y0, x0, y2),
                       cross_term(x0, y1, x1, y0));
}

// (x0 y0 + x1 y1) + x2 y2, each operation rounded.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                     __fmul_rn(x2, y2));
}

// torch.sum(x * y, dim=-1) over 3 as the card rounds it: (p0 + p2) + p1.
__device__ __forceinline__ float tsum3(float x0, float x1, float x2,
                                       float y0, float y1, float y2) {
    return dot3(x0, x2, x1, y0, y2, y1);
}

__device__ __forceinline__ float flip(float x, uint32_t sign) {
    return __uint_as_float(__float_as_uint(x) ^ sign);
}

// One ray against one triangle's constants, the packed layout's test with
// the sign fold a pair: whether it hits, every test taken without a
// branch, and its det.
__device__ __forceinline__ bool hits(float d0, float d1, float d2, float ax,
                                     float ay, float az, float bx, float by,
                                     float bz, float cx, float cy, float cz,
                                     float sdet, float& det) {
    det = dot3(d0, d1, d2, ax, ay, az);
    const float ud = dot3(d0, d1, d2, bx, by, bz);
    const float vd = dot3(d0, d1, d2, cx, cy, cz);
    const uint32_t s = __float_as_uint(det) & 0x80000000u;
    const float adet = fabsf(det);
    const float u = flip(ud, s);
    const float v = flip(vd, s);
    return (adet > kEps) & (u >= 0.f) & (v >= 0.f) &
           (__fadd_rn(u, v) <= adet) & (flip(sdet, s) > 0.f);
}

// The same against constants whose sign fold is done (sdet > 0): det,
// udet and vdet are then u, v and |det| wherever a hit is possible.
__device__ __forceinline__ bool hits_folded(float d0, float d1, float d2,
                                            float ax, float ay, float az,
                                            float bx, float by, float bz,
                                            float cx, float cy, float cz,
                                            float& det) {
    det = dot3(d0, d1, d2, ax, ay, az);
    const float u = dot3(d0, d1, d2, bx, by, bz);
    const float v = dot3(d0, d1, d2, cx, cy, cz);
    return (det > kEps) & (u >= 0.f) & (v >= 0.f) & (__fadd_rn(u, v) <= det);
}

// A hit's t, kept with its id where it is closer than the ray's best.
__device__ __forceinline__ void keep(float sdet, float det, uint32_t id,
                                     float& best_t, uint32_t& best) {
    const float t = __fdiv_rn(sdet, det);
    if (t < best_t) {
        best_t = t;
        best = id;
    }
}

// The hit of ray (group g, flat index ray) on its closest triangle, from
// its key: hits_plain's operations.
__device__ void write_hit(const Params& p, int g, long long ray,
                          unsigned long long key) {
    const uint32_t id = static_cast<uint32_t>(key);
    bool valid = id != kInvalid;
    if (valid && p.check_mask)
        valid = ((p.words[id >> 5] >> (id & 31u)) & 1) == 0;
    float pos[3] = {0.f, 0.f, 0.f}, nrm[3] = {0.f, 0.f, 0.f};
    float u = 0.f, v = 0.f;
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
        const float* o = p.origins + 3 * g;
        const float* d = p.dirs + 3 * ray;
        float e1[3], e2[3], m[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            e1[i] = __fsub_rn(q[1][i], q[0][i]);
            e2[i] = __fsub_rn(q[2][i], q[0][i]);
            m[i] = __fsub_rn(o[i], q[0][i]);
        }
        const float3 bb = cross3(e2[0], e2[1], e2[2], m[0], m[1], m[2]);
        const float3 bc = cross3(m[0], m[1], m[2], e1[0], e1[1], e1[2]);
        const float3 ba = cross3(e2[0], e2[1], e2[2], e1[0], e1[1], e1[2]);
        const float bdet = tsum3(d[0], d[1], d[2], ba.x, ba.y, ba.z);
        valid = fabsf(bdet) > kEps;
        if (valid) {
            // torch: 1.0 / bdet is reciprocal(bdet) * 1.0.
            const float binv = __fdiv_rn(1.f, bdet);
            u = __fmul_rn(tsum3(d[0], d[1], d[2], bb.x, bb.y, bb.z), binv);
            v = __fmul_rn(tsum3(d[0], d[1], d[2], bc.x, bc.y, bc.z), binv);
            const float w = __fsub_rn(__fsub_rn(1.f, u), v);
#pragma unroll
            for (int i = 0; i < 3; ++i)
                pos[i] = __fadd_rn(__fadd_rn(__fmul_rn(w, q[0][i]),
                                             __fmul_rn(u, q[1][i])),
                                   __fmul_rn(v, q[2][i]));
            const float3 ng = cross3(e1[0], e1[1], e1[2], e2[0], e2[1],
                                     e2[2]);
            const float len =
                __fsqrt_rn(tsum3(ng.x, ng.y, ng.z, ng.x, ng.y, ng.z));
            const float n = fmaxf(len, 1e-20f);
            nrm[0] = __fdiv_rn(ng.x, n);
            nrm[1] = __fdiv_rn(ng.y, n);
            nrm[2] = __fdiv_rn(ng.z, n);
        }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        p.pos[3 * ray + i] = pos[i];
        p.normal[3 * ray + i] = nrm[i];
    }
    p.bary[2 * ray] = u;
    p.bary[2 * ray + 1] = v;
    p.t[ray] = valid ? __uint_as_float(static_cast<uint32_t>(key >> 32))
                     : INFINITY;
    p.prim[ray] = static_cast<int64_t>(valid ? id : kInvalid);
    p.valid[ray] = valid;
}

// R rays a thread; PACKED: the packed layout (each ray its own group's
// constants), else the grouped one.
template <int R, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1) hits_kernel(Params p) {
    __shared__ Shared sh;
    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int rb = static_cast<int>(blockIdx.x) / C;
    const int tid = static_cast<int>(threadIdx.x);
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long rays = static_cast<long long>(p.G) * p.K;

    // Slot j * 32 + lane of the block's rays: ray index base_ray + slot
    // (grouped: k within group g; packed: the flat index, group ray / K).
    // Origins: each ray's (packed), or the group's in slot 0 on every
    // thread, live or not (grouped: its stage takes it).
    const int g_block = PACKED ? 0 : rb / p.ray_blocks;
    const long long base_ray =
        PACKED ? static_cast<long long>(rb) * 32 * R
               : static_cast<long long>(rb % p.ray_blocks) * 32 * R;
    float d0[R], d1[R], d2[R], ox[R], oy[R], oz[R], best_t[R];
    uint32_t best[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const long long r = base_ray + j * 32 + lane;
        const bool live = PACKED ? r < rays : r < p.K;
        const long long flat =
            PACKED ? r : static_cast<long long>(g_block) * p.K + r;
        const int g = PACKED ? static_cast<int>(r / p.K) : g_block;
        d0[j] = live ? p.dirs[3 * flat] : 0.f;
        d1[j] = live ? p.dirs[3 * flat + 1] : 0.f;
        d2[j] = live ? p.dirs[3 * flat + 2] : 0.f;
        const bool own = PACKED ? live : j == 0;
        ox[j] = own ? p.origins[3 * g] : 0.f;
        oy[j] = own ? p.origins[3 * g + 1] : 0.f;
        oz[j] = own ? p.origins[3 * g + 2] : 0.f;
        best_t[j] = INFINITY;
        best[j] = kInvalid;
    }

    // This rank's triangles, staged a tile at a time, one a thread.
    const int lo = min(p.T, rank * p.per);
    const int hi = min(p.T, lo + p.per);
    int idx[3] = {0, 0, 0};
    float q[9];
    auto load_idx = [&](int base) {
        const int i = base + tid;
        if (i < hi) {
            const int64_t* t = p.tris + 3 * static_cast<size_t>(i);
            idx[0] = static_cast<int>(t[0]);
            idx[1] = static_cast<int>(t[1]);
            idx[2] = static_cast<int>(t[2]);
        }
    };
    auto load_corners = [&](int base) {
        if (base + tid < hi) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float* x = p.verts + 3 * static_cast<size_t>(idx[c]);
                q[3 * c] = x[0];
                q[3 * c + 1] = x[1];
                q[3 * c + 2] = x[2];
            }
        }
    };
    auto stage = [&](int base, int buf) {
        if (base + tid >= hi) return;
        const float e1x = __fsub_rn(q[3], q[0]), e1y = __fsub_rn(q[4], q[1]),
                    e1z = __fsub_rn(q[5], q[2]);
        const float e2x = __fsub_rn(q[6], q[0]), e2y = __fsub_rn(q[7], q[1]),
                    e2z = __fsub_rn(q[8], q[2]);
        const float3 a = cross3(e2x, e2y, e2z, e1x, e1y, e1z);
        if (PACKED) {
            sh.tri[buf][0][tid] = make_float4(a.x, a.y, a.z, q[0]);
            sh.tri[buf][1][tid] = make_float4(q[1], q[2], e1x, e1y);
            sh.tri[buf][2][tid] = make_float4(e1z, e2x, e2y, e2z);
        } else {
            const float mx = __fsub_rn(ox[0], q[0]);
            const float my = __fsub_rn(oy[0], q[1]);
            const float mz = __fsub_rn(oz[0], q[2]);
            const float3 b = cross3(e2x, e2y, e2z, mx, my, mz);
            const float3 c = cross3(mx, my, mz, e1x, e1y, e1z);
            const float sdet = tsum3(e2x, e2y, e2z, c.x, c.y, c.z);
            // The sign fold, once a triangle: a ray hits only where its
            // det has sdet's sign, so where sdet < 0 the constants are
            // stored negated (exactly, and so are det, udet and vdet), and
            // where sdet is 0 or NaN, A is zeroed (no ray hits).
            const float f = sdet > 0.f ? 1.f : -1.f;
            const float fa = sdet > 0.f || sdet < 0.f ? f : 0.f;
            sh.tri[buf][0][tid] = make_float4(fa * a.x, fa * a.y, fa * a.z,
                                              fabsf(sdet));
            sh.tri[buf][1][tid] = make_float4(f * b.x, f * b.y, f * b.z, 0.f);
            sh.tri[buf][2][tid] = make_float4(f * c.x, f * c.y, f * c.z, 0.f);
        }
    };
    if (lo < hi) {
        load_idx(lo);
        load_corners(lo);
        if (lo + kTile < hi) load_idx(lo + kTile);
        stage(lo, 0);
    }
    int buf = 0;
    for (int base = lo; base < hi; base += kTile) {
        const int next = base + kTile;
        if (next < hi) {
            load_corners(next);  // its indices arrived during the last sweep
            if (next + kTile < hi) load_idx(next + kTile);
        }
        __syncthreads();  // tile `base` is staged in buf
        const int w0 = warp * kWarpTris;
        const int w1 = min(hi - base, w0 + kWarpTris);
        // The R rays' tests of a triangle form one block of independent
        // work; the rare hit takes one branch for all of them, and the
        // next triangle's constants are read while this one is tested.
        const float4* ta = sh.tri[buf][0];
        const float4* tb = sh.tri[buf][1];
        const float4* tc = sh.tri[buf][2];
        float4 a = ta[w0];
        float4 b = tb[w0];
        float4 c = tc[w0];
#pragma unroll 2
        for (int i = w0; i < w1; ++i) {
            const int nx = min(i + 1, kTile - 1);
            const float4 an = ta[nx];
            const float4 bn = tb[nx];
            const float4 cn = tc[nx];
            float det[R], sdet[R];
            bool hit[R];
            bool any = false;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if (PACKED) {
                    // v0 = (a.w, b.x, b.y), e1 = (b.z, b.w, c.x),
                    // e2 = (c.y, c.z, c.w), A = a.xyz.
                    const float mx = __fsub_rn(ox[j], a.w);
                    const float my = __fsub_rn(oy[j], b.x);
                    const float mz = __fsub_rn(oz[j], b.y);
                    const float3 bb = cross3(c.y, c.z, c.w, mx, my, mz);
                    const float3 cq = cross3(mx, my, mz, b.z, b.w, c.x);
                    sdet[j] = tsum3(c.y, c.z, c.w, cq.x, cq.y, cq.z);
                    hit[j] = hits(d0[j], d1[j], d2[j], a.x, a.y, a.z, bb.x,
                                  bb.y, bb.z, cq.x, cq.y, cq.z, sdet[j],
                                  det[j]);
                } else {
                    sdet[j] = a.w;
                    hit[j] = hits_folded(d0[j], d1[j], d2[j], a.x, a.y, a.z,
                                         b.x, b.y, b.z, c.x, c.y, c.z,
                                         det[j]);
                }
                any |= hit[j];
            }
            if (any) {
                const uint32_t id = static_cast<uint32_t>(base + i);
#pragma unroll
                for (int j = 0; j < R; ++j)
                    if (hit[j]) keep(sdet[j], det[j], id, best_t[j], best[j]);
            }
            a = an;
            b = bn;
            c = cn;
        }
        // Buffer buf ^ 1 was swept last tile, before the barrier above.
        if (next < hi) stage(next, buf ^ 1);
        buf ^= 1;
    }

    __syncthreads();  // the ring is swept: its memory takes the keys
#pragma unroll
    for (int j = 0; j < R; ++j)
        sh.key[warp][j * 32 + lane] =
            (static_cast<unsigned long long>(__float_as_uint(best_t[j]))
             << 32) | best[j];
    __syncthreads();
    const int slots = 32 * R;
    unsigned long long key = ~0ull;
    if (tid < slots) {
        key = sh.key[0][tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) key = min(key, sh.key[w][tid]);
        sh.key[0][tid] = key;
    }
    if (C > 1) {
        cluster.sync();  // every rank's keys are in its key[0]
        if (rank == 0 && tid < slots)
            for (int r = 1; r < C; ++r)
                key = min(key, *cluster.map_shared_rank(&sh.key[0][tid], r));
        cluster.sync();  // read: the other ranks may leave
    }
    if (rank != 0 || tid >= slots) return;
    const long long r = base_ray + tid;
    if (PACKED) {
        if (r < rays) write_hit(p, static_cast<int>(r / p.K), r, key);
    } else if (r < p.K) {
        write_hit(p, g_block, static_cast<long long>(g_block) * p.K + r, key);
    }
}

template <int R, bool PACKED>
cudaError_t launch(const Params& p, int blocks, int cluster,
                   cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, hits_kernel<R, PACKED>, p);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace

// origins (G, 3), dirs (G, K, 3), verts (V, 3): contiguous float32; tris
// (T, 3) and words (ceil(T / 32) or more): contiguous int64.  Writes pos,
// normal (G, K, 3), bary (G, K, 2), t (G, K) float32, prim (G, K) int64 and
// valid (G, K) bool: raycast_grouped's hits.  rays: rays a thread (2 or
// 4, and 4 when packed: launch_plan packs only groups under 32 rays, which
// take 4); packed: the packed layout (each ray its own group's constants), else
// blocks of one group; ray_blocks: blocks of 32 * rays rays (in all when
// packed, a group's otherwise); cluster: blocks a cluster over the
// triangles (1, 2, 4 or 8).  Queues one launch on the stream; returns the
// CUDA error (0 on success).
extern "C" int raycast_sweep_launch(
    const void* origins, const void* dirs, const void* verts,
    const void* tris, const void* words, int G, int K, int T, int rays,
    int packed, int ray_blocks, int cluster, int check_mask, void* pos,
    void* normal, void* bary, void* t, void* prim, void* valid,
    void* stream) {
    if (G < 1 || K < 1 || T < 0 || T >= 0x7FFFFFFF || ray_blocks < 1 ||
        cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
        (rays != 2 && rays != kMaxRays) || (packed && rays != kMaxRays))
        return cudaErrorInvalidValue;
    const long long want = packed
        ? (static_cast<long long>(G) * K + 32 * rays - 1) / (32 * rays)
        : static_cast<long long>(G) * ((K + 32 * rays - 1) / (32 * rays));
    const long long blocks = want * cluster;
    if (ray_blocks != (packed ? want : want / G) || blocks > 0x7FFFFFFF)
        return cudaErrorInvalidValue;
    Params p;
    p.origins = static_cast<const float*>(origins);
    p.dirs = static_cast<const float*>(dirs);
    p.verts = static_cast<const float*>(verts);
    p.tris = static_cast<const int64_t*>(tris);
    p.words = static_cast<const int64_t*>(words);
    p.pos = static_cast<float*>(pos);
    p.normal = static_cast<float*>(normal);
    p.bary = static_cast<float*>(bary);
    p.t = static_cast<float*>(t);
    p.prim = static_cast<int64_t*>(prim);
    p.valid = static_cast<bool*>(valid);
    p.G = G;
    p.K = K;
    p.T = T;
    p.ray_blocks = ray_blocks;
    p.per = (T + cluster - 1) / cluster;
    p.check_mask = check_mask;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n = static_cast<int>(blocks);
    cudaError_t e;
    if (packed) {
        e = launch<kMaxRays, true>(p, n, cluster, s);
    } else {
        e = rays == 2 ? launch<2, false>(p, n, cluster, s)
                      : launch<4, false>(p, n, cluster, s);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    launched.fetch_add(1, std::memory_order_relaxed);
    return 0;
}

// The launches raycast_sweep_launch has queued in this process (one a
// call), counted here, where the runtime accepted them, apart from the
// wrapper's own count of its calls.
extern "C" long long raycast_sweep_cuda_launches() {
    return launched.load(std::memory_order_relaxed);
}
