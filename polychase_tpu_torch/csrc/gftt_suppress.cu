// K4: GFTT's greedy min-distance suppression on the card, as a fixed point,
// in one persistent cooperative launch, with the kept list compacted.
//
// A kernel of the port only: the JAX package runs this suppression as XLA
// (polychase_tpu/engine/gftt.py::_suppress_device, a lax.while_loop), not
// as a Pallas kernel.  The host algorithm visits the candidates by (quality
// descending, later row-major position first) and keeps one when no kept
// point lies strictly within the radius.  Its parallel form decides, each
// round, every undecided point that beats all undecided points of its disc:
//
//   1. reject pass: an undecided point with a kept point in its disc is
//      rejected (kept points only accumulate, so the greedy pass rejects it
//      whenever it comes to it);
//   2. select pass: an undecided point whose key beats every undecided
//      neighbour's is kept.  The key is (float bits of q) << 32 | lin, one
//      64-bit integer: q > 0 for every undecided point, so its bits order
//      like the floats, and the later index wins a tie of qualities.
//
// A byte of state per pixel (none, undecided, kept, won this round).  A
// point that wins in a select pass is marked "won": its neighbours still
// count it as undecided in that pass, and the next reject pass turns it
// into "kept".  So within a pass no pixel changes between the two classes
// its neighbours test (kept-or-won in a reject pass, undecided-or-won in a
// select pass), and a pass reads the same answers from a snapshot taken at
// its start as from the live map.
//
// One launch does the whole call.  The grid is as many blocks as can be
// co-resident (occupancy x SMs, fewer for short frames), launched with
// cudaLaunchCooperativeKernel, and the passes are separated by grid-wide
// barriers.  Each block owns a band of whole rows:
//   - the init pass writes the band's state and compacts its candidates
//     (undecided or won) into a list in shared memory, in row-major order
//     (entries past its capacity go to the band's part of a global spill
//     buffer);
//   - every later pass visits only the list's entries, and a reject pass
//     drops the entries it decides (a fresh call's first round has nothing
//     kept, and skips its reject pass);
//   - the quality map never changes, so the band and its halo of r rows
//     (r the disc's radius) are staged in shared memory with cp.async, once
//     where they fit; a band too wide for shared memory is walked in column
//     chunks, each staged with its halo in every select pass;
//   - a candidate reads its disc row by row, each row's state bytes as
//     aligned 32-bit words, from L2 (ld.global.cg: other blocks write
//     them; on an H100 this beat a shared-memory copy of the band's states
//     whose halo rows were staged again after each barrier, PERF.md).
// Every block reads the same per-block "undecided left" flags after the
// same barrier, so all leave the round loop together: when no point is left
// undecided, or after max_rounds rounds.  Then each block
// counts its band's kept points, a prefix of those counts in band order
// (after one more barrier) places them, and the band is scanned in
// row-major order into (vals, idx): the kept points' qualities and indices
// in row-major order, zero past the count, as engine/gftt.py::_compact_kept
// gives them.  A call given an earlier call's state (resume) builds its
// lists from that state and runs max_rounds more rounds: the greedy result
// does not depend on where the rounds were cut.
//
// What bounds it on the card: the function moves the quality map in (4
// bytes a pixel) and the kept map out (1 byte), 10.4 MB at 1920x1080, 3.1 µs
// at 3.35 TB/s, and does a few compares a pixel and pass.  The kernel reads
// the map once into shared memory and then works on the ~5% of pixels that
// hold a candidate; what is left is the latency of the passes: a grid
// barrier after each, and a candidate's dependent reads of its disc rows.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned char kNone = 0;
constexpr unsigned char kUndecided = 1;
constexpr unsigned char kKept = 2;
constexpr unsigned char kWon = 3;
constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
// Words of a disc row loaded at once: a row of up to 15 bytes (r <= 7)
// spans at most 5 aligned 32-bit words.
constexpr int kWords = 5;
// Pixels a thread takes in a scan of its band.
constexpr int kRun = 8;
// A list entry is a pixel index; this bit marks a point won in the last
// select pass, which the next reject pass keeps.
constexpr int kWonBit = 1 << 30;
constexpr int kDropped = -1;

struct Params {
    const float* q;           // (h, w) qualities, 0 where no candidate
    unsigned char* state;     // (h, w)
    const int* hx;            // (2r + 1) the disc's half-width a row, -1 none
    float* vals;              // (k) kept qualities, row-major
    int64_t* idx;             // (k) kept indices
    int64_t* count;           // kept points
    int* rounds;              // rounds run
    unsigned char* converged; // no point left undecided
    int* ctl;                 // 3 x grid: flags (two slots), band counts
    int* spill;               // (h, w): list entries past the capacity
    int h, w, r, max_rounds, resume, k;
    int rows, cw, nchunks, tw, th, cap;  // band and tile geometry
    int off_disc, off_list, off_q;       // shared-memory layout
};

struct Scratch {
    int warp_n[32];
    int total, und, kept, wins, before, all;
};

__device__ __forceinline__ uint64_t key_of(float q, int i) {
    return (static_cast<uint64_t>(__float_as_uint(q)) << 32) |
           static_cast<uint32_t>(i);
}

// Exclusive prefix of the threads' counts in thread order; *total gets
// the block's sum.  Every thread of the block calls it.
__device__ int block_scan(int c, Scratch* s, int* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    int x = c;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s->warp_n[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int v0 = lane < warps ? s->warp_n[lane] : 0;
        int v = v0;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += y;
        }
        if (lane < warps) s->warp_n[lane] = v - v0;
        if (lane == 31) s->total = v;
    }
    __syncthreads();
    const int before = s->warp_n[warp] + x - c;
    *total = s->total;
    __syncthreads();
    return before;
}

// Whether any block raised its flag in flags[0, g).
__device__ bool any_flag(const int* flags, int g) {
    int f = 0;
    for (int i = threadIdx.x; i < g; i += blockDim.x) f |= __ldcg(flags + i);
    return __syncthreads_or(f) != 0;
}

// A block's band of rows [y0, y1) and its candidate list: entries below cap
// in shared memory, the rest in the band's part of the spill buffer.
struct Band {
    int y0, y1, cap;
    int* list;
    int* spill;
    __device__ int get(int e) const {
        return e < cap ? list[e] : __ldcg(spill + e);
    }
    __device__ void set(int e, int v) const {
        if (e < cap)
            list[e] = v;
        else
            spill[e] = v;
    }
};

// Stages the quality map's rows [y0 - r, y0 + rows + r) x columns
// [c0 - r, c0 + cw + r) into the tile by cp.async; cells outside the frame
// are never read.
__device__ void stage(const Params& p, const Band& b, int c0, float* qt) {
    const int ty0 = b.y0 - p.r;
    const int tx0 = c0 - p.r;
    const int n = p.th * p.tw;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int ty = t / p.tw;
        const int y = ty0 + ty;
        const int x = tx0 + t - ty * p.tw;
        if (y >= 0 && y < p.h && x >= 0 && x < p.w)
            __pipeline_memcpy_async(qt + t, p.q + y * p.w + x, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
}

// Scans the disc of pixel (y, x) row by row: each row's state bytes are
// read from L2 as aligned 32-bit words (kWords at a time), the bytes
// outside the row masked off.  The reject scan (kSelect false) reports a
// byte >= kept (bit 1 set); the select scan an undecided-or-won byte (bit
// 0) whose key beats `key`, its quality read from the tile at column
// chunk c0.  The row through the pixel itself holds it: it is undecided
// in both scans and never beats its own key.  A word may take up to 3
// bytes past a row's end or the map's; the state map is a torch
// allocation, rounded up to 512 bytes.
template <bool kSelect>
__device__ bool scan_disc(const Params& p, const Band& b, const int* hx,
                          const float* qt, int y, int x, int c0,
                          uint64_t key) {
    for (int dy = -p.r; dy <= p.r; ++dy) {
        const int yy = y + dy;
        const int half = hx[dy + p.r];
        if (half < 0 || yy < 0 || yy >= p.h) continue;
        const int xa = max(x - half, 0);
        const int xb = min(x + half, p.w - 1);
        const int base = yy * p.w + xa;                            // frame
        const int tq = (yy - b.y0 + p.r) * p.tw + (xa - c0 + p.r);  // tile
        const int last = base + xb - xa;
        for (int a0 = base & ~3; a0 <= last; a0 += 4 * kWords) {
            uint32_t word[kWords];
#pragma unroll
            for (int u = 0; u < kWords; ++u) {
                const int a = a0 + 4 * u;
                word[u] = 0;
                if (a <= last)
                    word[u] = __ldcg(
                        reinterpret_cast<const unsigned*>(p.state + a));
            }
#pragma unroll
            for (int u = 0; u < kWords; ++u) {
                const int a = a0 + 4 * u;
                if (a > last) break;
                const int lo = base > a ? base - a : 0;
                const int hi = last - a < 3 ? last - a : 3;
                const uint32_t mask =
                    (0xffffffffu >> (8 * (3 - hi))) & (0xffffffffu << (8 * lo));
                if (!kSelect) {
                    if (word[u] & mask & 0x02020202u) return true;
                    continue;
                }
                uint32_t odd = word[u] & mask & 0x01010101u;
                while (odd) {
                    const int m = a + ((__ffs(odd) - 1) >> 3) - base;
                    if (key_of(qt[tq + m], base + m) > key) return true;
                    odd &= odd - 1;
                }
            }
        }
    }
    return false;
}

// Removes the dropped entries, keeping the others' order; returns the new
// length.
__device__ int compact(const Band& b, int n, Scratch* s) {
    int out = 0;
    for (int base = 0; base < n; base += blockDim.x) {
        const int e = base + threadIdx.x;
        const int v = e < n ? b.get(e) : kDropped;
        int total;
        // Reads of this stretch finish before block_scan's barriers; the
        // writes land at or below it.
        const int rank = block_scan(v != kDropped, s, &total);
        if (v != kDropped) b.set(out + rank, v);
        out += total;
    }
    __syncthreads();
    return out;
}

__device__ __forceinline__ int tile_index(const Params& p, const Band& b,
                                          int y, int x, int c0) {
    return (y - b.y0 + p.r) * p.tw + (x - c0 + p.r);
}

// Reject pass: won -> kept, undecided with a kept (or won) neighbour ->
// none; both leave the list.  Returns the list's new length.
__device__ int reject_pass(const Params& p, const Band& b, Scratch* s,
                           const int* hx, int n) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int v = b.get(e);
        const int i = v & ~kWonBit;
        const int y = i / p.w;
        const int x = i - y * p.w;
        unsigned char to;
        if (v & kWonBit)
            to = kKept;
        else if (scan_disc<false>(p, b, hx, nullptr, y, x, 0, 0))
            to = kNone;
        else
            continue;
        p.state[i] = to;
        b.set(e, kDropped);
    }
    __syncthreads();
    return compact(b, n, s);
}

// Select pass: an undecided point whose key beats every undecided (or won)
// neighbour's is won; it stays in the list, marked, for the next reject
// pass, as does every point left undecided.  Returns whether one is left
// undecided in this thread's share; *wins counts the thread's wins.
__device__ bool select_pass(const Params& p, const Band& b, const int* hx,
                            float* qt, int n, int* wins) {
    bool remains = false;
    for (int c = 0; c < p.nchunks; ++c) {
        const int c0 = c * p.cw;
        if (p.nchunks > 1) stage(p, b, c0, qt);
        for (int e = threadIdx.x; e < n; e += blockDim.x) {
            const int i = b.get(e);
            if (i & kWonBit) continue;  // won in an earlier chunk
            const int y = i / p.w;
            const int x = i - y * p.w;
            if (p.nchunks > 1 && (x < c0 || x >= c0 + p.cw)) continue;
            const float qi = qt[tile_index(p, b, y, x, c0)];
            if (scan_disc<true>(p, b, hx, qt, y, x, c0, key_of(qi, i))) {
                remains = true;
                continue;
            }
            p.state[i] = kWon;
            b.set(e, i | kWonBit);
            ++*wins;
        }
        __syncthreads();
    }
    return remains;
}

__global__ void __launch_bounds__(kThreads, 1) suppress_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    Scratch* s = reinterpret_cast<Scratch*>(smem);
    int* hx = reinterpret_cast<int*>(smem + p.off_disc);
    float* qt = reinterpret_cast<float*>(smem + p.off_q);
    cg::grid_group grid = cg::this_grid();
    const int g = gridDim.x;
    const int bid = blockIdx.x;
    const int tid = threadIdx.x;

    Band b;
    b.y0 = min(p.h, bid * p.rows);
    b.y1 = min(p.h, b.y0 + p.rows);
    b.cap = p.cap;
    b.list = reinterpret_cast<int*>(smem + p.off_list);
    b.spill = p.spill + static_cast<size_t>(b.y0) * p.w;
    for (int o = tid; o <= 2 * p.r; o += blockDim.x) hx[o] = p.hx[o];
    if (tid == 0) s->und = s->kept = s->wins = s->before = s->all = 0;
    // A band whose tile fits is staged once; its barrier also publishes
    // the disc's rows and the counters.
    if (p.nchunks == 1)
        stage(p, b, 0, qt);
    else
        __syncthreads();

    // Init pass: the band's state and its list, in row-major order, kRun
    // pixels a thread.
    const int lo = b.y0 * p.w;
    const int hi = b.y1 * p.w;
    int und = 0, kept = 0, n = 0;
    for (int base = lo; base < hi; base += kRun * blockDim.x) {
        const int first = base + kRun * tid;
        unsigned char v[kRun];
        int c = 0;
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
            const int i = first + u;
            v[u] = kNone;
            if (i < hi) {
                if (p.resume) {
                    v[u] = __ldcg(p.state + i);
                } else {
                    v[u] = __ldg(p.q + i) > 0.0f ? kUndecided : kNone;
                    p.state[i] = v[u];
                }
                und += v[u] == kUndecided;
                kept += v[u] >= kKept;
                c += v[u] & 1;
            }
        }
        int total;
        int e = n + block_scan(c, s, &total);
#pragma unroll
        for (int u = 0; u < kRun; ++u)
            if (v[u] & 1)
                b.set(e++, (first + u) | (v[u] == kWon ? kWonBit : 0));
        n += total;
    }
    atomicAdd(&s->und, und);
    atomicAdd(&s->kept, kept);
    __syncthreads();
    if (tid == 0) p.ctl[bid] = s->und > 0;
    grid.sync();

    int rounds = 0, wins = 0;
    bool pending = any_flag(p.ctl, g);
    while (pending && rounds < p.max_rounds) {
        // A fresh call's first round has nothing kept to reject by.
        if (rounds > 0 || p.resume) {
            n = reject_pass(p, b, s, hx, n);
            grid.sync();
        }
        const int left =
            __syncthreads_or(select_pass(p, b, hx, qt, n, &wins));
        ++rounds;
        if (tid == 0) p.ctl[(rounds & 1) * g + bid] = left;
        grid.sync();
        pending = any_flag(p.ctl + (rounds & 1) * g, g);
    }
    atomicAdd(&s->wins, wins);
    __syncthreads();
    if (bid == 0 && tid == 0) {
        *p.rounds = rounds;
        *p.converged = !pending;
    }

    // The kept list: the bands' counts, their prefix in band order, then
    // each band's kept points in row-major order, kRun pixels a thread.
    if (tid == 0) p.ctl[2 * g + bid] = s->kept + s->wins;
    grid.sync();
    int before = 0, all = 0;
    for (int i = tid; i < g; i += blockDim.x) {
        const int c = __ldcg(p.ctl + 2 * g + i);
        all += c;
        before += i < bid ? c : 0;
    }
    atomicAdd(&s->before, before);
    atomicAdd(&s->all, all);
    __syncthreads();
    before = s->before;
    all = s->all;
    if (bid == 0 && tid == 0) *p.count = all;
    int out = before;
    for (int base = lo; base < hi && out < p.k; base += kRun * blockDim.x) {
        const int first = base + kRun * tid;
        bool is_kept[kRun];
        int c = 0;
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
            is_kept[u] =
                first + u < hi && __ldcg(p.state + first + u) >= kKept;
            c += is_kept[u];
        }
        int total;
        int e = out + block_scan(c, s, &total);
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
            if (is_kept[u] && e < p.k) {
                p.vals[e] = __ldg(p.q + first + u);
                p.idx[e] = first + u;
            }
            e += is_kept[u];
        }
        out += total;
    }
    for (int e = all + bid * blockDim.x + tid; e < p.k;
         e += g * blockDim.x) {
        p.vals[e] = 0.0f;
        p.idx[e] = 0;
    }
}

constexpr int align16(long long n) { return static_cast<int>((n + 15) / 16 * 16); }

// The band and tile geometry of a grid of g blocks within `budget` bytes of
// shared memory; false when not even a one-column chunk fits.
bool plan(Params& p, int g, long long budget, size_t* smem) {
    p.rows = (p.h + g - 1) / g;
    p.th = p.rows + 2 * p.r;
    const long long band = static_cast<long long>(p.rows) * p.w;
    const long long fixed =
        align16(sizeof(Scratch)) + align16(4LL * (2 * p.r + 1));
    const long long per_col = 4LL * p.th;
    const long long min_tile = per_col * (2 * p.r + 1);
    // The list holds a sixth of the band (NMS leaves ~5% of the pixels as
    // candidates); the quality tile gets the rest.
    long long cap = band < band / 6 + 64 ? band : band / 6 + 64;
    if (fixed + 4 * cap + min_tile > budget) cap = (budget - fixed - min_tile) / 4;
    if (cap < 0) return false;
    const long long cols = (budget - fixed - align16(4 * cap)) / per_col;
    long long cw = cols - 2 * p.r;
    if (cw < 1) return false;
    if (cw > p.w) cw = p.w;
    p.nchunks = static_cast<int>((p.w + cw - 1) / cw);
    p.cw = (p.w + p.nchunks - 1) / p.nchunks;
    p.tw = p.cw + 2 * p.r;
    p.cap = static_cast<int>(cap);
    p.off_disc = align16(sizeof(Scratch));
    p.off_list = p.off_disc + align16(4LL * (2 * p.r + 1));
    p.off_q = p.off_list + align16(4LL * cap);
    *smem = p.off_q + 4LL * p.th * p.tw;
    return true;
}

struct DeviceInfo {
    std::atomic<bool> ready;
    int sms, optin;
};
DeviceInfo devices[kMaxDevices];
// Cooperative launches the runtime accepted, in this process.
std::atomic<long long> launched{0};

// The SM count and the opt-in shared memory of the current device, and the
// kernel's shared-memory attribute set on it: a function's attributes
// belong to the device that is current when they are set.
cudaError_t prepare(DeviceInfo** info) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    DeviceInfo& d = devices[dev];
    *info = &d;
    if (d.ready.load(std::memory_order_acquire)) return cudaSuccess;
    int sms = 0, optin = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(suppress_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (e != cudaSuccess) return e;
    d.sms = sms;
    d.optin = optin;
    d.ready.store(true, std::memory_order_release);
    return cudaSuccess;
}

cudaError_t launch(Params& p, int blocks, int ctl_blocks,
                   cudaStream_t stream) {
    DeviceInfo* d = nullptr;
    cudaError_t e = prepare(&d);
    if (e != cudaSuccess) return e;
    int g = blocks > 0 ? blocks : (d->sms < p.h ? d->sms : p.h);
    size_t smem = 0;
    if (!plan(p, g, d->optin, &smem)) return cudaErrorInvalidValue;
    if (blocks <= 0) {
        // As many blocks as can be co-resident, at most one a row.
        int occ = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, suppress_kernel, kThreads, smem);
        if (e != cudaSuccess) return e;
        if (occ < 1) return cudaErrorInvalidConfiguration;
        const long long most = static_cast<long long>(occ) * d->sms;
        g = static_cast<int>(most < p.h ? most : p.h);
        if (!plan(p, g, d->optin, &smem)) return cudaErrorInvalidValue;
    }
    if (g > ctl_blocks) return cudaErrorInvalidValue;
    void* args[] = {&p};
    // A grid that cannot be co-resident is refused here
    // (cudaErrorCooperativeLaunchTooLarge), never run.
    e = cudaLaunchCooperativeKernel(suppress_kernel, dim3(g), dim3(kThreads),
                                    args, smem, stream);
    if (e == cudaSuccess) launched.fetch_add(1, std::memory_order_relaxed);
    // Also clears a refused launch's error, which would otherwise be
    // reported by this library's next launch.
    const cudaError_t last = cudaGetLastError();
    return e != cudaSuccess ? e : last;
}

}  // namespace

// q: (h, w) f32, the candidates' qualities (0 elsewhere); state: (h, w) u8,
// on return 2 or 3 where kept and 1 where undecided; hx: (2r + 1) int32,
// the disc's half-width in row dy + r (its offsets dx in [-hx, hx] but for
// (0, 0)), -1 where the row holds no neighbour;
// resume = 0: state is scratch and the init pass fills it; resume != 0:
// state is an earlier call's.  Outputs: rounds (int32), converged (u8),
// vals (k) f32, idx (k) int64 and count (int64), the kept list in
// row-major order (k >= 1).  ctl: 3 x ctl_blocks int32 scratch; spill:
// h x w int32 scratch.  blocks > 0 forces the grid (a grid that cannot be
// co-resident is refused), 0 sizes it from the occupancy.  Queues one
// cooperative launch on the stream; returns its CUDA error (0 on success).
extern "C" int gftt_suppress_launch(
    const void* q, void* state, const void* hx, int r, int h,
    int w, int max_rounds, int resume, int k, void* vals, void* idx,
    void* count, void* rounds, void* converged, void* ctl, int ctl_blocks,
    void* spill, int blocks, void* stream) {
    Params p = {};
    p.q = static_cast<const float*>(q);
    p.state = static_cast<unsigned char*>(state);
    p.hx = static_cast<const int*>(hx);
    p.vals = static_cast<float*>(vals);
    p.idx = static_cast<int64_t*>(idx);
    p.count = static_cast<int64_t*>(count);
    p.rounds = static_cast<int*>(rounds);
    p.converged = static_cast<unsigned char*>(converged);
    p.ctl = static_cast<int*>(ctl);
    p.spill = static_cast<int*>(spill);
    p.h = h;
    p.w = w;
    p.r = r;
    p.max_rounds = max_rounds;
    p.resume = resume;
    p.k = k;
    if (k < 1 || static_cast<long long>(h) * w >= kWonBit)
        return cudaErrorInvalidValue;
    return static_cast<int>(
        launch(p, blocks, ctl_blocks, static_cast<cudaStream_t>(stream)));
}

// The cooperative launches gftt_suppress_launch has queued in this process:
// counted here, where the runtime accepts them, apart from the wrapper's
// own count of its calls.
extern "C" long long gftt_suppress_cuda_launches() {
    return launched.load(std::memory_order_relaxed);
}
