// K4: GFTT's greedy min-distance suppression on the card, as a fixed point.
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
// A byte of state per pixel (none, undecided, kept, won this round), the
// disc's offsets (without (0, 0)) read from a small device array.  A point
// that wins in a select pass is marked "won": its neighbours still count it
// as undecided in that pass, and the next reject pass turns it into "kept".
// Each select pass raises the next round's flag when a point stays
// undecided; every pass of a round whose flag is down returns at once, so
// the host queues all max_rounds rounds in one call and never reads the
// flag.  converged = the flag after the last round is down.  The state
// map is all a fixed point needs to go on: a call with resume set skips
// the init pass and runs max_rounds more rounds on the state an earlier
// call left (the greedy result does not depend on where the rounds were
// cut), so a frame whose chains outlast one call's rounds is finished on
// the card by the next call.  Every launch
// is one wave of kBlocks blocks whose threads stride over the frame, so a
// pass after the fixed point costs one wave that reads the flag, not a
// block for every 256 pixels.
//
// What bounds it on the card: launches.  The function moves the quality
// map in (4 bytes a pixel) and the kept map out (1 byte): 10.4 MB at
// 1920x1080, 3.1 µs at 3.35 TB/s, and its comparisons are a few per pixel.
// A round is two launches over the frame, where most pixels hold no
// candidate; the ~6 rounds of a 1080p frame are followed by ~120 empty
// ones.  Shared-memory tiles with a halo, and a persistent launch that
// runs the rounds with a grid barrier, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned char kNone = 0;
constexpr unsigned char kUndecided = 1;
constexpr unsigned char kKept = 2;
constexpr unsigned char kWon = 3;
constexpr int kThreads = 256;
// One wave on an H100: 132 SMs hold 8 blocks of 256 threads each.
constexpr int kBlocks = 512;

__device__ __forceinline__ uint64_t key_of(const float* q, int i) {
    return (static_cast<uint64_t>(__float_as_uint(q[i])) << 32) |
           static_cast<uint32_t>(i);
}

// Raises *flag when any thread of the block passed true.
__device__ __forceinline__ void block_any(bool mine, int* flag) {
    __shared__ int any;
    if (threadIdx.x == 0) any = 0;
    __syncthreads();
    if (mine) any = 1;
    __syncthreads();
    if (threadIdx.x == 0 && any) *flag = 1;
}

// state = undecided where q > 0, else none; flag[0] = any undecided.
__global__ void init_kernel(const float* __restrict__ q,
                            unsigned char* __restrict__ state, int n,
                            int* __restrict__ flag) {
    bool any = false;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += kBlocks * kThreads) {
        const bool und = q[i] > 0.0f;
        state[i] = und ? kUndecided : kNone;
        any |= und;
    }
    block_any(any, flag);
}

// Reject pass of a round: won -> kept; undecided with a kept (or won)
// neighbour -> none.  Only the thread's own pixels are written, and no
// pixel changes between kept and not kept here, so the neighbours' reads
// agree.
__global__ void reject_kernel(unsigned char* state,
                              const int2* __restrict__ off, int n_off, int h,
                              int w, const int* __restrict__ flag_in) {
    if (*flag_in == 0) return;
    const int n = h * w;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += kBlocks * kThreads) {
        const unsigned char s = state[i];
        if (s == kWon) {
            state[i] = kKept;
            continue;
        }
        if (s != kUndecided) continue;
        const int y = i / w;
        const int x = i - y * w;
        for (int k = 0; k < n_off; ++k) {
            const int2 o = off[k];  // (dy, dx)
            const int yy = y + o.x;
            const int xx = x + o.y;
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
            if (state[yy * w + xx] >= kKept) {
                state[i] = kNone;
                break;
            }
        }
    }
}

// Select pass of a round: an undecided pixel whose key beats every
// undecided (or won) neighbour's is won; flag_out is raised where one stays
// undecided.
__global__ void select_kernel(const float* __restrict__ q,
                              unsigned char* state,
                              const int2* __restrict__ off, int n_off, int h,
                              int w, const int* __restrict__ flag_in,
                              int* __restrict__ flag_out) {
    if (*flag_in == 0) return;  // the same for every thread of the block
    const int n = h * w;
    bool remains = false;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += kBlocks * kThreads) {
        if (state[i] != kUndecided) continue;
        const int y = i / w;
        const int x = i - y * w;
        const uint64_t key = key_of(q, i);
        bool best = true;
        for (int k = 0; k < n_off && best; ++k) {
            const int2 o = off[k];
            const int yy = y + o.x;
            const int xx = x + o.y;
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
            const int j = yy * w + xx;
            const unsigned char t = state[j];
            if ((t == kUndecided || t == kWon) && key_of(q, j) > key)
                best = false;
        }
        if (best)
            state[i] = kWon;
        else
            remains = true;
    }
    block_any(remains, flag_out);
}

}  // namespace

// q: (h, w) f32, the candidates' qualities (0 elsewhere); state: (h, w)
// u8, on return 2 or 3 where kept and 1 where undecided; flags:
// (max_rounds + 1) int32, zeroed by the caller, on return flags[r] = 1
// where round r ran and flags[max_rounds] = 1 where points stay
// undecided; off: (n_off, 2) int32 (dy, dx), the disc without (0, 0).
// resume = 0: state is scratch, the init pass fills it and flags[0];
// resume != 0: state is an earlier call's, and the caller has set
// flags[0].  Queues (resume ? 0 : 1) + 2·max_rounds launches on the
// stream; returns the CUDA error of the launches (0 on success).
extern "C" int gftt_suppress_launch(const void* q, void* state, void* flags,
                                    const void* off, int n_off, int h, int w,
                                    int max_rounds, int resume,
                                    void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    unsigned char* st = static_cast<unsigned char*>(state);
    int* fl = static_cast<int*>(flags);
    const int2* of = static_cast<const int2*>(off);
    if (!resume) init_kernel<<<kBlocks, kThreads, 0, s>>>(qf, st, h * w, fl);
    for (int r = 0; r < max_rounds; ++r) {
        reject_kernel<<<kBlocks, kThreads, 0, s>>>(st, of, n_off, h, w,
                                                   fl + r);
        select_kernel<<<kBlocks, kThreads, 0, s>>>(qf, st, of, n_off, h, w,
                                                   fl + r, fl + r + 1);
    }
    return static_cast<int>(cudaGetLastError());
}
