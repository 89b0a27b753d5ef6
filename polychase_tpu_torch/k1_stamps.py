"""Where the time of one K1 solve goes, on a CUDA card.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 -m polychase_tpu_torch.k1_stamps

Copies ``csrc/pnp_lm.cu`` into ``build/k1_stamps/`` with ``clock64()``
stamps inserted at fixed lines (the kernel of the package carries none),
builds the copy and runs a few solves through ``kernels.pnp_lm.launch``.
Thread 0 of block 0 stamps the phases of each LM iteration: the pass over
the points, the warp reduce-scatter, the block sum and its push to the
blocks of the cluster, the cluster barrier, the sum of the pushed slots, the
serial step (its parts: the decision, the factor, the retraction, the
predicted gain, the state's store) and the barrier after it; and, once,
the staging of the points.  Prints SM cycles, the mean over the
iterations that proposed a step, beside the SM clock that ``nvidia-smi``
reads.  A stamp costs a few cycles, so the parts sum to a little more
than the kernel's own time.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from .engine.levmarq import BundleOptions
from .kernels import build, pnp_lm
from .synthetic import pnp_scene

OUT = build.BUILD_DIR.parent / "k1_stamps"
SLOTS = 512
# Slots: 8 per pass (0..255), 8 per serial step (256..511, from 256 on),
# and the once-per-solve stamps at the end.
_HEADER = """
__device__ long long g_stamps[%d];
__device__ int g_pass;
#define STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0 && pass < 31) \\
  g_stamps[pass * 8 + (k)] = clock64(); } while (0)
#define DSTAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_pass < 31) \\
  g_stamps[256 + g_pass * 8 + (k)] = clock64(); } while (0)
#define ONCE(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) \\
  g_stamps[248 + (k)] = clock64(); } while (0)
""" % SLOTS
_FOOTER = """
extern "C" int pnp_lm_stamps_clear() {
  static long long zeros[%d];
  return (int)cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros));
}
extern "C" int pnp_lm_stamps(long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * %d);
}
""" % (SLOTS, SLOTS)
# (anchor, text inserted after it); each anchor must occur once.
_AFTER = [
    ("const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
     "ONCE(0);"),
    ("  for (int pass = 0;; ++pass) {", "STAMP(0);"),
    ("      pass_streamed<NP, LOSS, THREADS>(gX, gx, gw, gm, cnt, P, o, v);",
     "STAMP(1);"),
    ("    warp_reduce_scatter<Sm::kPad>(v);", "STAMP(2);"),
    ("  State<NP> st = shared_st;", "DSTAMP(1);"),
    ("  st.trial_ok = chol_solve<NP>(A, b, st.lam, step);", "DSTAMP(3);"),
    ("  st.trial = t;", "DSTAMP(4);"),
    ("  st.expected = expected;", "DSTAMP(5);"),
]
# (anchor, text inserted before it).
_BEFORE = [
    ("  const float sign = p[14], aspect = p[11], mie = p[15];", "ONCE(1);"),
    ("      if (C > 1) {\n        cluster.sync();", "STAMP(3);"),
    ("        if (tid < Sm::kN) {\n          float acc = 0.0f;\n#pragma unroll\n"
     "          for (int r = 0; r < kMaxCluster; ++r)", "STAMP(4);"),
    ("    if (tid == 0) decide<NP>",
     "STAMP(5); if (blockIdx.x == 0 && tid == 0) g_pass = pass;"),
    ("    if (!sh.st.go) break;", "STAMP(7);"),
    ("  State<NP> st = shared_st;", "DSTAMP(0);"),
    ("  st.done = done;\n  st.go", "DSTAMP(2);"),
    ("  shared_st = st;\n}", "DSTAMP(6);"),
    ("  if (rank == 0 && tid == 0) {\n    const State<NP>& st", "ONCE(2);"),
]
PHASES = ("pass", "reduce-scatter", "block sum + push", "cluster barrier",
          "slot sum", "serial step", "barrier + loop")
STEP_PARTS = ("state", "decision", "factor", "retraction", "gain", "store")


def instrumented_source() -> str:
    src = (build.CSRC / "pnp_lm.cu").read_text()
    for anchor, text, after in ([(a, t, True) for a, t in _AFTER]
                                + [(a, t, False) for a, t in _BEFORE]):
        if src.count(anchor) != 1:
            raise RuntimeError(f"k1_stamps: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + "\n" + text if after
                          else text + "\n" + anchor)
    head = src.index("namespace {")
    return src[:head] + _HEADER + src[head:] + _FOOTER


def load():
    """Build the instrumented copy and load it in place of the package's
    kernel (``pnp_lm.load`` is swapped by :func:`main`)."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "pnp_lm.cu").write_text(instrumented_source())
    lib = pnp_lm.load(OUT)
    lib.lib.pnp_lm_stamps.argtypes = [ctypes.c_void_p]
    return lib


def stamp_table(lib, args, kw):
    """Runs one solve three times; returns the iterations, the once-per-
    solve cycles (entry to staged, staged to the first pass) and, per
    iteration that proposed a step, the cycles of each phase and of each
    part of the serial step."""
    for _ in range(3):
        if lib.lib.pnp_lm_stamps_clear() != 0:
            raise RuntimeError("k1_stamps: clearing the stamps failed")
        out = pnp_lm.launch(*args, **kw)
    buf = (ctypes.c_longlong * SLOTS)()
    rc = lib.lib.pnp_lm_stamps(buf)
    if rc != 0:
        raise RuntimeError(f"k1_stamps: CUDA error {rc}")
    a = np.array(buf, np.int64)
    iters = int(out[0, 11])
    once = a[248:251]
    phases, parts = [], []
    for p in range(min(iters, 30)):
        row, step = a[p * 8: p * 8 + 8], a[256 + p * 8: 256 + p * 8 + 8]
        nxt = a[(p + 1) * 8]
        # A phase the route skips (the cluster's on one block, the
        # block's on one warp) left its stamp at 0: it takes no time.
        marks = [row[0]]
        for k in (1, 2, 3, 4, 5, 7):
            marks.append(row[k] or marks[-1])
        marks.append(nxt)
        phases.append(np.diff(marks))
        parts.append(np.diff(step[:7]))
    return iters, (once[1] - once[0], a[0] - once[1]), phases, parts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_stamps: no CUDA device; this runs only on a GPU")
    from .backend import require_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    device = require_cuda()
    lib = load()
    saved = pnp_lm.load
    pnp_lm.load = lambda csrc=None: lib
    rng = np.random.default_rng(0)
    try:
        for label, n, opt, loss, noise, ftol in (
                ("N=8192, 6 params, Huber", 8192, False, 1, 0.4, 1e-5),
                ("N=16384, 6 params, Huber", 16384, False, 1, 0.4, 1e-5),
                ("N=16384, 9 params, Huber", 16384, True, 1, 0.4, 1e-5),
                ("N=8, 9 params, Trivial (a pin drag)", 8, True, 0, 3.0,
                 0.0),
                ("N=8, 6 params, Trivial", 8, False, 0, 3.0, 0.0)):
            scene = pnp_scene(rng, n, n_masked=n // 8, noise=noise,
                              f_err=0.95 if opt else 1.0)
            args = [torch.as_tensor(t[None], device=device) for t in scene]
            kw = dict(opt_f=opt, opt_pp=False,
                      opts=BundleOptions(max_iterations=50, loss_type=loss,
                                         function_tol=ftol))
            shape = pnp_lm.fitted_shape(1, n, 9 if opt else 6, loss)
            iters, once, phases, parts = stamp_table(lib, args, kw)
            print(f"{label}: {shape.cluster} x {shape.threads} threads, "
                  f"{shape.per_block} points a block; {iters} iterations; "
                  f"staging {once[0]} cycles, then {once[1]} to the first "
                  f"pass")
            ph = np.mean(phases, axis=0) if phases else np.zeros(7)
            pa = np.mean(parts, axis=0) if parts else np.zeros(6)
            print("  per iteration (cycles): " + ", ".join(
                f"{k} {v:.0f}" for k, v in zip(PHASES, ph))
                + f"; total {ph.sum():.0f}")
            print("  serial step: " + ", ".join(
                f"{k} {v:.0f}" for k, v in zip(STEP_PARTS, pa)))
    finally:
        pnp_lm.load = saved


if __name__ == "__main__":
    main()
