#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (polychase_tpu_torch) on one GPU.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

1. Prints the torch and CUDA versions and the card's name and power limit.
2. Builds the three kernels with nvcc, one process per source, in
   parallel: K1 the whole-solve LM PnP (csrc/pnp_lm.cu), K2 the LK prep
   (csrc/lk_prep.cu), K3 the LK iteration (csrc/lk_iter.cu).
3. K1 phase: the kernel against its plain torch version on the card,
   over every loss × function_tol × (opt_f, opt_pp), points behind the
   camera, all points masked, N = 16384 and a batch of 8 solves, and over
   the launch shapes: N on each side of every step of
   ``pnp_lm.launch_shape`` (one warp, then clusters of 1 to 16 blocks), of
   a cluster's staged capacity, one N on the streamed route, 3- to 8-point
   pin solves with a free focal, and a batch of 8 with random masks, with
   the tolerances of tests/test_pnp_pallas.py.  Prints both times per solve
   at N = 8, 16,384 (6 and 9 parameters) and for the batches, with each
   launch shape, the time per LM iteration, a measured floor (the same
   launch and iteration count with one point per block: the reduction and
   decision chain alone) and the kernel's bound; then the launch-shape
   sweep from which ``BLOCK_POINTS`` and ``WARP_MAX`` were set.
4. LK kernel phase: K2 and K3 against their plain torch versions at every
   level of one source frame of a 1920×1080 panning clip (config 1b's:
   blurred noise panning (7, 4) px per frame), with its real GFTT corners
   and its 8 skip targets, K3 at each of its group widths; prints per level
   both times per call, each kernel's bound and share of it, the
   iterations the pairs needed (counted by the plain version), the gate and
   status agreement and the largest differences.
5. Analyze phase: ``generate_optical_flow_database`` on 24 frames of that
   clip with default options, a warm-up run, a timed run and a run under
   ``torch.profiler``, each into a fresh DB.  Checks corners on every
   frame, every skip pair, the flows of skips ±1 and ±2 against the ground
   truth -s·(7, 4), the share of flows kept at ±1, and that K2 and K3
   launched once per level of every solve; prints analyze frames/s and the
   device busy share.
6. Tracking phase: a synthetic 1920×1080, f = 1800, 120-frame orbit clip
   over a 20,224-triangle sphere with 2048 keypoints per frame and 0.3 px
   flow noise, written to a flow DB, tracked through ``track_sequence``
   forward over 119 frames, backward over 60, and over 24 frames with free
   focal length and principal point.  Checks that every solve launched K1
   and that every pose lies within the ground-truth thresholds, and holds
   K1 against its plain version on solver inputs recorded from a warm-up
   run of the same path (N = 8192), timing the last one with its launch
   shape, time per LM iteration and floor.
7. Refine phase (config 4, ``benchmarks/run_all.py:348-398``): a 250-frame
   1920×1080, f = 1800 orbit clip over the 24×32 sphere (1,472 triangles)
   with 128 keypoints per frame and 0.3 px flow noise, refined on the card
   from translations with N(0, 0.005) noise by ``refine_trajectory`` with
   the focal length free, Cauchy loss and 30 iterations at most: a warm-up
   run, a timed run (gates: the cost falls, the anchors are untouched to the
   bit, the median translation error falls, every rotation error ≤ 2e-3
   rad) and a run under ``torch.profiler`` for the device time of the prim
   refresh ray cast, the normal equations, the solve and the cost, and the
   device busy share.  One normal system of the problem (P = 2250, nb = 32,
   bs = 72) is solved by the banded and the dense solve, timed, and the two
   steps held within 1e-3 of each other.
8. Pin phase (config 2, ``run_all.py:219-265``): 20 timed 8-pin Camera-type
   drags and one drag of 16,384 surface points; every drag above
   ``pinmode.HOST_PIN_MAX`` points must launch K1 once, the big drag must
   agree with the host route within 1e-4, and K1 is held against its plain
   version on the drags' solver inputs; then the table of host against
   device route times from which the pin crossover was set.
9. Prints the card, the kernels' JSON line (time, plain time, bound and
   what sets it, launches on the main path, largest difference) and, last,
   ``{"ok": true, ...}``.

Any failed check raises, so the script exits non-zero without the last line.
It refuses to run without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

# Pose errors against ground truth: the thresholds of tests/test_tracker.py.
ROT_ERR_MAX = 2e-3   # rad
T_ERR_MAX = 5e-3     # scene units (the sphere has radius 1)
INLIER_MIN = 0.99
# Free intrinsics (24-frame run): focal within 0.5%, principal point 6 px,
# and the translation judged after the intrinsics trade-off (see
# translation_err).
F_RTOL = 5e-3
PP_ATOL = 6.0

# Kernel vs plain version: tests/test_pnp_pallas.py's tolerances.
POSE_ATOL, POSE_ATOL_OPT = 5e-4, 1e-3
RATIO_ATOL, COST_RTOL = 1e-3, 1e-3
INTR_RTOL, INTR_ATOL = 2e-3, 1.0

# K2 and K3 against their plain versions (tests/test_torch_cuda.py's).
PATCH_ATOL, A_RTOL, GATE_AGREE = 1e-4, 1e-4, 0.999
STATUS_AGREE, POS_ATOL, POS_SHARE = 0.99, 0.05, 0.999
# Analyze against the ground truth of the panning clip.
FLOW_MEDIAN_MAX = 0.05   # px, skips ±1 and ±2
KEPT_MIN = 0.95          # share of corners whose ±1 flow is kept
PAN_STEP = (7, 4)        # px per frame, config 1b
PAN_FRAMES, PAN_SOURCE = 24, 8

N_POINTS = 16384
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1800.0
N_FRAMES, KEYPOINTS, NOISE_PX = 120, 2048, 0.3
SPHERE = (80, 128)  # 20,224 triangles

# Refine, config 4.
REFINE_FRAMES, REFINE_KEYPOINTS = 250, 128
REFINE_SPHERE = (24, 32)  # 1,472 triangles
REFINE_ITERS, REFINE_T_SIGMA = 30, 0.005
BAND_REL_MAX = 1e-3       # banded vs dense step, relative to the largest
REFINE_LABELS = ("refine.raycast", "refine.normal_equations", "refine.solve",
                 "refine.cost", "refine.step")
# Pin mode, config 2.
PIN_REPS, PIN_BIG, PIN_ROUTE_ATOL = 20, 16384, 1e-4


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------


def kernel_cases(rng, n):
    from polychase_tpu_torch.engine.levmarq import BundleOptions
    from polychase_tpu_torch.synthetic import pnp_scene

    cases = []
    for loss in (0, 1, 2):
        for ftol in (0.0, 1e-5):
            for opt_f, opt_pp in ((False, False), (True, False),
                                  (False, True), (True, True)):
                scene = pnp_scene(
                    rng, n, n_masked=n // 8,
                    f_err=0.875 if opt_f else 1.0,
                    pp_err=(8.0, -6.0) if opt_pp else (0.0, 0.0),
                )
                opts = BundleOptions(max_iterations=50, loss_type=loss,
                                     function_tol=ftol)
                name = f"loss{loss}_ftol{ftol:g}_f{int(opt_f)}_pp{int(opt_pp)}"
                cases.append((name, [scene], opt_f, opt_pp, opts))
    cauchy = BundleOptions(max_iterations=30, loss_type=2, function_tol=1e-5)
    cases.append(("behind_cauchy",
                  [pnp_scene(rng, n, opencv=False, behind=400, n_masked=50)],
                  False, False, cauchy))
    cases.append(("behind_trivial_overflow",
                  [pnp_scene(rng, n, opencv=False, behind=300)],
                  False, False, BundleOptions(max_iterations=10, loss_type=0)))
    masked = pnp_scene(rng, n)
    masked[2][:] = 0.0
    masked[3][:] = False
    cases.append(("all_masked", [masked], False, False,
                  BundleOptions(max_iterations=10, loss_type=1)))
    huber = BundleOptions(max_iterations=30, loss_type=1, function_tol=1e-5)
    cases.append(("batch8",
                  [pnp_scene(rng, n, n_masked=17 * s) for s in range(8)],
                  False, False, huber))
    return cases


def shape_cases(rng):
    """K1's launch-shape cases: N on each side of every step of
    ``launch_shape`` (one warp to one block, each doubling of the cluster,
    the largest cluster's staged capacity), one N on the streamed route,
    3- to 8-point pin solves with a free focal (Trivial loss, as pin mode
    solves them), and a batch of 8 with random masks at the main path's
    N."""
    from polychase_tpu_torch.engine.levmarq import BundleOptions
    from polychase_tpu_torch.kernels import pnp_lm
    from polychase_tpu_torch.synthetic import pnp_scene

    huber = BundleOptions(max_iterations=50, loss_type=1, function_tol=1e-5)
    steps = [pnp_lm.WARP_MAX]
    c = 1
    while c < pnp_lm.MAX_CLUSTER:
        steps.append(pnp_lm.BLOCK_POINTS * c)
        c *= 2
    steps.append(pnp_lm.MAX_CLUSTER * pnp_lm.STAGE_MAX)
    cases = []
    for b in steps:
        for n in (b, b + 1):
            cases.append((f"shape_n{n}", [pnp_scene(rng, n, n_masked=n // 8)],
                          False, False, huber))
    cases.append(("streamed_n200000",
                  [pnp_scene(rng, 200_000, n_masked=1000)], False, False,
                  huber))
    # A few points with a free focal leave a flat focal-depth valley, where
    # rounding moves the LM's exit point, in the two reference solvers (the
    # JAX package's and the plain torch one) as in the kernel: the points
    # are spread twice as wide as the other cases', with 1 px of mismatch.
    pins = np.random.default_rng(7)
    for n in range(3, 9):
        cases.append((f"pin{n}", [pnp_scene(pins, n, f_err=0.95, noise=1.0,
                                            spread=2.0)],
                      True, False, BundleOptions(loss_type=0)))
    batch = []
    for _ in range(8):
        scene = pnp_scene(rng, 8192)
        scene[3][:] = rng.random(8192) > rng.uniform(0.05, 0.5)
        scene[2][:] = scene[3]
        batch.append(scene)
    cases.append(("batch8_random_masks", batch, False, False, huber))
    return cases


def to_device(scenes, device):
    return [torch.as_tensor(np.stack([s[i] for s in scenes]), device=device)
            for i in range(5)]


def compare(name, got, ref, params, opt):
    """Raise-free check of one case; returns (max |Δpose|, failures)."""
    fails = []
    dpose = float(np.abs(got[:, :7] - ref[:, :7]).max())
    atol = POSE_ATOL_OPT if opt else POSE_ATOL
    if name == "all_masked":
        atol = 1e-5
        if not (np.all(np.isfinite(got[:, :11])) and np.all(got[:, 18] == 0)):
            fails.append(f"{name}: non-finite result or nonzero inlier ratio")
    if name == "behind_trivial_overflow":
        if not (np.isinf(got[:, 12]).all() and np.isinf(ref[:, 12]).all()):
            fails.append(f"{name}: initial cost did not overflow to inf")
        if not np.array_equal(got[:, :7], params[:, :7]):
            fails.append(f"{name}: pose moved though every step was inf")
    # Three points: the intrinsics stay frozen and the pose fits them
    # exactly, so the cost is rounding noise and is not compared (as
    # tests/test_pnp_pallas.py::test_intrinsics_gate_3_points).
    exact_fit = name == "pin3"
    if exact_fit and not np.array_equal(got[:, 7:11], params[:, 7:11]):
        fails.append(f"{name}: intrinsics moved with 3 points")
    if dpose > atol:
        fails.append(f"{name}: pose differs by {dpose:.3g} > {atol}")
    dratio = float(np.abs(got[:, 18] - ref[:, 18]).max())
    if dratio > RATIO_ATOL:
        fails.append(f"{name}: inlier ratio differs by {dratio:.3g}")
    if not exact_fit and not np.allclose(got[:, 13], ref[:, 13],
                                         rtol=COST_RTOL, atol=0.0):
        fails.append(f"{name}: cost {got[:, 13]} vs plain {ref[:, 13]}")
    if opt and not np.allclose(got[:, 7:11], ref[:, 7:11], rtol=INTR_RTOL,
                               atol=INTR_ATOL):
        fails.append(f"{name}: intrinsics {got[:, 7:11]} vs {ref[:, 7:11]}")
    return dpose, fails


# Cycles the device sleeps before a timed run (20 ms at the H100's 1980 MHz
# at most): the run's launches queue behind it, so the events time the
# device's work, not the host's issue rate (K1 takes less time than its
# wrapper's host side, ~40 us a call, and a run issues up to 100 calls).
SLEEP_CYCLES = 40_000_000


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_shape(args, kw):
    """The launch shape K1 takes for these inputs on this card."""
    from polychase_tpu_torch.kernels import pnp_lm

    S, N = args[0].shape[:2]
    return pnp_lm.fitted_shape(S, N, 9 if (kw["opt_f"] or kw["opt_pp"]) else 6,
                               int(kw["opts"].loss_type))


def k1_floor(args, kw, iterations):
    """A measured floor of one solve, not a bound: K1 at the launch shape
    of these inputs, run for the same number of LM iterations with one
    point per block (the first valid points of the first solve) and every
    exit but max_iterations off, so that its time is the launch, the
    staging and the reduction and decision chain alone.  Returns (ms per
    solve, iterations run, ms at no iteration: the launch and one pass)."""
    from dataclasses import replace

    from polychase_tpu_torch.kernels import pnp_lm

    X, x, w, m, p = args
    shape = k1_shape(args, kw)
    idx = torch.nonzero(m[0])[: shape.cluster, 0]
    sub = [t[:1, idx].contiguous() for t in (X, x, w, m)] + [p[:1]]
    ms, runs = [], []
    for its in (iterations, 0):
        fkw = dict(opt_f=kw["opt_f"], opt_pp=kw["opt_pp"],
                   opts=replace(kw["opts"], max_iterations=its,
                                gradient_tol=0.0, step_tol=0.0,
                                function_tol=0.0, max_lambda=float("inf")),
                   shape=shape._replace(per_block=1, staged=True))
        runs.append(int(pnp_lm.launch(*sub, **fkw)[0, 11]))
        ms.append(event_ms(lambda: pnp_lm.launch(*sub, **fkw), 20))
    return ms[0], runs[0], ms[1]


def k1_report(label, args, kw, got, plain_reps):
    """Times K1 and its plain version on these inputs and prints the launch
    shape, the time per LM iteration and the floor; returns (kernel ms,
    plain ms, ms per iteration, floor ms)."""
    from polychase_tpu_torch.engine.pnp import solve_arrays
    from polychase_tpu_torch.kernels.pnp_lm import solve_arrays_lm

    k = event_ms(lambda: solve_arrays_lm(*args, **kw), 20)
    p = event_ms(lambda: solve_arrays(*args, **kw), plain_reps)
    shape = k1_shape(args, kw)
    iters = int(got[:, 11].max())
    floor, floor_iters, fixed = k1_floor(args, kw, iters)
    per_iter = k / max(iters, 1)
    print(f"  {label}: kernel {k:.4f} ms, plain {p:.4f} ms per solve; "
          f"shape {shape.cluster} x {shape.threads} threads, "
          f"{shape.per_block} points a block, "
          f"{'staged' if shape.staged else 'streamed'}; {iters} iterations, "
          f"{per_iter * 1e3:.2f} us each; floor {floor:.4f} ms "
          f"({floor_iters} iterations, one point a block: {fixed:.4f} ms "
          f"fixed + {(floor - fixed) / max(floor_iters, 1) * 1e3:.2f} us an "
          f"iteration), {floor / k:.3f} of the solve")
    return k, p, per_iter, floor


# The cases k1_report times: the 8-point pin solve, the two 16,384-point
# Huber solves (6 and 9 parameters) and the two batches of 8.
K1_TIMED = ("pin8", "loss1_ftol1e-05_f0_pp0", "loss1_ftol1e-05_f1_pp1",
            "batch8", "batch8_random_masks")


def kernel_phase(device, n=N_POINTS, seed=0):
    from polychase_tpu_torch.engine.pnp import solve_arrays
    from polychase_tpu_torch.kernels.pnp_lm import solve_arrays_lm

    rng = np.random.default_rng(seed)
    max_err, fails, times = 0.0, [], {}
    for name, scenes, opt_f, opt_pp, opts in (kernel_cases(rng, n)
                                              + shape_cases(rng)):
        args = to_device(scenes, device)
        kw = dict(opt_f=opt_f, opt_pp=opt_pp, opts=opts)
        got = solve_arrays_lm(*args, **kw).cpu().numpy()
        ref = solve_arrays(*args, **kw).cpu().numpy()
        dpose, f = compare(name, got, ref, np.stack([s[4] for s in scenes]),
                           opt_f or opt_pp)
        max_err = max(max_err, dpose)
        fails += f
        sh = k1_shape(args, kw)
        print(f"  {name:28s} iters kernel {got[:, 11].astype(int).tolist()} "
              f"plain {ref[:, 11].astype(int).tolist()} |dpose| {dpose:.3g} "
              f"[{sh.cluster}x{sh.threads}, {sh.per_block}"
              f"{'' if sh.staged else ' streamed'}]{'  FAIL' if f else ''}")
        if name in K1_TIMED:
            N = args[0].shape[1]
            times[name] = k1_report(
                f"{name} (S={len(scenes)}, N={N})", args, kw, got,
                3 if N > 1000 else 5)
            if name.startswith("loss1"):
                times[name] += (k1_bound(n, 9 if opt_f else 6,
                                         int(got[0, 11])),)
    torch.cuda.synchronize()
    if fails:
        raise AssertionError("kernel vs plain:\n" + "\n".join(fails))
    for name in K1_TIMED[1:3]:
        k, _, _, _, b = times[name]
        print(f"  {name}: bound {b[0]:.6f} ms by {b[1]}, {b[0] / k:.4f} of "
              f"the kernel's time")
    return max_err, times


def k1_shape_sweep(device, seed=3):
    """The table from which ``pnp_lm.BLOCK_POINTS`` and ``WARP_MAX`` were
    set: K1's device ms per solve of a 6-parameter Huber, ftol 1e-5 solve
    at N = 4096 to 32768 on clusters of 1 to 16 blocks, and the chosen
    shape with its slices streamed from L2; then, at small N, one warp
    against one block of 256 threads."""
    from polychase_tpu_torch.engine.levmarq import BundleOptions
    from polychase_tpu_torch.engine.pnp import solve_arrays
    from polychase_tpu_torch.kernels import pnp_lm
    from polychase_tpu_torch.synthetic import pnp_scene

    LS = pnp_lm.LaunchShape
    rng = np.random.default_rng(seed)
    kw = dict(opt_f=False, opt_pp=False,
              opts=BundleOptions(max_iterations=50, loss_type=1,
                                 function_tol=1e-5))
    fails = []

    def timed(args, ref, shape, reps=20):
        got = pnp_lm.launch(*args, shape=shape, **kw)
        _, f = compare(f"sweep {shape}", got.cpu().numpy(), ref,
                       None, False)
        fails.extend(f)
        return got, event_ms(lambda: pnp_lm.launch(*args, shape=shape, **kw),
                             reps)

    for n in (4096, 8192, 16384, 32768):
        args = to_device([pnp_scene(rng, n, n_masked=n // 8)], device)
        ref = solve_arrays(*args, **kw).cpu().numpy()
        print(f"  N={n} (ms per solve):")
        c = 1
        while c <= pnp_lm.MAX_CLUSTER:
            per = -(-n // c)
            shape = LS(c, pnp_lm.BLOCK_THREADS, per, per <= pnp_lm.STAGE_MAX)
            if pnp_lm.cluster_fits(6, 1, shape) < c:
                print(f"    cluster {c:2d}: not schedulable")
            else:
                got, ms = timed(args, ref, shape)
                print(f"    cluster {c:2d} x {per:5d} points"
                      f"{'' if shape.staged else ' (streamed)'}: "
                      f"{ms:.4f}; {int(got[0, 11])} iterations")
            c *= 2
        chosen = k1_shape(args, kw)
        _, ms = timed(args, ref, chosen._replace(staged=False))
        print(f"    chosen {chosen.cluster} x {chosen.per_block} streamed "
              f"from L2 instead of staged: {ms:.4f}")
    print("  small N (ms per solve; one warp / one block of 256 threads):")
    for n in (16, 32, 64, 128, 256, 512):
        args = to_device([pnp_scene(rng, n)], device)
        ref = solve_arrays(*args, **kw).cpu().numpy()
        got, ms_w = timed(args, ref, LS(1, pnp_lm.WARP_THREADS, n, True),
                          reps=100)
        _, ms_b = timed(args, ref, LS(1, pnp_lm.BLOCK_THREADS, n, True),
                        reps=100)
        print(f"    N={n:4d}: {ms_w:.4f} / {ms_b:.4f}; "
              f"{int(got[0, 11])} iterations")
    torch.cuda.synchronize()
    if fails:
        raise AssertionError("K1 shape sweep:\n" + "\n".join(fails))


# ---------------------------------------------------------------------------
# LK kernel phase (K2, K3) and analyze phase
# ---------------------------------------------------------------------------


# The card's peaks for a kernel's bound (NVIDIA's data sheet, H100 SXM, at
# the 700 W limit): device memory bytes/s and f32 operations/s outside the
# tensor cores.
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# f32 operations of the LK kernels: per window pixel of one K2 feature, the
# blend of three planes (3 × 7) and the three A products (3 × 2); per
# window pixel of one K3 iteration, the blend (7), diff (2) and two FMAs
# (4); per pixel of the level-0 err pass, the blend, |J - I| and the sum.
K2_OPS_PIXEL, K3_OPS_PIXEL, K3_ERR_OPS_PIXEL = 27, 13, 10
# K1: f32 operations per point and LM iteration, counted from csrc/pnp_lm.cu
# (a trial-cost pass, ~40, and a normal-equation pass: projection and
# Jacobian ~85 and the 27 JtJ/Jtr sums × 5, ~135, with 6 parameters; the
# 54 sums of 9 parameters make it ~390).
K1_OPS_POINT_ITER = {6: 260, 9: 390}


def bound_ms(nbytes: float, ops: float):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the f32 rate, and which one."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(n, n_params, iterations):
    """K1 on one solve of n points: each input read once (X, x, weight,
    mask, 16 params), the 19-float row written once; iterations + 1 passes
    of the per-point work."""
    nbytes = n * (12 + 8 + 4 + 1) + 16 * 4 + 19 * 4
    return bound_ms(nbytes, (iterations + 1) * n * K1_OPS_POINT_ITER[n_params])


def k2_bound(n, hp, wp, win):
    """K2 at one level: the three padded planes read, the points read, the
    (n, 3, win, win) patches, the four vectors and ok written."""
    nbytes = 3 * hp * wp * 4 + n * 8 + n * 3 * win * win * 4 + n * 17
    return bound_ms(nbytes, n * win * win * K2_OPS_PIXEL)


def k3_bound(T, n, hp, wp, win, iterations, level_is_zero):
    """K3 at one level: templates, the T padded target levels, the four
    vectors, ok and the guesses read; points, status and err written; the
    window sums these inputs need (``iterations`` summed over the pairs)
    and, at level 0, one err pass per pair."""
    nbytes = (n * 3 * win * win * 4 + T * hp * wp * 4 + n * 17 + T * n * 8
              + T * n * 13)
    ops = iterations * win * win * K3_OPS_PIXEL
    if level_is_zero:
        ops += T * n * win * win * K3_ERR_OPS_PIXEL
    return bound_ms(nbytes, ops)


def lk_kernel_phase(device, frames):
    """K2 and K3 against their plain versions at every level of one source
    frame and its 8 targets.  K3 gets the plain prep and, at each level, the
    guesses of the kernel chain.  Prints per level both kernels' times,
    bounds and shares of the bound and the iterations the pairs needed.
    Returns the largest patch difference, the largest level-0 position
    difference, the level-0 times (kernel, plain) of K2 and K3 and their
    level-0 bounds (ms, kind)."""
    from polychase_tpu_torch.engine import lk
    from polychase_tpu_torch.engine.gftt import good_features_to_track
    from polychase_tpu_torch.engine.opticalflow import IMAGE_SKIPS
    from polychase_tpu_torch.kernels.lk_iter import lk_iter_level
    from polychase_tpu_torch.kernels.lk_prep import lk_prep_level

    opts = lk.LKOptions()
    win = opts.window_size
    pts, _ = good_features_to_track(frames[PAN_SOURCE], device=device)
    pts, _ = lk._spatial_sort(pts)
    pts = torch.as_tensor(pts, device=device)
    src = lk.prepare_pyramid(frames[PAN_SOURCE], opts, device=device)
    tgts = [lk.prepare_pyramid(frames[PAN_SOURCE + s], opts, device=device)
            for s in IMAGE_SKIPS]
    levels, T, n = src.num_levels, len(tgts), pts.shape[0]
    print(f"  source frame {PAN_SOURCE}: {n} corners, {T} targets, "
          f"{levels} levels")
    eps2 = float(opts.term_epsilon ** 2)
    top = levels - 1
    cur = (pts * (1.0 / (1 << top))).expand(T, n, 2).contiguous()
    fails, patch_err, pos_err, times, bounds = [], 0.0, 0.0, {}, {}
    for lvl in range(top, -1, -1):
        if lvl != top:
            cur = cur * 2.0
        img, dx, dy, (H, W) = src.levels[lvl]
        hp, wp = img.shape
        p = pts * (1.0 / (1 << lvl))
        kw = dict(win=win, H=H, W=W, min_eig_thr=opts.min_eigen_threshold)
        got = lk_prep_level(img, dx, dy, p, **kw)
        ref = lk.prep_level(img, dx, dy, p, **kw)
        dp = float((got[0] - ref[0]).abs().max())
        da = max(float(((a - b).abs() / b.abs().max()).max())
                 for a, b in zip(got[1:4], ref[1:4]))
        gate = float((got[5] == ref[5]).float().mean())
        patch_err = max(patch_err, dp)
        if dp > PATCH_ATOL or da > A_RTOL or gate < GATE_AGREE:
            fails.append(f"K2 level {lvl}: |dpatch| {dp:.3g}, A rel {da:.3g},"
                         f" gate agreement {gate:.5f}")
        t_k2 = (event_ms(lambda: lk_prep_level(img, dx, dy, p, **kw), 20),
                event_ms(lambda: lk.prep_level(img, dx, dy, p, **kw), 5))

        imgs = torch.stack([t.levels[lvl][0] for t in tgts])
        ikw = dict(win=win, H=H, W=W, max_iters=opts.term_max_iters,
                   eps2=eps2, level_is_zero=(lvl == 0))
        *pout, iters = lk.iter_level_counted(imgs, *ref, cur, **ikw)
        n_iters = int(iters.sum())
        # A feature that does not converge within the iteration budget (near
        # the border of a coarse level, or a pan beyond LK's basin) stops
        # wherever the budget ends, and there last-bit differences (sum
        # order, FMAs) move it: every level is held in share, and the
        # level-0 output at skips ±1 and ±2, where the clip's flows lie in
        # the basin, in full.
        near = torch.tensor([abs(s) <= 2 for s in IMAGE_SKIPS],
                            device=device)[:, None].expand(T, n)
        kout = lk_iter_level(imgs, *ref, cur, **ikw)
        agree = float((kout[1] == pout[1]).float().mean())
        both = kout[1] & pout[1] & ref[5]
        dpos = (kout[0] - pout[0]).abs().amax(dim=-1)[both]
        d_max = float(dpos.max())
        d_near = float(dpos[near[both]].max())
        share = float((dpos <= POS_ATOL).float().mean())
        if (agree < STATUS_AGREE or share < POS_SHARE
                or (lvl == 0 and d_near > POS_ATOL)):
            fails.append(f"K3 level {lvl}: status agreement {agree:.5f}, "
                         f"share within {POS_ATOL} px {share:.5f}, max "
                         f"|dpos| at ±1/±2 {d_near:.3g}")
        if lvl == 0:
            pos_err = d_max
        t_k3 = (event_ms(lambda: lk_iter_level(imgs, *ref, cur, **ikw), 10),
                event_ms(lambda: lk.iter_level(imgs, *ref, cur, **ikw), 3))
        b2 = k2_bound(n, hp, wp, win)
        b3 = k3_bound(T, n, hp, wp, win, n_iters, lvl == 0)
        times[lvl], bounds[lvl] = (t_k2, t_k3), (b2, b3)
        print(f"  level {lvl} ({W}x{H}): K2 {t_k2[0]:.4f} ms (plain "
              f"{t_k2[1]:.4f}; bound {b2[0]:.4f} by {b2[1]}, "
              f"{b2[0] / t_k2[0]:.3f} of it), |dpatch| {dp:.3g}, A rel "
              f"{da:.3g}, gate agreement {gate:.5f}")
        print(f"    K3 {t_k3[0]:.4f} ms (plain {t_k3[1]:.4f}; bound "
              f"{b3[0]:.4f} by {b3[1]}, {b3[0] / t_k3[0]:.3f} of it; "
              f"{n_iters} iterations over {T * n} pairs, "
              f"{n_iters / (T * n):.2f} a pair)")
        print(f"    K3 status agreement {agree:.5f}, |dpos| within "
              f"{POS_ATOL} px {share:.6f}, max {d_max:.3g} (at ±1/±2 "
              f"{d_near:.3g}), kept {float(kout[1].float().mean()):.4f}")
        cur = kout[0]
    torch.cuda.synchronize()
    if fails:
        raise AssertionError("LK kernels vs plain:\n" + "\n".join(fails))
    k2 = tuple(sum(t[0][i] for t in times.values()) for i in (0, 1))
    k3 = tuple(sum(t[1][i] for t in times.values()) for i in (0, 1))
    kb = tuple(sum(b[i][0] for b in bounds.values()) for i in (0, 1))
    print(f"  one source frame, all levels: K2 {k2[0]:.4f} ms (plain "
          f"{k2[1]:.4f}, bound {kb[0]:.4f}), K3 {k3[0]:.4f} ms (plain "
          f"{k3[1]:.4f}, bound {kb[1]:.4f}); LK kernels {k2[0] + k3[0]:.4f}"
          f" ms")
    return patch_err, pos_err, times[0], bounds[0]


def analyze_phase(device, frames):
    """Analyze the panning clip twice (warm-up, timed), each into a fresh
    DB, and check the timed run against the ground truth; a third run under
    ``torch.profiler`` gives the device busy share.  Returns the K2 and K3
    launch counts of the timed run and its frames/s."""
    from polychase_tpu_torch.io.database import Database
    from polychase_tpu_torch.engine import lk
    from polychase_tpu_torch.engine.opticalflow import (
        IMAGE_SKIPS, VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.kernels import lk_iter, lk_prep

    n = len(frames)
    height, width = frames[0].shape
    info = VideoInfo(width, height, 0, n)

    def run(path):
        t0 = time.perf_counter()
        generate_optical_flow_database(info, lambda f: frames[f], None, path,
                                       device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as td:
        warm = run(os.path.join(td, "warm.db"))
        lk_prep.launches = lk_iter.launches = 0
        path = os.path.join(td, "flow.db")
        seconds = run(path)
        launches = (lk_prep.launches, lk_iter.launches)
        pwall, _, busy_ms, busy = profile_split(
            lambda: run(os.path.join(td, "profiled.db")), device, ())
        db = Database(path)
        try:
            kps = [db.read_keypoints(f) for f in range(n)]
            flows = {(f, f + s): db.read_image_pair_flow(f, f + s)
                     for f in range(n) for s in IMAGE_SKIPS
                     if 0 <= f + s < n and db.image_pair_flow_exists(f, f + s)}
        finally:
            db.close()
    fails = []
    counts = [k.shape[0] for k in kps]
    print(f"  clip: {width}x{height}, {n} frames, pan {PAN_STEP} px/frame; "
          f"corners per frame {min(counts)}..{max(counts)}")
    if min(counts) == 0:
        fails.append("a frame has no corners")
    want = {(f, f + s) for f in range(n) for s in IMAGE_SKIPS
            if 0 <= f + s < n}
    if set(flows) != want:
        fails.append(f"{len(want - set(flows))} skip pairs missing")
    for s in IMAGE_SKIPS:
        errs, kept, total = [], 0, 0
        for f in range(n):
            fl = flows.get((f, f + s))
            if fl is None:
                continue
            d = fl.tgt_kps - kps[f][fl.src_kps_indices]
            errs.append(np.linalg.norm(d + s * np.array(PAN_STEP), axis=1))
            kept += fl.src_kps_indices.size
            total += kps[f].shape[0]
        e = np.concatenate(errs)
        med, share = float(np.median(e)), kept / max(total, 1)
        checked = abs(s) <= 2
        print(f"  skip {s:+d}: kept {share:.4f}, median |flow - truth| "
              f"{med:.4g} px, within 0.1 px {float((e < 0.1).mean()):.4f}"
              f"{'' if checked else '  (beyond the LK basin, not checked)'}")
        if checked and med > FLOW_MEDIAN_MAX:
            fails.append(f"skip {s}: median flow error {med:.3g} px")
        if abs(s) == 1 and share < KEPT_MIN:
            fails.append(f"skip {s}: only {share:.4f} of the flows kept")
    levels = lk.num_pyramid_levels(height, width, lk.LKOptions())
    solves = sum(1 for f in range(n) if any((f, f + s) in want
                                            for s in IMAGE_SKIPS))
    if launches != (levels * solves, levels * solves):
        fails.append(f"K2/K3 launched {launches} times for {solves} solves "
                     f"of {levels} levels")
    if not busy_ms > 0.0:
        fails.append("the profiler saw no work on the device")
    if fails:
        raise AssertionError("analyze:\n" + "\n".join(fails))
    fps = n / seconds
    print(f"  K2 / K3 launches on the main path: {launches[0]} / "
          f"{launches[1]} (= {solves} solves x {levels} levels)")
    print(f"  analyze: {n} frames in {seconds:.3f} s = {fps:.2f} frames/s "
          f"(warm-up run {warm:.3f} s); profiled run {pwall:.4f} s, device "
          f"time {busy_ms:.3f} ms, busy share {busy:.4f}")
    return launches, fps


# ---------------------------------------------------------------------------
# Tracking phase
# ---------------------------------------------------------------------------


def quat_err(qa, qb) -> float:
    """Rotation angle between two unit quaternions, in float64."""
    qa = np.asarray(qa, np.float64) / np.linalg.norm(qa)
    qb = np.asarray(qb, np.float64) / np.linalg.norm(qb)
    return 2.0 * float(np.arccos(min(abs(float(np.dot(qa, qb))), 1.0)))


def translation_err(r, t_gt, free_intrinsics: bool) -> float:
    """Distance of a tracked translation from the truth.

    With a free focal length and principal point the clip pins down the
    image of the object, not depth and lateral position apart from them:
    depth trades with the focal (dt_z ≈ t_z·df/f) and lateral position with
    the principal point (dt_x ≈ t_z·dc_x/f).  For such a run the estimate is
    first carried to the true intrinsics, keeping the image of the object's
    centre and its scale: t_z' = t_z·f/f_est and t_xy' = (t_xy·f_est/t_z +
    c_est − c)·t_z'/f."""
    t = r.pose.t.numpy().astype(np.float64)
    if free_intrinsics:
        fe = float(r.intrinsics.fy)
        c_est = np.array([float(r.intrinsics.cx), float(r.intrinsics.cy)])
        c = np.array([WIDTH / 2, HEIGHT / 2])
        tz = t[2] * FOCAL / fe
        t = np.array([*((t[:2] * fe / t[2] + c_est - c) * tz / FOCAL), tz])
    return float(np.linalg.norm(t - np.asarray(t_gt, np.float64)))


def main_path_inputs_check(inputs):
    """K1 against its plain version on recorded main-path solver inputs;
    returns the largest pose difference."""
    from polychase_tpu_torch.engine.pnp import solve_arrays
    from polychase_tpu_torch.kernels.pnp_lm import solve_arrays_lm

    max_err, fails = 0.0, []
    for i, (args, kw) in enumerate(inputs):
        got = solve_arrays_lm(*args, **kw).cpu().numpy()
        ref = solve_arrays(*args, **kw).cpu().numpy()
        opt = kw["opt_f"] or kw["opt_pp"]
        dpose, f = compare(f"main-path solve {i}", got, ref, None, opt)
        max_err = max(max_err, dpose)
        fails += f
    if fails or not inputs:
        raise AssertionError("main-path inputs:\n" + "\n".join(fails))
    print(f"  K1 vs plain on {len(inputs)} recorded main-path solves: max "
          f"|dpose| {max_err:.3g}")
    args, kw = inputs[-1]
    k1_report(f"the last one (S=1, N={int(args[0].shape[1])})", args, kw,
              got, 3)
    return max_err


def main_path_phase(device, *, n_frames=N_FRAMES, keypoints=KEYPOINTS,
                    sphere=SPHERE, seed=1):
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import (
        Mesh, SceneTransformations,
    )
    from polychase_tpu_torch.engine.levmarq import BundleOptions
    from polychase_tpu_torch.engine.pose import quat_to_mat_np
    from polychase_tpu_torch.engine import tracker
    from polychase_tpu_torch.kernels import pnp_lm
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, uv_sphere,
    )

    rng = np.random.default_rng(seed)
    verts, tris = uv_sphere(*sphere)
    mesh = Mesh.create(verts, tris, device=device)
    intr = Intrinsics.create(FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0, WIDTH,
                             HEIGHT, OPENCV, device=device)
    poses = orbit_poses(n_frames)
    print(f"  clip: {WIDTH}x{HEIGHT}, f={FOCAL:g}, {n_frames} frames, "
          f"{len(tris)} triangles, {keypoints} keypoints/frame, "
          f"{NOISE_PX} px noise")

    def run(db_path, start, end, opt=False):
        q, t = poses[start]
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = quat_to_mat_np(q)
        view[:3, 3] = t
        scene = SceneTransformations(
            model_matrix=torch.eye(4, device=device),
            view_matrix=torch.as_tensor(view, device=device),
            intrinsics=intr,
        )
        results = []
        t0 = time.perf_counter()
        tracker.track_sequence(
            db_path, start, end, scene, mesh,
            callback=lambda r: results.append(r) or True,
            optimize_focal_length=opt, optimize_principal_point=opt,
            bundle_opts=BundleOptions(), device=device,
        )
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0

    def check(label, results, expected, opt=False):
        if len(results) != expected:
            raise AssertionError(
                f"{label}: {len(results)} frames tracked, want {expected}")
        rot = max(quat_err(r.pose.q.numpy(), poses[r.frame][0])
                  for r in results)
        terr = max(translation_err(r, poses[r.frame][1], opt)
                   for r in results)
        inl = min(r.inlier_ratio for r in results)
        msg = (f"  {label}: {expected} frames, max rot err {rot:.3g} rad, "
               f"max t err {terr:.3g}, min inlier ratio {inl:.4f}")
        ok = rot <= ROT_ERR_MAX and terr <= T_ERR_MAX and inl >= INLIER_MIN
        if opt:
            raw = max(translation_err(r, poses[r.frame][1], False)
                      for r in results)
            f = np.array([float(r.intrinsics.fy) for r in results])
            pp = np.array([[float(r.intrinsics.cx) - WIDTH / 2,
                            float(r.intrinsics.cy) - HEIGHT / 2]
                           for r in results])
            df = float(np.abs(f / FOCAL - 1.0).max())
            dpp = float(np.abs(pp).max())
            msg += (f" (t err before the intrinsics trade-off {raw:.3g}), "
                    f"max focal err {df:.3g} (rel), max pp err {dpp:.3g} px")
            ok = ok and df <= F_RTOL and dpp <= PP_ATOL
        print(msg)
        if not ok:
            raise AssertionError(f"{label}: ground-truth check failed")

    with tempfile.TemporaryDirectory() as td:
        db_path = os.path.join(td, "flow.db")
        t0 = time.perf_counter()
        build_flow_db(db_path, mesh, FOCAL, WIDTH, HEIGHT, poses, rng,
                      keypoints, NOISE_PX)
        print(f"  flow DB written in {time.perf_counter() - t0:.2f} s")
        # Warm-up (first launches, allocator), recording the solver's
        # inputs: K1 is then held against its plain version on the very
        # tensors the main path hands it.
        inputs = []
        real = tracker.solve_arrays_lm

        def record(*args, **kw):
            inputs.append((args, kw))
            return real(*args, **kw)

        tracker.solve_arrays_lm = record
        try:
            run(db_path, 0, 8)
        finally:
            tracker.solve_arrays_lm = real
        path_err = main_path_inputs_check(inputs)

        pnp_lm.launches = 0
        fwd, fwd_s = run(db_path, 0, n_frames - 1)
        half = n_frames // 2
        bwd, _ = run(db_path, half, 0)
        seg = min(24, n_frames - 1)
        opt, _ = run(db_path, 0, seg, opt=True)
        launches = pnp_lm.launches

    solved = (n_frames - 1) + half + seg
    check("forward", fwd, n_frames - 1)
    check("backward", bwd, half)
    check("opt f+pp", opt, seg, opt=True)
    if launches != solved:
        raise AssertionError(
            f"K1 launched {launches} times for {solved} solved frames")
    fps = (n_frames - 1) / fwd_s
    print(f"  K1 launches on the main path: {launches} "
          f"(= {solved} frames solved)")
    print(f"  forward tracking: {n_frames - 1} frames in {fwd_s:.3f} s = "
          f"{fps:.2f} frames/s")
    return launches, fps, path_err


# ---------------------------------------------------------------------------
# Refine phase
# ---------------------------------------------------------------------------


def profile_split(fn, device, labels=REFINE_LABELS):
    """Run ``fn`` under ``torch.profiler``; returns the host-clock seconds,
    the device time of each of ``labels`` (ms), the device's busy time (ms)
    and the busy share.  A label's time is that of the kernels under the
    ops it encloses.  The busy time is the union of the intervals of every
    kernel, copy and fill the device ran, whether a torch op launched it or
    not (K1, K2 and K3 launch through ctypes, outside any op).  The spans
    the profiler draws on the device for ``record_function`` labels cover
    idle gaps: they carry their host-side range's name, which no kernel or
    copy shares, and are left out by it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    split = {lbl: sum(e.device_time_total for e in cpu if e.name == lbl) / 1e3
             for lbl in labels}
    host_names = {e.name for e in cpu}
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and e.name() not in host_names)
    busy_ns, end = 0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy_ns += hi - lo
            end = hi
        elif hi > end:
            busy_ns += hi - end
            end = hi
    return wall, split, busy_ns / 1e6, busy_ns / 1e9 / wall


def band_solve_check(device, db_path, traj, mesh):
    """One normal system of the problem at ``traj``, solved banded and
    dense: returns (nb, bs), both times (ms, CUDA events) and the relative
    difference of the two steps."""
    from polychase_tpu_torch.io.database import Database
    from polychase_tpu_torch.engine import refiner as R
    from polychase_tpu_torch.engine.levmarq import CAUCHY

    db = Database(db_path)
    try:
        data = R.build_refiner_data(db, traj, mesh, np.eye(4), device=device)
    finally:
        db.close()
    params = R.traj_to_params(traj, device=device)
    eye = torch.eye(4, device=device)
    prims = R.refresh_prims(params, data, mesh, eye)
    JtJ, Jtr = R.build_normal_equations(
        params, data, prims, mesh.triangle_corners(), eye, eye, 1.0,
        loss_type=CAUCHY, opt_f=True, opt_pp=False, ppc=9)
    band = R.compute_band(data, traj.count, 9)
    if not band:
        raise AssertionError("the refine problem did not take the band")
    lam = 1e-5

    def banded():
        return R.solve_step(JtJ, Jtr, lam, band)

    def dense():
        return R.solve_step(JtJ, Jtr, lam, ())

    sb, okb = banded()
    sd, okd = dense()
    if not (bool(okb) and bool(okd)):
        raise AssertionError("a solve of the refine system failed")
    rel = float((sb - sd).abs().max() / sd.abs().max())
    return band, JtJ.shape[0], event_ms(banded, 10), event_ms(dense, 10), rel


def refine_phase(device, *, n_frames=REFINE_FRAMES,
                 keypoints=REFINE_KEYPOINTS, sphere=REFINE_SPHERE, seed=2):
    """Config 4 on the card.  Returns the timed run's wall seconds and
    iteration count."""
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.levmarq import CAUCHY, BundleOptions
    from polychase_tpu_torch.engine.refiner import refine_trajectory
    from polychase_tpu_torch.synthetic import (
        build_flow_db, noisy_trajectory, orbit_poses, uv_sphere,
    )

    rng = np.random.default_rng(seed)
    verts, tris = uv_sphere(*sphere)
    mesh = Mesh.create(verts, tris, device=device)
    intr = Intrinsics.create(FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0, WIDTH,
                             HEIGHT, OPENCV, device=device)
    poses = orbit_poses(n_frames)
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                         max_iterations=REFINE_ITERS)
    print(f"  clip: {WIDTH}x{HEIGHT}, f={FOCAL:g}, {n_frames} frames, "
          f"{len(tris)} triangles, {keypoints} keypoints/frame, "
          f"{NOISE_PX} px noise; translations noised by N(0, "
          f"{REFINE_T_SIGMA})")

    def t_errs(traj):
        return np.array([np.linalg.norm(traj.get(i).pose.t.numpy()
                                        - poses[i][1])
                         for i in range(n_frames)])

    with tempfile.TemporaryDirectory() as td:
        db_path = os.path.join(td, "flow.db")
        build_flow_db(db_path, mesh, FOCAL, WIDTH, HEIGHT, poses, rng,
                      keypoints, NOISE_PX)

        def run(traj, callback=None):
            t0 = time.perf_counter()
            refine_trajectory(db_path, traj, np.eye(4, dtype=np.float32),
                              mesh, optimize_focal_length=True,
                              callback=callback, bundle_opts=opts,
                              device=device)
            torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        warm = run(noisy_trajectory(poses, intr, rng, REFINE_T_SIGMA))
        traj = noisy_trajectory(poses, intr, rng, REFINE_T_SIGMA)
        band = band_solve_check(device, db_path, traj, mesh)
        ends = [(traj.get(i).pose.q.numpy().copy(),
                 traj.get(i).pose.t.numpy().copy(),
                 float(traj.get(i).intrinsics.fy)) for i in (0, n_frames - 1)]
        before = t_errs(traj)
        updates = []
        wall = run(traj, lambda u: updates.append(u) or True)
        split = profile_split(
            lambda: run(noisy_trajectory(poses, intr, rng, REFINE_T_SIGMA)),
            device)

    fails = []
    stats = updates[-1].stats
    iters = int(stats.iterations)
    after = t_errs(traj)
    rot = max(quat_err(traj.get(i).pose.q.numpy(), poses[i][0])
              for i in range(n_frames))
    focal = np.array([float(traj.get(i).intrinsics.fy)
                      for i in range(n_frames)])
    print(f"  refine: {iters} iterations in {wall:.4f} s (warm-up run "
          f"{warm:.4f} s); cost {float(stats.initial_cost):.4f} -> "
          f"{float(stats.cost):.4f}; median t err {np.median(before):.3g} -> "
          f"{np.median(after):.3g}, max {before.max():.3g} -> "
          f"{after.max():.3g}; max rot err {rot:.3g} rad; max focal err "
          f"{np.abs(focal / FOCAL - 1).max():.3g} (rel)")
    if not float(stats.cost) < float(stats.initial_cost):
        fails.append("the cost did not fall")
    for (q0, t0, f0), i in zip(ends, (0, n_frames - 1)):
        s = traj.get(i)
        if not (np.array_equal(s.pose.q.numpy(), q0)
                and np.array_equal(s.pose.t.numpy(), t0)
                and float(s.intrinsics.fy) == f0):
            fails.append(f"anchor frame {i} moved")
    if not np.median(after) < np.median(before):
        fails.append("the median translation error did not fall")
    if rot > ROT_ERR_MAX:
        fails.append(f"rotation error {rot:.3g} > {ROT_ERR_MAX}")
    (nb, bs), n0, band_ms, dense_ms, rel = band
    print(f"  one normal system (P = {n0}, nb = {nb}, bs = {bs}): banded "
          f"{band_ms:.4f} ms, dense {dense_ms:.4f} ms, steps differ by "
          f"{rel:.3g} (rel)")
    if rel > BAND_REL_MAX:
        fails.append(f"banded and dense steps differ by {rel:.3g}")
    pwall, labels, busy_ms, busy = split
    print(f"  profiled run: {pwall:.4f} s, device time {busy_ms:.3f} ms, "
          f"busy share {busy:.4f}; device ms by stage: "
          + ", ".join(f"{k.split('.')[1]} {v:.3f}" for k, v in labels.items())
          + f", other {busy_ms - sum(labels.values()):.3f}")
    if fails:
        raise AssertionError("refine:\n" + "\n".join(fails))
    return wall, iters


# ---------------------------------------------------------------------------
# Pin phase
# ---------------------------------------------------------------------------


def pin_phase(device):
    """Config 2's drags.  Returns the 8-pin ms per drag, K1's launches on
    the main path (the 20 drags and the 16,384-point one), and the largest
    pose difference of K1 against its plain version on that drag's
    inputs."""
    from polychase_tpu_torch import crossover
    from polychase_tpu_torch.engine import pinmode
    from polychase_tpu_torch.kernels import pnp_lm

    pins, scene = crossover.pin_scene(device, 8)
    big, _ = crossover.pin_scene(device, PIN_BIG, seed=1)
    if len(pins) != 8 or len(big) != PIN_BIG:
        raise AssertionError(f"{len(pins)} and {len(big)} pins hit the mesh")
    drag = crossover.pin_drag
    for k in range(2):
        drag(pins, scene, k, device)
    inputs = []
    real = pnp_lm.solve_arrays_lm

    def record(*args, **kw):
        inputs.append((args, kw))
        return real(*args, **kw)

    on_device = len(pins) > pinmode.HOST_PIN_MAX
    pnp_lm.launches = 0
    pnp_lm.solve_arrays_lm = record
    try:
        t0 = time.perf_counter()
        for k in range(PIN_REPS):
            drag(pins, scene, k % 5, device)
        ms = (time.perf_counter() - t0) * 1e3 / PIN_REPS
        out_dev = drag(big, scene, 0, device)
    finally:
        pnp_lm.solve_arrays_lm = real
    launches = pnp_lm.launches
    saved = pinmode.HOST_PIN_MAX
    pinmode.HOST_PIN_MAX = 1 << 30
    try:
        out_host = drag(big, scene, 0, device)
    finally:
        pinmode.HOST_PIN_MAX = saved
    diff = float(np.abs(out_dev.view_matrix.numpy()
                        - out_host.view_matrix.numpy()).max())
    want = PIN_REPS * on_device + 1
    print(f"  8-pin drag: {ms:.4f} ms per solve ({PIN_REPS} drags, "
          f"{'device' if on_device else 'host'} route); {PIN_BIG}-point "
          f"drag: |view device - view host| {diff:.3g}; K1 launches on the "
          f"main path {launches} (= {want} drags on the device route)")
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times for {want} "
                             f"device-route drags")
    if diff > PIN_ROUTE_ATOL:
        raise AssertionError(f"device and host routes differ by {diff:.3g}")
    path_err = main_path_inputs_check(inputs)
    print(f"  route table (ms per drag; HOST_PIN_MAX = "
          f"{pinmode.HOST_PIN_MAX}):")
    for n, h_ms, d_ms in crossover.pin_route_table(device):
        print(f"    {n:6d} points: host {h_ms:.4f}, device {d_ms:.4f}")
    return ms, launches, path_err


def main() -> None:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    from polychase_tpu_torch.backend import require_cuda
    from polychase_tpu_torch.kernels import build, lk_iter, lk_prep, pnp_lm
    from polychase_tpu_torch.synthetic import panning_clip

    smi = nvidia_smi()
    print(f"card: {smi}")
    device = require_cuda()

    print("build (one nvcc per source, in parallel):")
    t0 = time.perf_counter()
    libs = build.load_all(["pnp_lm.cu", "lk_prep.cu", "lk_iter.cu"])
    for mod in (pnp_lm, lk_prep, lk_iter):
        mod.load()
    for lib in libs:
        print(f"  {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    print(f"  all built and loaded in {time.perf_counter() - t0:.2f} s")

    print("K1 phase (K1 vs plain torch, on the card):")
    max_err, times = kernel_phase(device)
    print("K1 launch-shape sweep:")
    k1_shape_sweep(device)
    frames = panning_clip(np.random.default_rng(0), PAN_FRAMES, WIDTH,
                          HEIGHT, PAN_STEP)
    print("LK kernel phase (K2, K3 vs plain torch, on the card):")
    patch_err, pos_err, lk_times, lk_bounds = lk_kernel_phase(device, frames)
    print("analyze phase (generate_optical_flow_database on the card):")
    lk_launches, analyze_fps = analyze_phase(device, frames)
    print(f"analyze {analyze_fps:.2f} frames/s at 1920x1080 on {smi}")
    print("tracking phase (track_sequence on the card):")
    launches, fps, path_err = main_path_phase(device)
    print(f"tracking {fps:.2f} frames/s at 1920x1080 on {smi}")
    print("refine phase (refine_trajectory, config 4, on the card):")
    refine_s, refine_iters = refine_phase(device)
    print(f"refine {refine_s:.4f} s, {refine_iters} iterations, 250 frames "
          f"on {smi}")
    print("pin phase (find_transformation, config 2):")
    pin_ms, pin_launches, pin_err = pin_phase(device)
    print(f"pin drag {pin_ms:.4f} ms per 8-pin solve on {smi}")

    (k2_ms, k2_plain), (k3_ms, k3_plain) = lk_times
    (k2_bound_ms, k2_by), (k3_bound_ms, k3_by) = lk_bounds
    k1_ms, k1_plain, _, _, (k1_bound_ms, k1_by) = times[
        "loss1_ftol1e-05_f0_pp0"]
    # No single PyTorch call computes any of the three (library_ms null).
    kernels = [{
        "name": "pnp_lm",
        "route": "cuda",
        "source": "polychase_tpu_torch/csrc/pnp_lm.cu",
        "replaces": "polychase_tpu/kernels/pnp_pallas.py:183",
        "launches": launches + pin_launches,
        "max_abs_err": max(max_err, path_err, pin_err),
        "ms": k1_ms,
        "plain_ms": k1_plain,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "lk_prep",
        "route": "cuda",
        "source": "polychase_tpu_torch/csrc/lk_prep.cu",
        "replaces": "polychase_tpu/kernels/lk_pallas.py:337",
        "launches": lk_launches[0],
        "max_abs_err": patch_err,
        "ms": k2_ms,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound_ms,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "lk_iter",
        "route": "cuda",
        "source": "polychase_tpu_torch/csrc/lk_iter.cu",
        "replaces": "polychase_tpu/kernels/lk_pallas.py:496",
        "launches": lk_launches[1],
        "max_abs_err": pos_err,
        "ms": k3_ms,
        "plain_ms": k3_plain,
        "bound_ms": k3_bound_ms,
        "bound_by": k3_by,
        "library_ms": None,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
