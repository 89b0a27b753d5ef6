#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (polychase_tpu_torch) on one GPU.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

1. Prints the torch and CUDA versions and the card's name and power limit.
2. Builds the six kernels with nvcc, one process per source, in
   parallel: K1 the whole-solve LM PnP (csrc/pnp_lm.cu), K2 the LK prep
   (csrc/lk_prep.cu), K3 the LK iteration (csrc/lk_iter.cu), K4 GFTT's
   min-distance suppression (csrc/gftt_suppress.cu), K5 the whole
   ``raycast_grouped`` cast, its closest-hit sweep and its hits
   (csrc/raycast_sweep.cu), K6 the whole ``grid_raycast``, the uniform
   grid's walk and its hits (csrc/grid_cast.cu).
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
   truth -s·(7, 4), the share of flows kept at ±1, that K2 and K3
   launched once per level of every solve and K4 once a frame where the
   frame size takes GFTT's device route, one CUDA launch a call; prints
   analyze frames/s and the device busy share.
6. Tracking phase: a synthetic 1920×1080, f = 1800, 120-frame orbit clip
   over a 20,224-triangle sphere with 2048 keypoints per frame and 0.3 px
   flow noise, written to a flow DB (its keypoints cast on a CPU copy of
   the mesh, by the plain route, so that the truth does not pass through
   K5), tracked through ``track_sequence`` forward over 119 frames,
   backward over 60, and over 24 frames with free focal length and
   principal point.  Checks that every frame step launched K1 and K5 once
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
   device busy share; K5 launched once per prim refresh of the timed run
   (the device route, below ``refiner.BVH_TRIANGLE_THRESHOLD``).  The
   clip's DB is cast on a CPU copy of the mesh, as the tracking truth is.
   One normal system of the problem (P = 2250, nb = 32, bs = 72) is
   solved by the banded and the dense solve, timed, and the two steps
   held within 1e-3 of each other.
8. K5 phase: K5, the whole ``raycast_grouped`` cast in one launch, against
   its plain route (``engine.raycast.cast_plain``: ``sweep_plain``, then
   ``hits_plain``) on the card, on nine scenes: a tracking frame's cast
   inputs recorded from the tracking phase (8192 rays, 20,224 triangles),
   config 4's prim refresh recorded from the refine phase (250 × 128 rays,
   1,472 triangles), those rays on the sphere with 40 triangles masked, on
   the sphere with every triangle twice (the id must be the lower copy's),
   and as 32,000 groups of one ray (the sharded flat cast's shape, packed
   128 a block), 7 groups of 333 rays over 5,040 triangles (neither a
   multiple of the block or the tile), the tracking frame's rays
   turned around (no hit), and its first 48 rays a group on the tracking
   mesh with 40 triangles masked, with the mask checked and not (K of 32
   to 64: 2 rays a thread).  Ids, t and valid equal to the bit on every
   ray; positions, normals and barycentrics within 1e-6 relative, the rays
   equal to the bit counted.  Prints per scene both times, the bound and
   its share, the launch plan and the launches; then the device kernels
   of one tracking frame's ``raycast_grouped`` (K5 alone), forward
   tracking frames/s with K5 and with the plain route, in turns, and a
   profiled K5 run's busy share and device time by kernel.
9. K6 phase: K6, the whole ``grid_raycast`` in one launch (a thread
   walking each ray's cells), against its plain version
   (``engine.gridcast.grid_plain``, the reference's lockstep loop in
   torch) on the card, on eight scenes: the recorded tracking frame (4 ×
   2048 rays, 20,224 triangles) and config 4's refresh (250 × 128 rays,
   1,472 triangles) as flat rays, those rays on the sphere with 40
   triangles masked, a soup of 20,000 triangles, axis-aligned rays from
   inside and outside the tracking mesh, a huge triangle that coarsens the
   grid, an empty mesh, and the tracking frame cut at ``max_iters`` 8.
   Every field of the hits equal to the bit, one launch a call counted by
   the wrapper and the library; then, but for the cut and the empty
   scenes, against K5 and the flat ``raycast`` (plain torch) with the
   mask on and off: ``valid`` and ids equal but on exact-t ties and on
   rays through a triangle's edge (a hit within 1e-5 of it in u, v or
   1 - u - v), t and positions within 1e-4 (tests/test_gridcast.py's
   tolerance: the casts test in different Möller-Trumbore forms).  Prints per scene both
   times, the bound (from the tests and cell actions the plain version
   counts) and its share, the grid and the walks' work; the grid module's
   entry points (``build_grid_accel``, ``grid_raycast_grouped`` on a
   tracking frame, ``grid_raycast`` on config 4's refresh) with K6's
   launches counted from 0; the builds' host times; K6 against K5 on
   the tracking frame.
10. Pin phase (config 2, ``run_all.py:219-265``): 20 timed 8-pin Camera-type
   drags and one drag of 16,384 surface points (the pins cast on a CPU copy
   of the mesh here and in the surface and add-on phases); every drag above
   ``pinmode.HOST_PIN_MAX`` points must launch K1 once, the big drag must
   agree with the host route within 1e-4, and K1 is held against its plain
   version on the drags' solver inputs.  (The host and device route times
   per pin count are ``python3 -m polychase_tpu_torch.crossover``'s.)
11. Surface phase: the data of the phases above through
   ``polychase_tpu_torch.polychase_core`` with no device argument, so on
   the card by default (analyze and refine on every card).  An
   ``OpticalFlowThread`` on the panning clip (analyze's gates, the direct
   run's keypoints and pairs, each frame requested once, K2 and K3 once per
   level of every solve, and of every shard with several cards); a forward
   ``TrackerThread`` over the tracking clip (the ground truth, the direct
   run's poses within 1e-6, one K1 and one K5 launch a frame); a
   ``RefinerThread`` on
   config 4 (refine's gates); 20 8-pin drags and one 16,384-point drag
   through ``find_transformation`` (the engine's result within 1e-6, K1 once
   per drag above ``pinmode.HOST_PIN_MAX``); 64 ``ray_cast`` picks
   (primitive ids equal to the device ray cast's); a ``CppException`` from a
   track on an empty DB and a clean ``request_stop``.  Then tracking and
   analyze frames/s and the 8-pin drag's ms, direct and through the
   surface (the threads, ``find_transformation``), in the order direct,
   surface, surface, direct.
12. Segments phase: the segment-parallel paths.  ``track_segments`` on
    the tracking clip in 4 segments of 30 frames seeded from the truth at
    frames 0, 30, 60 and 90 (K1 at S = 4, N = 8192 a solve): every pose
    within the ground-truth thresholds and within 1e-4 (q) / 1e-3 (t) of
    the sequential ``track_camera_trajectory`` from the same seed, K1 and K5
    launched once per step (29), not once per segment frame (116), and K1
    held against its plain version on S = 4 inputs recorded from the path.
    ``refine_segments`` on config 4's clip split at keyframes 0, 50, 100,
    150, 200, 249 (5 segments of ~51 frames, the keyframes true, so the
    stack takes the batched banded solve, nb = 7): each segment's cost
    falls, its anchors are untouched to the bit, its mean translation
    error (carried to the true focal, as for free-intrinsics tracking)
    falls below 0.6× the initial, and its translations lie within 2e-4 of
    the sequential ``refine_trajectory``'s: both paths' accepted states
    (each step taken, and its prims refreshed) held in order, up to and
    with the first refresh whose prims differ, or to the shorter path's
    last (``refine_seq_gate``), that refresh reported; it must not be the
    start state, and at most 1e-3 of the valid prims may differ there.
    Then through
    ``polychase_core`` with no device: ``device_count``, ``track_segments``
    and a ``RefineSegmentsThread``, each equal to the engine call within
    1e-6.  Prints tracking frames/s and refine seconds, sequential against
    segment-parallel, in turns (sequential, parallel, parallel,
    sequential).
13. Sharded phase: analyze and refine split over every card, or over two
    shards on card 0 when there is one (that runs the split, the per-shard
    launches and the sum, and measures no scaling).  The 24-frame panning
    clip through ``generate_optical_flow_database(device=list)`` (its
    ~42.4k corners a frame take the feature split): keypoints equal to the
    analyze phase's one-device DB, the same pairs and kept flows, the flows
    equal to the bit or else within 1e-4 px, K2 and K3 launched once per
    level of every shard of every solve.  One interior source frame's solve
    (T = 8) split by targets (``parallel.analyze.sharded_lk_multi``) and by
    features against ``_lk_all_levels_multi`` the same way, each timed with
    its K2 and K3 device time.  Config 4 through
    ``refine_trajectory(device=list)``: the sharded normal equations at the
    start against ``build_normal_equations`` (rtol 1e-3, atol 1e-5 × the
    largest entry), the prims of refine's split refresh and of
    ``sharded_raycast_flat`` equal to ``refresh_prims``', each cast timed,
    the per-rebuild copy of a partial JᵀJ timed between two cards, refine's
    gates, and against the one-device refine the same iterations, the final
    cost within 1e-4 (relative) and every pose within 1e-4 rad and 1e-4.
    The refine here reads config 4's clip cast by the plain route on the
    card (``refine_inputs``' ``card_db``), the data this phase had before
    the truth moved to the host.
    Then analyze frames/s and refine seconds, one device against the list,
    in turns (one, list, list, one).
14. Analyze-routes phase: K4 against its plain version
    (``suppress_plain`` + ``_compact_kept``) on the clip's response maps
    (every 4th frame) and one 3840×2160 noise frame at d ∈ {1, 2.5, 5, 8}
    (kept maps and kept lists equal to the bit, converged, the same
    rounds), GFTT's device-route corners against its host route's (equal,
    in the same order); K4 on clip frame 8 at d 5, its floor (d 1: one
    round, no neighbour reads), its plain time and its bound; K4 cut at 2
    rounds a call and resumed from its state against the uncut call, the
    rounds K4 runs on each clip frame; one frame's GFTT by route at 80×60,
    160×120, 320×240, 640×480, 1280×720, 1920×1080 and 3840×2160 in turns
    (host, device, device, host), and the size from which the device route
    wins both turns beside ``gftt.DEVICE_SUPPRESS_MIN``; analyze's keypoints
    with GFTT's device route equal to its host route's; the clip analyzed with
    ``POLYCHASE_LK_CHAIN=1`` (analyze's gates; the unchained DB's
    keypoints and pairs; tests/test_opticalflow.py:119-170's gates at
    skips ±1/±2: each pair's shared flows within a median 0.05 px, > 0.97
    of the flows kept by both; K2 once per level of every solve, K3 once
    per level of every phase, K4 once a frame on the device route), and
    analyze frames/s with GFTT's host route, its device route and chained
    in turns; the chained analyze split over every card (or two
    shards on card 0) against the one-device chained DB, with its K2/K3
    launches; the frames resumed on the card (a fixed point that outlasts
    ``gftt.MAX_ROUNDS`` rounds) in the whole run.
15. Add-on phase: the Blender add-on copy as a user installs it.  The zip
    of ``scripts/package_addon_torch.py`` is built and extracted into a
    temporary directory outside the checkout, its shim imported under the
    fake bpy of ``tests/`` with the checkout's package set aside and a fresh
    user cache as ``XDG_CACHE_HOME``: the package comes from the zip, no
    jax is loaded, the host library and K1-K5 build from the zip's sources
    into the user cache.  With ``core.DEVICE`` left at None (the card):
    ``PC_OT_AnalyzeVideo`` through its modal loop on the 24-frame panning
    clip (served as Blender's float pixels), its DB equal to the surface
    phase's to the bit and analyze's gates; ``PC_OT_TrackSequence`` over
    the tracking clip (its DB flipped to the OpenGL convention's y up, the
    camera posed at frame 0), every frame keyed, the keyframes within 1e-6
    of the direct ``track_sequence`` on the add-on's own inputs written
    back by the add-on's own code, and within the ground-truth thresholds
    (the difference from the surface phase's OpenCV poses printed); one
    8-pin drag of pin 2 through pin mode within ``PIN_ROUTE_ATOL`` of the
    pin phase's drag; K1-K5 launched as the runs need (K5 once a tracked
    frame).  Then analyze and
    tracking frames/s through the surface and through the add-on, in turns
    (surface, add-on, add-on, surface).
16. Prints the card, the kernels' JSON line (time, plain time, bound and
    what sets it, launches on the main path (the analyze, tracking and pin
    phases) and apart in the refine, surface, segments, sharded, routes and
    add-on phases, for K4, K5 and K6 also their CUDA launches (one a
    call), for K4 the rounds of the main path's frames, both neighbour
    reads' times and its floor, for K5 config 4's refresh times, the
    groups of one ray's, the frame's launch plan, registers and spills, and
    its cast's device kernels, for K6 the launches of the grid module's
    entry points, the refresh times, the threads a block, registers,
    spills, the grid's build and the difference from K5 and the flat
    cast, largest difference)
    and, last, ``{"ok": true, ...}``.

Any failed check raises, so the script exits non-zero without the last line.
It refuses to run without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from polychase_tpu_torch.timing import device_work, event_ms

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
# Segments: the tracking clip's seeds, config 4's keyframes, and the
# bars of tests/test_torch_tracker.py (batched against sequential
# tracking) and tests/test_segments_parallel.py (refine).
TRACK_SEEDS, TRACK_SEGMENT = (0, 30, 60, 90), 30
REFINE_KEYS = (0, 50, 100, 150, 200, 249)
Q_PAIR, T_PAIR = 1e-4, 1e-3
REFINE_T_SHARE, REFINE_SEQ_ATOL = 0.6, 2e-4
# At the first refresh whose prims differ (refine_seq_gate), at most this
# share of the valid prims may differ: a refresh that moves a ray or two
# across a triangle's edge passes, a wrong cast does not.  Never at the
# start state, which both paths cast from the same t.
REFINE_SPLIT_SHARE = 1e-3
# Where the truth is cast (tracking's and refine's flow DBs, the pins).
CPU = torch.device("cpu")


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
    return k1_batch_bound(n, n_params, [iterations])


def k1_batch_bound(n, n_params, iterations):
    """K1 on one launch of ``len(iterations)`` solves of n points each, each
    solve with its own iteration count: the solves' bytes and operations
    summed."""
    nbytes = len(iterations) * (n * (12 + 8 + 4 + 1) + 16 * 4 + 19 * 4)
    ops = sum(it + 1 for it in iterations) * n * K1_OPS_POINT_ITER[n_params]
    return bound_ms(nbytes, ops)


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


def read_analyze_db(path, n):
    """The keypoints of every frame and the flows of every skip pair that a
    DB of an n-frame analyze holds."""
    from polychase_tpu_torch.io.database import Database
    from polychase_tpu_torch.engine.opticalflow import IMAGE_SKIPS

    db = Database(path)
    try:
        kps = [db.read_keypoints(f) for f in range(n)]
        flows = {(f, f + s): db.read_image_pair_flow(f, f + s)
                 for f in range(n) for s in IMAGE_SKIPS
                 if 0 <= f + s < n and db.image_pair_flow_exists(f, f + s)}
    finally:
        db.close()
    return kps, flows


def analyze_gates(kps, flows, n):
    """Analyze's gates on a DB's rows: corners on every frame, every skip
    pair, the flows of skips ±1 and ±2 against the ground truth -s·PAN_STEP
    and the share kept at ±1.  Prints each skip's errors; returns the
    failures."""
    from polychase_tpu_torch.engine.opticalflow import IMAGE_SKIPS

    fails = []
    counts = [k.shape[0] for k in kps]
    print(f"  {n} frames, pan {PAN_STEP} px/frame; corners per frame "
          f"{min(counts)}..{max(counts)}")
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
    return fails


def analyze_solves(n, height, width):
    """(levels, solves) of an n-frame analyze: K2 and K3 launch once per
    level of every solve."""
    from polychase_tpu_torch.engine import lk
    from polychase_tpu_torch.engine.opticalflow import IMAGE_SKIPS

    levels = lk.num_pyramid_levels(height, width, lk.LKOptions())
    solves = sum(1 for f in range(n)
                 if any(0 <= f + s < n for s in IMAGE_SKIPS))
    return levels, solves


def analyze_k4(height, width) -> bool:
    """Whether frames of this size take GFTT's device route (K4)."""
    from polychase_tpu_torch.engine import gftt

    return gftt.device_suppress_route(height * width, gftt.GFTTOptions())


def analyze_phase(device, frames, workdir):
    """Analyze the panning clip twice (warm-up, timed), each into a fresh
    DB in ``workdir``, and check the timed run against the ground truth; a
    third run under ``torch.profiler`` gives the device busy share.  Returns
    the K2, K3 and K4 launch counts of the timed run, its frames/s and its
    DB's path."""
    from polychase_tpu_torch.engine import gftt
    from polychase_tpu_torch.engine.opticalflow import (
        VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.kernels import gftt_suppress, lk_iter, lk_prep

    n = len(frames)
    height, width = frames[0].shape
    info = VideoInfo(width, height, 0, n)

    def run(path):
        t0 = time.perf_counter()
        generate_optical_flow_database(info, lambda f: frames[f], None, path,
                                       device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = run(os.path.join(workdir, "analyze_warm.db"))
    lk_prep.launches = lk_iter.launches = gftt_suppress.launches = 0
    # K4's library counts the cooperative launches the runtime accepted.
    queued0 = gftt_suppress.cuda_launches()
    path = os.path.join(workdir, "analyze.db")
    seconds = run(path)
    launches = (lk_prep.launches, lk_iter.launches, gftt_suppress.launches)
    k4_queued = gftt_suppress.cuda_launches() - queued0
    pwall, _, busy_ms, busy, _ = profile_split(
        lambda: run(os.path.join(workdir, "analyze_profiled.db")), device, ())
    print(f"  clip: {width}x{height}")
    fails = analyze_gates(*read_analyze_db(path, n), n)
    levels, solves = analyze_solves(n, height, width)
    # K4 once per detected frame where frames of this size take the device
    # suppression route.
    k4 = n if analyze_k4(height, width) else 0
    if launches != (levels * solves, levels * solves, k4):
        fails.append(f"K2/K3/K4 launched {launches} times for {solves} "
                     f"solves of {levels} levels and {k4} K4 frames")
    if k4_queued != launches[2]:
        fails.append(f"K4's {launches[2]} calls made {k4_queued} CUDA "
                     f"launches, want one each")
    if not busy_ms > 0.0:
        fails.append("the profiler saw no work on the device")
    if fails:
        raise AssertionError("analyze:\n" + "\n".join(fails))
    fps = n / seconds
    print(f"  K2 / K3 / K4 launches on the main path: {launches[0]} / "
          f"{launches[1]} (= {solves} solves x {levels} levels) / "
          f"{launches[2]} (GFTT device route from "
          f"{gftt.DEVICE_SUPPRESS_MIN} px; {k4_queued} CUDA launches "
          f"by K4, one a call)")
    print(f"  analyze: {n} frames in {seconds:.3f} s = {fps:.2f} frames/s "
          f"(warm-up run {warm:.3f} s); profiled run {pwall:.4f} s, device "
          f"time {busy_ms:.3f} ms, busy share {busy:.4f}")
    return launches + (k4_queued,), fps, path


# ---------------------------------------------------------------------------
# Tracking phase
# ---------------------------------------------------------------------------


def quat_err(qa, qb) -> float:
    """Rotation angle between two unit quaternions, in float64: 4·atan2 of
    the chord and its complement, which keeps its precision at small
    angles (2·arccos of the dot product of float32 quaternions read up to
    7e-4 rad for ones equal within 3e-8)."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    qa, qb = qa / np.linalg.norm(qa), qb / np.linalg.norm(qb)
    if np.dot(qa, qb) < 0.0:
        qb = -qb
    return 4.0 * float(np.arctan2(np.linalg.norm(qa - qb),
                                  np.linalg.norm(qa + qb)))


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


def main_path_inputs_check(inputs, path="main-path"):
    """K1 against its plain version on solver inputs recorded from a path;
    times the last launch (``k1_report``).  Returns the largest pose
    difference and that launch's (kernel ms, plain ms, ms per iteration,
    floor ms, its 19-float results)."""
    from polychase_tpu_torch.engine.pnp import solve_arrays
    from polychase_tpu_torch.kernels.pnp_lm import solve_arrays_lm

    max_err, fails = 0.0, []
    for i, (args, kw) in enumerate(inputs):
        got = solve_arrays_lm(*args, **kw).cpu().numpy()
        ref = solve_arrays(*args, **kw).cpu().numpy()
        opt = kw["opt_f"] or kw["opt_pp"]
        dpose, f = compare(f"{path} launch {i}", got, ref, None, opt)
        max_err = max(max_err, dpose)
        fails += f
    if fails or not inputs:
        raise AssertionError(f"{path} inputs:\n" + "\n".join(fails))
    S, N = (int(n) for n in inputs[-1][0][0].shape[:2])
    print(f"  K1 vs plain on {len(inputs)} recorded {path} launches "
          f"({sum(int(a[0].shape[0]) for a, _ in inputs)} solves): max "
          f"|dpose| {max_err:.3g}")
    args, kw = inputs[-1]
    timing = k1_report(f"the last one (S={S}, N={N})", args, kw, got, 3)
    return max_err, (*timing, got)


def main_path_phase(device, workdir, *, n_frames=N_FRAMES,
                    keypoints=KEYPOINTS, sphere=SPHERE, seed=1):
    """Tracking on the card, its flow DB written into ``workdir`` (cast on
    the host).  Returns K1's launches, forward frames/s, K1's largest
    difference from its plain version on recorded inputs, and what later
    phases reuse: the DB, the mesh's arrays, the ground truth, the forward
    run's results, the run itself, K5's launches and a frame's recorded
    sweep inputs."""
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import (
        Mesh, SceneTransformations,
    )
    from polychase_tpu_torch.engine.levmarq import BundleOptions
    from polychase_tpu_torch.engine.pose import quat_to_mat_np
    from polychase_tpu_torch.engine import tracker
    from polychase_tpu_torch.kernels import pnp_lm, raycast_sweep
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

    db_path = os.path.join(workdir, "track.db")
    t0 = time.perf_counter()
    # The truth's keypoints are cast by the plain sweep on a CPU copy of
    # the mesh, not by K5, which the path under test runs.
    build_flow_db(db_path, Mesh.create(verts, tris, device="cpu"), FOCAL,
                  WIDTH, HEIGHT, poses, rng, keypoints, NOISE_PX)
    print(f"  flow DB written in {time.perf_counter() - t0:.2f} s (cast on "
          f"the host)")
    # Warm-up (first launches, allocator), recording the solver's and the
    # sweep's inputs: K1 and K5 are then held against their plain versions
    # on the very tensors the main path hands them.
    inputs, sweeps = [], []
    real, real_sweep = tracker.solve_arrays_lm, raycast_sweep.raycast_hits

    def record(*args, **kw):
        inputs.append((args, kw))
        return real(*args, **kw)

    def record_sweep(*args, **kw):
        sweeps.append(args[:6])
        return real_sweep(*args, **kw)

    tracker.solve_arrays_lm = record
    raycast_sweep.raycast_hits = record_sweep
    try:
        run(db_path, 0, 8)
    finally:
        tracker.solve_arrays_lm = real
        raycast_sweep.raycast_hits = real_sweep
    path_err, _ = main_path_inputs_check(inputs)

    pnp_lm.launches = raycast_sweep.launches = 0
    # K5's library counts the launches the runtime accepted.
    queued0 = raycast_sweep.cuda_launches()
    fwd, fwd_s = run(db_path, 0, n_frames - 1)
    half = n_frames // 2
    bwd, _ = run(db_path, half, 0)
    seg = min(24, n_frames - 1)
    opt, _ = run(db_path, 0, seg, opt=True)
    launches, k5_launches = pnp_lm.launches, raycast_sweep.launches
    k5_queued = raycast_sweep.cuda_launches() - queued0

    solved = (n_frames - 1) + half + seg
    check("forward", fwd, n_frames - 1)
    check("backward", bwd, half)
    check("opt f+pp", opt, seg, opt=True)
    if (launches, k5_launches, k5_queued) != (solved,) * 3:
        raise AssertionError(
            f"K1 and K5 launched {launches} and {k5_launches} times "
            f"({k5_queued} CUDA launches of K5) for {solved} solved frames")
    fps = (n_frames - 1) / fwd_s
    print(f"  K1 / K5 launches on the main path: {launches} / {k5_launches} "
          f"(= {solved} frame steps; K5's CUDA launches {k5_queued})")
    print(f"  forward tracking: {n_frames - 1} frames in {fwd_s:.3f} s = "
          f"{fps:.2f} frames/s")
    track = dict(db=db_path, verts=verts, tris=tris, poses=poses, fwd=fwd,
                 run=run, k5_launches=k5_launches,
                 k5_cuda_launches=k5_queued, sweep=sweeps[-1])
    return launches, fps, path_err, track


# ---------------------------------------------------------------------------
# Refine phase
# ---------------------------------------------------------------------------


def profile_split(fn, device, labels=REFINE_LABELS):
    """Run ``fn`` under ``torch.profiler``; returns the host-clock seconds,
    the device time of each of ``labels`` (ms), the device's busy time (ms),
    the busy share and the device time (ms) of each kernel, copy and fill
    by name, largest first.  A label's time is that of the kernels under the
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
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and e.name() not in host_names]
    spans = sorted((e.start_ns(), e.end_ns()) for e in device)
    by_name = {}
    for e in device:
        by_name[e.name()] = (by_name.get(e.name(), 0.0)
                             + (e.end_ns() - e.start_ns()) / 1e6)
    busy_ns, end = 0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy_ns += hi - lo
            end = hi
        elif hi > end:
            busy_ns += hi - end
            end = hi
    return (wall, split, busy_ns / 1e6, busy_ns / 1e9 / wall,
            sorted(by_name.items(), key=lambda kv: -kv[1]))


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


def refine_gates(state, poses, ends, before, stats):
    """Refine's gates on a refined trajectory: the cost falls, the anchors
    (first and last frame, ``ends``: their (q, t, fy) before) are untouched
    to the bit, the median translation error falls from ``before``, every
    rotation error is within ``ROT_ERR_MAX``.  ``state(i)`` gives frame i's
    (q, t, fy) on the host.  Prints the errors; returns the failures."""
    n = len(poses)
    states = [state(i) for i in range(n)]
    after = np.array([np.linalg.norm(t - poses[i][1])
                      for i, (_, t, _) in enumerate(states)])
    rot = max(quat_err(q, poses[i][0]) for i, (q, _, _) in enumerate(states))
    focal = np.array([f for _, _, f in states])
    print(f"  cost {float(stats.initial_cost):.4f} -> {float(stats.cost):.4f}"
          f"; median t err {np.median(before):.3g} -> {np.median(after):.3g}"
          f", max {before.max():.3g} -> {after.max():.3g}; max rot err "
          f"{rot:.3g} rad; max focal err {np.abs(focal / FOCAL - 1).max():.3g}"
          f" (rel)")
    fails = []
    if not float(stats.cost) < float(stats.initial_cost):
        fails.append("the cost did not fall")
    for (q0, t0, f0), i in zip(ends, (0, n - 1)):
        q, t, f = states[i]
        if not (np.array_equal(q, q0) and np.array_equal(t, t0) and f == f0):
            fails.append(f"anchor frame {i} moved")
    if not np.median(after) < np.median(before):
        fails.append("the median translation error did not fall")
    if rot > ROT_ERR_MAX:
        fails.append(f"rotation error {rot:.3g} > {ROT_ERR_MAX}")
    return fails


def refine_inputs(device, workdir, *, n_frames=REFINE_FRAMES,
                  keypoints=REFINE_KEYPOINTS, sphere=REFINE_SPHERE, seed=2):
    """Config 4's clip: its flow DB written into ``workdir``; returns the
    DB, the mesh's arrays, the ground truth and a maker of noisy starting
    trajectories, and the mesh on ``device``."""
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.synthetic import (
        build_flow_db, noisy_trajectory, orbit_poses, uv_sphere,
    )

    rng = np.random.default_rng(seed)
    verts, tris = uv_sphere(*sphere)
    mesh = Mesh.create(verts, tris, device=device)
    intr = Intrinsics.create(FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0, WIDTH,
                             HEIGHT, OPENCV, device=device)
    poses = orbit_poses(n_frames)
    print(f"  clip: {WIDTH}x{HEIGHT}, f={FOCAL:g}, {n_frames} frames, "
          f"{len(tris)} triangles, {keypoints} keypoints/frame, "
          f"{NOISE_PX} px noise; translations noised by N(0, "
          f"{REFINE_T_SIGMA})")

    def noisy():
        return noisy_trajectory(poses, intr, rng, REFINE_T_SIGMA)

    db_path = os.path.join(workdir, "refine.db")
    # Cast on a CPU copy of the mesh, as the tracking truth and the pins
    # are, so that the truth passes through no card's rounding.
    build_flow_db(db_path, Mesh.create(verts, tris, device=CPU), FOCAL,
                  WIDTH, HEIGHT, poses, rng, keypoints, NOISE_PX)

    def card_db(path):
        """The same clip's DB (the same draws) cast by the plain route on
        the card, as the truth was cast before it moved to the host: the
        sharded phase's data (module docstring, item 13)."""
        with plain_route():
            build_flow_db(path, mesh, FOCAL, WIDTH, HEIGHT, poses,
                          np.random.default_rng(seed), keypoints, NOISE_PX)
        return path
    return dict(db=db_path, card_db=card_db, verts=verts, tris=tris,
                poses=poses, noisy=noisy), mesh


def refine_phase(device, workdir, **size):
    """Config 4 on the card, its flow DB written into ``workdir``.  Returns
    the timed run's wall seconds and iteration count, and what later phases
    reuse: ``refine_inputs``' dict, with K5's launches in the timed run and
    a prim refresh's recorded sweep inputs."""
    from polychase_tpu_torch.engine import refiner as R
    from polychase_tpu_torch.engine.levmarq import CAUCHY, BundleOptions
    from polychase_tpu_torch.engine.refiner import refine_trajectory
    from polychase_tpu_torch.kernels import raycast_sweep

    refine, mesh = refine_inputs(device, workdir, **size)
    db_path, poses, noisy = refine["db"], refine["poses"], refine["noisy"]
    n_frames = len(poses)
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                         max_iterations=REFINE_ITERS)

    def run(traj, callback=None):
        t0 = time.perf_counter()
        refine_trajectory(db_path, traj, np.eye(4, dtype=np.float32),
                          mesh, optimize_focal_length=True,
                          callback=callback, bundle_opts=opts,
                          device=device)
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    if R._refresh_routing(mesh):
        raise AssertionError("config 4's mesh took the host BVH route")
    sweeps = []
    real_sweep, real_refresh = raycast_sweep.raycast_hits, R.refresh_prims

    def record_sweep(*args, **kw):
        sweeps.append(args[:6])
        return real_sweep(*args, **kw)

    raycast_sweep.raycast_hits = record_sweep
    try:
        warm = run(noisy())
    finally:
        raycast_sweep.raycast_hits = real_sweep
    traj = noisy()
    band = band_solve_check(device, db_path, traj, mesh)

    def state(i):
        s = traj.get(i)
        return (s.pose.q.numpy().copy(), s.pose.t.numpy().copy(),
                float(s.intrinsics.fy))

    ends = [state(i) for i in (0, n_frames - 1)]
    before = np.array([np.linalg.norm(state(i)[1] - poses[i][1])
                       for i in range(n_frames)])
    updates, refreshes = [], []

    def count_refresh(*args, **kw):
        refreshes.append(1)
        return real_refresh(*args, **kw)

    raycast_sweep.launches = 0
    R.refresh_prims = count_refresh
    try:
        wall = run(traj, lambda u: updates.append(u) or True)
    finally:
        R.refresh_prims = real_refresh
    k5_launches = raycast_sweep.launches
    split = profile_split(lambda: run(noisy()), device)

    stats = updates[-1].stats
    iters = int(stats.iterations)
    print(f"  refine: {iters} iterations in {wall:.4f} s (warm-up run "
          f"{warm:.4f} s)")
    fails = refine_gates(state, poses, ends, before, stats)
    print(f"  K5 launches in the timed run: {k5_launches} (= "
          f"{len(refreshes)} prim refreshes on the device route)")
    if k5_launches != len(refreshes) or not refreshes:
        fails.append(f"K5 launched {k5_launches} times for "
                     f"{len(refreshes)} prim refreshes")
    (nb, bs), n0, band_ms, dense_ms, rel = band
    print(f"  one normal system (P = {n0}, nb = {nb}, bs = {bs}): banded "
          f"{band_ms:.4f} ms, dense {dense_ms:.4f} ms, steps differ by "
          f"{rel:.3g} (rel)")
    if rel > BAND_REL_MAX:
        fails.append(f"banded and dense steps differ by {rel:.3g}")
    pwall, labels, busy_ms, busy, _ = split
    print(f"  profiled run: {pwall:.4f} s, device time {busy_ms:.3f} ms, "
          f"busy share {busy:.4f}; device ms by stage: "
          + ", ".join(f"{k.split('.')[1]} {v:.3f}" for k, v in labels.items())
          + f", other {busy_ms - sum(labels.values()):.3f}")
    if fails:
        raise AssertionError("refine:\n" + "\n".join(fails))
    refine.update(k5_launches=k5_launches, sweep=sweeps[0])
    return wall, iters, refine


# ---------------------------------------------------------------------------
# K5 phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_route():
    """``raycast_grouped`` through its plain route (``cast_plain``:
    ``sweep_plain``, then ``hits_plain``) on every device for the block,
    K5 set aside."""
    from polychase_tpu_torch.engine.raycast import cast_plain
    from polychase_tpu_torch.kernels import raycast_sweep

    real = raycast_sweep.raycast_hits
    raycast_sweep.raycast_hits = cast_plain
    try:
        yield
    finally:
        raycast_sweep.raycast_hits = real


# K5 against its plain route: ids, t and valid to the bit; positions,
# normals and barycentrics within this, relative (to the bit where K5
# copies torch's rounding, which it counts).
K5_FIELD_RTOL = 1e-6
# f32 operations of the cast, the work its inputs need in K5's layout for
# them.  Grouped (K of 32 or more): a (ray, triangle) pair's three dot
# products (9 products, 6 sums), u + v and 4 compares; a (group, triangle)
# pair's o - v0 (3), B and Cq (9 each: a product and an FMA a component),
# sdet (5) and the sign fold (2 compares, 9 multiplies by the sign, |sdet|).
# Packed (K under 32, each ray its own group's constants, folded a pair):
# the pair's 15, 4 sign flips, u + v and 5 compares; the (group, triangle)
# pair's 26.  Both: a triangle's edges (6) and A (9); a ray's hit: its edges
# and o - q1 (9), three cross products (27), three sums of products (15),
# the reciprocal and two products, the blend (17), the normal (9 + 6 + 4)
# and the tests (4).  The sweep's divisions, one a pair that passes the
# test (a few a ray), are left out: under 1e-4 of the count.
K5_OPS_PAIR, K5_OPS_GROUP_TRI = 20, 38
K5_OPS_PACKED_PAIR, K5_OPS_PACKED_GROUP_TRI = 25, 26
K5_OPS_TRI, K5_OPS_RAY = 15, 94
# Rays of the refresh scenes as groups of one (the sharded flat cast).
K5_FLAT = 32_000
HIT_FIELDS = ("pos", "normal", "barycentric", "t", "prim_id", "valid")


def k5_bound(args):
    """K5 on ``args`` (origins, dirs, vertices, triangles, mask words, the
    mask flag): every input read once, the hits (pos, normal 12 bytes,
    barycentric 8, t 4, id 8, valid 1) written once; every pair's, (group,
    triangle)'s, triangle's and ray's operations, in the layout K5 takes
    for these groups."""
    from polychase_tpu_torch.kernels.raycast_sweep import PACKED_BELOW

    o, d, verts, tris, words = args[:5]
    G, K = d.shape[:2]
    T, V, W = tris.shape[0], verts.shape[0], words.shape[0]
    nbytes = V * 12 + T * 24 + W * 8 + G * 12 + G * K * (12 + 45)
    pair, group_tri = ((K5_OPS_PACKED_PAIR, K5_OPS_PACKED_GROUP_TRI)
                       if K < PACKED_BELOW else
                       (K5_OPS_PAIR, K5_OPS_GROUP_TRI))
    ops = (G * K * T * pair + G * T * group_tri + T * K5_OPS_TRI
           + G * K * K5_OPS_RAY)
    return bound_ms(nbytes, ops)


def k5_registers(log, plan):
    """Registers and spill bytes of the kernel ``plan`` launches, from
    K5's ``nvcc -Xptxas -v`` log."""
    return kernel_registers(
        log, f"hits_kernelILi{plan.rays_per_thread}ELb{int(plan.packed)}E")


def kernel_registers(log, name):
    """Registers and spill bytes of the entry function whose mangled name
    holds ``name``, from an ``nvcc -Xptxas -v`` log."""
    found, regs, spills = False, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = name in line
        elif found and "spill stores" in line:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif found and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split("registers")[0])
            found = False
    return regs, spills


def k5_check(label, args, plain_reps=3):
    """K5 against the plain route (``cast_plain``) on ``args`` (origins,
    dirs, vertices, triangles, mask words, the mask flag) on the card;
    prints both times, the bound, its share and the launch count.  Returns
    (failures, max |difference| over the float fields, kernel ms, plain ms,
    (bound ms, what bounds it), the plan)."""
    from polychase_tpu_torch.engine.raycast import cast_plain
    from polychase_tpu_torch.kernels import raycast_sweep

    o, d, verts, tris = args[:4]
    G, K = d.shape[:2]
    T = tris.shape[0]
    before = (raycast_sweep.launches, raycast_sweep.cuda_launches())
    got = raycast_sweep.raycast_hits(*args)
    launched = (raycast_sweep.launches - before[0],
                raycast_sweep.cuda_launches() - before[1])
    want = cast_plain(*args)
    torch.cuda.synchronize()
    fails = []
    if launched != (1, 1):
        fails.append(f"{label}: K5 launched {launched}, want one call and "
                     f"one CUDA launch")
    for f in ("prim_id", "t", "valid"):
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a, b):
            fails.append(f"{label}: {f} differs from the plain route's on "
                         f"{int((a != b).sum())} of {G * K} rays")
    max_err, bits = 0.0, []
    for f in ("pos", "normal", "barycentric"):
        a, b = getattr(got, f), getattr(want, f)
        diff = (a - b).abs()
        rel = float((diff / b.abs().clamp_min(1e-30)).max())
        max_err = max(max_err, float(diff.max()))
        same = int(torch.eq(a, b).all(dim=-1).sum())
        bits.append(f"{f} {same}")
        if rel > K5_FIELD_RTOL:
            fails.append(f"{label}: {f} differs by {rel:.3g} (relative)")
    hits = int(want.valid.sum())
    ms = event_ms(lambda: raycast_sweep.raycast_hits(*args), 20)
    plain = event_ms(lambda: cast_plain(*args), plain_reps)
    bound = k5_bound(args)
    plan = raycast_sweep.launch_plan(G, K, T,
                                     raycast_sweep._sm_count(o.device))
    print(f"  {label} (G {G}, K {K}, T {T}; {plan}): ids, t and valid equal "
          f"to the plain route's on {G * K} rays: "
          f"{not any('differs from' in x for x in fails)}, {hits} hits; "
          f"to the bit on rays: {', '.join(bits)}; max |diff| "
          f"{max_err:.3g}; K5 {ms:.4f} ms, plain {plain:.4f} ms; bound "
          f"{bound[0]:.6f} ms ({bound[1]}), {bound[0] / ms:.4f} of it; "
          f"launches {launched[0]} (CUDA {launched[1]})")
    return fails, max_err, ms, plain, bound, plan


def k5_tracking_turns(device, track, smi):
    """Forward tracking over the tracking clip with K5 and with the plain
    route on the card, in turns (K5, plain, plain, K5), then one K5 run
    under ``torch.profiler``: its busy share and the device time of its
    largest kernels by name."""
    run, db = track["run"], track["db"]
    n = len(track["poses"]) - 1
    turns = []
    for how in ("K5", "plain", "plain", "K5"):
        with plain_route() if how == "plain" else contextlib.nullcontext():
            turns.append((how, n / run(db, 0, n)[1]))
    print(f"  forward tracking ({n} frames; K5, plain route, in turns): "
          + ", ".join(f"{how} {fps:.4f}" for how, fps in turns)
          + f" frames/s on {smi}")
    wall, _, busy_ms, busy, kernels = profile_split(
        lambda: run(db, 0, n), device, ())
    print(f"  profiled K5 run: {wall:.4f} s, device time {busy_ms:.3f} ms, "
          f"busy share {busy:.4f}; device ms by kernel: "
          + ", ".join(f"{name[:60]} {ms:.3f}" for name, ms in kernels[:8]))
    return turns


def k5_phase(device, track, refine, smi):
    """K5 against its plain route on the nine scenes of the module
    docstring (item 8), the kernels of one tracking frame's cast, and
    tracking with K5 against the plain route.  Returns the largest
    difference, each scene's (ms, plain ms, bound, plan) and the frame's
    kernel count."""
    from polychase_tpu_torch.engine import raycast as R
    from polychase_tpu_torch.engine.geometry import (
        Mesh, mask_array_size, set_mask_bits,
    )
    from polychase_tpu_torch.kernels import raycast_sweep
    from polychase_tpu_torch.synthetic import uv_sphere

    def arrays(mesh):
        return mesh.vertices, mesh.triangles, mesh.masked_triangles, True

    frame = track["sweep"]
    o, d = refine["sweep"][:2]
    rverts, rtris = refine["verts"], refine["tris"]
    rng = np.random.default_rng(7)
    words = np.zeros(mask_array_size(len(rtris)), np.uint32)
    for i in rng.choice(len(rtris), 40, replace=False):
        words = set_mask_bits(words, int(i), "mask")
    masked = Mesh.create(rverts, rtris, words, device=device)
    twice = Mesh.create(rverts, np.concatenate([rtris, rtris]),
                        device=device)
    n_flat = min(K5_FLAT, d.shape[0] * d.shape[1])
    flat_o = o[:, None, :].expand(d.shape).reshape(-1, 3)[:n_flat]
    flat_d = d.reshape(-1, 1, 3)[:n_flat]
    # The tracking mesh with 40 triangles masked, for a frame of 48 rays a
    # group (K of 32 to 64 takes 2 rays a thread).
    twords = np.zeros(mask_array_size(len(track["tris"])), np.uint32)
    for i in rng.choice(len(track["tris"]), 40, replace=False):
        twords = set_mask_bits(twords, int(i), "mask")
    tmasked = Mesh.create(track["verts"], track["tris"], twords,
                          device=device)
    k48 = (frame[0], frame[1][:, :48].contiguous(), *arrays(tmasked)[:3])
    ragged = Mesh.create(*uv_sphere(36, 72), device=device)
    ang = rng.uniform(0, 2 * np.pi, 7)
    ro = np.stack([4 * np.sin(ang), rng.uniform(-0.5, 0.5, 7),
                   -4 * np.cos(ang)], -1).astype(np.float32)
    rd = (rng.normal(size=(7, 333, 3)) * 0.7 - ro[:, None]).astype(
        np.float32)
    scenes = [
        ("tracking frame", frame),
        ("config 4 refresh", refine["sweep"]),
        ("40 triangles masked", (o, d, *arrays(masked))),
        ("every triangle twice", (o, d, *arrays(twice))),
        ("groups of one ray", (flat_o.contiguous(), flat_d.contiguous(),
                               *refine["sweep"][2:])),
        ("K 333, T 5,040", (torch.as_tensor(ro, device=device),
                            torch.as_tensor(rd, device=device),
                            *arrays(ragged))),
        ("no hit", (frame[0], (-frame[1]).contiguous(), *frame[2:])),
        ("K 48, 40 masked", (*k48, True)),
        ("K 48, mask off", (*k48, False)),
    ]
    fails, max_err, results = [], 0.0, {}
    for label, args in scenes:
        f, err, ms, plain, bound, plan = k5_check(label, args)
        fails += f
        max_err = max(max_err, err)
        results[label] = (ms, plain, bound, plan)

    # Every hit on the doubled mesh is its lower copy's.
    hits2 = raycast_sweep.raycast_hits(*scenes[3][1])
    if not bool((hits2.prim_id[hits2.valid] < len(rtris)).all()):
        fails.append("a hit on the doubled mesh is the upper copy's")
    # No ray of the turned-around frame hits.
    if bool(raycast_sweep.raycast_hits(*scenes[6][1]).valid.any()):
        fails.append("a turned-around ray hit the mesh")
    # One tracking frame's whole cast, as the tracker calls it: one kernel.
    mesh = Mesh.create(track["verts"], track["tris"], device=device)
    queued, ran, _ = device_work(lambda: R.raycast_grouped(mesh,
                                                           *frame[:2]))
    print(f"  a tracking frame's raycast_grouped: {len(queued)} launch(es), "
          f"copies and fills queued ({', '.join(queued)}); the device ran "
          f"{', '.join(f'{n[:60]} {ms:.4f} ms' for n, ms in ran) or 'none the profiler saw'}")
    if (len(queued) != 1 or not queued[0].startswith("cudaLaunchKernelEx")
            or any("hits_kernel" not in n for n, _ in ran)):
        fails.append(f"a tracking frame's cast queued {queued} and ran "
                     f"{ran}, want K5 alone")
    if fails:
        raise AssertionError("K5:\n" + "\n".join(fails))
    k5_tracking_turns(device, track, smi)
    return dict(max_abs_err=max_err, scenes=results,
                frame_step_kernels=len(queued))


# ---------------------------------------------------------------------------
# K6 phase
# ---------------------------------------------------------------------------

# f32 operations of the grid cast, as the walks of this run's data need them
# (their candidate tests and cell actions counted by ``grid_plain_counted``).
# A candidate test: two cross products (9 each: a product and an FMA a
# component), four sums of products (5 each), |det| and its compare (2),
# the reciprocal (1), o - p1 (3), three products by 1/det (3), u + v and
# five compares (6), the compare with the best t (1): 54.  A cell action:
# the exit's min (2) and its compare (1), the axis (2), the step and its
# bounds test (2), the tmax update (1), the flat index (4) and the
# boundary's subtraction (1): 13.  A ray: the grid's far corner (6), the
# slab (10 an axis), t0, t1, the start and the entry test (7), the start
# point and cell (7 an axis), the first boundaries, tmax and tdelta (7 an
# axis), the flat index (4): 89; its hit: the mask bit (3), e1 and e2 (6),
# the weights and the position (17), the normal (9 + 7 + 3): 45.
K6_OPS_TEST, K6_OPS_STEP, K6_OPS_RAY = 54, 13, 134
# K6 against K5 and the flat ``raycast``: tests/test_gridcast.py's
# tolerance (``_assert_hits_match``): the grid tests its candidates in the
# general Möller-Trumbore form, K5 in a factored one, the flat cast with
# the edges formed a chunk at a time, so t and the hit round differently.
K6_SWEEP_TOL = 1e-4
# A hit this close to its triangle's edge (in u, v or 1 - u - v) may fall
# on either side of it, or into neither neighbour, in another test form.
K6_EDGE = 1e-5
K6_SMALL_ITERS = 8


def k6_bound(n, accel, mesh, found, valid, check_mask, tests, steps):
    """K6 on ``n`` rays: the grid (``cell_start``, ``items``, the 48-byte
    triangle rows) and the rays read once; of the mesh, what the hits need
    read once: the mask word of each distinct closest triangle (``found``,
    before the mask test) where the mask is checked, and the indices (24
    bytes) and corners (12 bytes a vertex) of each distinct triangle hit
    (``valid``); the hits (45 bytes a ray) written once.  The operations
    of the ``tests`` candidate tests and ``steps`` cell actions this run's
    walks took, and of every ray."""
    from polychase_tpu_torch.engine.raycast import INVALID_ID

    hit = torch.unique(found[valid])
    corners = torch.unique(mesh.triangles[hit])
    words = (torch.unique(found[found != INVALID_ID] >> 5).numel()
             if check_mask else 0)
    nbytes = (4 * (accel.cell_start.numel() + accel.items.numel()
                   + accel.tri_rows.numel())
              + 24 * hit.numel() + 12 * corners.numel() + 8 * words
              + n * (24 + 45))
    return bound_ms(nbytes, tests * K6_OPS_TEST + steps * K6_OPS_STEP
                    + n * K6_OPS_RAY)


def k6_check(label, mesh, accel, o, d, plain_reps=1, **kw):
    """K6 against its plain version (``grid_plain``) on the card: every
    field of the hits to the bit, one launch counted by the wrapper and by
    the library; prints both times, the bound, its share and the walks'
    work.  Returns (failures, K6's hits, the largest difference in
    position, normal or barycentrics, kernel ms, plain ms, (bound ms, what
    bounds it), (tests, cell actions, lockstep iterations))."""
    from polychase_tpu_torch.engine.gridcast import grid_plain_counted
    from polychase_tpu_torch.kernels import grid_cast

    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    n = o.shape[0]
    before = (grid_cast.launches, grid_cast.cuda_launches())
    got = grid_cast.grid_hits(o, d, accel, *arrays, **kw)
    launched = (grid_cast.launches - before[0],
                grid_cast.cuda_launches() - before[1])
    want, tests, steps, its, found = grid_plain_counted(o, d, accel, *arrays,
                                                        **kw)
    torch.cuda.synchronize()
    fails = []
    if launched != (1, 1):
        fails.append(f"{label}: K6 launched {launched}, want one call and "
                     f"one CUDA launch")
    for f in HIT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a, b):
            rays = (a != b).reshape(n, -1).any(dim=1)
            fails.append(f"{label}: {f} differs from grid_plain's on "
                         f"{int(rays.sum())} of {n} rays")
    max_err = max([float((getattr(got, f) - getattr(want, f)).abs().max())
                   for f in ("pos", "normal", "barycentric") if n] + [0.0])
    ms = event_ms(lambda: grid_cast.grid_hits(o, d, accel, *arrays, **kw), 20)
    plain = event_ms(lambda: grid_plain_counted(o, d, accel, *arrays, **kw),
                     plain_reps)
    bound = k6_bound(n, accel, mesh, found, want.valid,
                     kw.get("check_mask", True), tests, steps)
    res = accel.res.tolist()
    threads = grid_cast.block_threads(n, grid_cast._sm_count(o.device))
    print(f"  {label} (N {n}, T {mesh.num_triangles}, grid {res}, "
          f"{accel.items.shape[0]} items, {kw or 'defaults'}; {threads} "
          f"threads a block): every field equal to grid_plain's: "
          f"{not fails}, {int(want.valid.sum())} hits; {tests} tests, "
          f"{steps} cell actions, {its} lockstep iterations; K6 {ms:.4f} "
          f"ms, plain {plain:.4f} ms; bound {bound[0]:.6f} ms "
          f"({bound[1]}), {bound[0] / ms:.4f} of it; launches "
          f"{launched[0]} (CUDA {launched[1]})")
    return fails, got, max_err, ms, plain, bound, (tests, steps, its)


def sweep_agreement(label, what, grid, other, grid_nm, other_nm):
    """K6's hits against another cast's (``what``: K5's, the flat
    ``raycast``'s) on the same rays: ``valid`` and ids equal but on exact-t
    ties and edges, t and positions within ``K6_SWEEP_TOL`` (rtol and
    atol).  A ray whose id or ``valid`` differs is a tie where both casts
    with the mask off (``grid_nm``, ``other_nm``) hit at one t, within the
    tolerance (two triangles at one distance, the grid's first in visiting
    order, the sweep's the lowest id), and an edge where either cast's hit
    lies within ``K6_EDGE`` of its triangle's edge (the two test forms'
    rounding puts the ray on either side of it, or through the crack
    between the neighbours).  Returns (failures, largest t or position
    difference, ties, edges)."""
    def on_edge(h):
        u, v = h.barycentric[:, 0], h.barycentric[:, 1]
        w = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        return h.valid & (w <= K6_EDGE)

    fails = []
    differ = (grid.valid != other.valid) | (grid.prim_id != other.prim_id)
    near = (grid_nm.t - other_nm.t).abs() <= K6_SWEEP_TOL * (
        1 + other_nm.t.abs())
    tie = differ & grid_nm.valid & other_nm.valid & near
    edge = differ & ~tie & (on_edge(grid) | on_edge(other) | on_edge(grid_nm)
                            | on_edge(other_nm))
    if bool((differ & ~tie & ~edge).any()):
        fails.append(f"{label}: valid or ids differ from {what}'s on "
                     f"{int((differ & ~tie & ~edge).sum())} rays that are "
                     f"neither a tie nor on an edge")
    both = grid.valid & other.valid & ~differ
    err = 0.0
    for f in ("t", "pos"):
        a, b = getattr(grid, f)[both], getattr(other, f)[both]
        if a.numel():
            err = max(err, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=K6_SWEEP_TOL, atol=K6_SWEEP_TOL):
                fails.append(f"{label}: {f} differs from {what}'s by more "
                             f"than {K6_SWEEP_TOL}")
    return fails, err, int(tie.sum()), int(edge.sum())


def k6_phase(device, track, refine, k5, smi):
    """K6 against its plain version, K5 and the flat ``raycast`` on the
    scenes of the module docstring (item 9), the grid module's entry
    points with their launches counted, and the builds timed.  Returns
    what the kernels line reports of K6."""
    from polychase_tpu_torch.engine import gridcast as GC
    from polychase_tpu_torch.engine.geometry import (
        Mesh, mask_array_size, set_mask_bits,
    )
    from polychase_tpu_torch.engine.raycast import raycast
    from polychase_tpu_torch.kernels import grid_cast, raycast_sweep
    from polychase_tpu_torch.synthetic import uv_sphere

    rng = np.random.default_rng(11)
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=device)

    def flat(o, d):
        return (o[:, None, :].expand(d.shape).reshape(-1, 3).contiguous(),
                d.reshape(-1, 3).contiguous())

    def from_sphere(n, radius, spread):
        o = rng.normal(size=(n, 3))
        o = radius * o / np.linalg.norm(o, axis=-1, keepdims=True)
        return o, rng.normal(0, spread, (n, 3)) - o

    frame, rsweep = track["sweep"], refine["sweep"]
    tmesh = Mesh.create(track["verts"], track["tris"], device=device)
    rmesh = Mesh.create(refine["verts"], refine["tris"], device=device)
    words = np.zeros(mask_array_size(len(refine["tris"])), np.uint32)
    for i in rng.choice(len(refine["tris"]), 40, replace=False):
        words = set_mask_bits(words, int(i), "mask")
    masked = Mesh.create(refine["verts"], refine["tris"], words,
                         device=device)
    n_tri = 20_000
    centers = rng.uniform(-2, 2, (n_tri, 1, 3))
    soup = Mesh.create((centers + rng.normal(0, 0.1, (n_tri, 3, 3))).reshape(
        -1, 3), np.arange(3 * n_tri).reshape(-1, 3), device=device)
    so, sd = from_sphere(8192, 6.0, 1.0)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    ao = np.concatenate([rng.uniform(-0.5, 0.5, (2048, 3)),
                         rng.uniform(-3, 3, (2048, 3))])
    ad = axes[rng.integers(0, 6, 4096)]
    hv, ht = uv_sphere(16, 24)
    hv = np.concatenate([hv, [[-50, -50, -2], [50, -50, -2], [0, 80, -2]]])
    ht = np.concatenate([ht, [[len(hv) - 3, len(hv) - 2, len(hv) - 1]]])
    huge = Mesh.create(hv, ht, device=device)
    ho, hd = from_sphere(4096, 8.0, 0.8)
    hd[:1024] = [0.1, 0.05, -1.0]
    empty = Mesh.create(np.zeros((0, 3)), np.zeros((0, 3)), device=device)

    grids, build_ms = {}, {}

    def accel(label, mesh):
        if id(mesh) not in grids:
            t0 = time.perf_counter()
            grids[id(mesh)] = GC.build_grid_accel(
                mesh.vertices, mesh.triangles, device=device)
            torch.cuda.synchronize()
            build_ms[label] = (time.perf_counter() - t0) * 1e3
        return grids[id(mesh)]

    # (label, mesh, flat rays, K5's grouped rays or None, keywords)
    scenes = [
        ("tracking frame", tmesh, flat(*frame[:2]), frame[:2], {}),
        ("config 4 refresh", rmesh, flat(*rsweep[:2]), rsweep[:2], {}),
        ("40 triangles masked", masked, flat(*rsweep[:2]), rsweep[:2], {}),
        ("soup of 20,000", soup, (dev(so), dev(sd)), None, {}),
        ("axis-aligned, inside", tmesh, (dev(ao), dev(ad)), None, {}),
        ("huge triangle", huge, (dev(ho), dev(hd)), None, {}),
        ("empty mesh", empty, (dev(ho[:1024]), dev(hd[:1024])), None, {}),
        (f"max_iters {K6_SMALL_ITERS}", tmesh, flat(*frame[:2]), None,
         dict(max_iters=K6_SMALL_ITERS)),
    ]
    fails, max_err, sweep_err, results = [], 0.0, 0.0, {}
    for label, mesh, (o, d), grouped, kw in scenes:
        acc = accel(label, mesh)
        f, got, err, ms, plain, bound, work = k6_check(label, mesh, acc, o,
                                                       d, **kw)
        fails += f
        max_err = max(max_err, err)
        results[label] = (ms, plain, bound, work)
        if kw or not mesh.num_triangles:
            if not mesh.num_triangles and bool(got.valid.any()):
                fails.append("a ray hit the empty mesh")
            continue
        arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
        nm = grid_cast.grid_hits(o, d, acc, *arrays, False)
        if grouped is None:
            grouped = (o, d[:, None, :].contiguous())
        k5_hits = [raycast_sweep.raycast_hits(*grouped, *arrays, m)
                   for m in (True, False)]
        k5_hits = [type(h)(*(getattr(h, f).reshape(o.shape[0], *getattr(
            h, f).shape[2:]) for f in HIT_FIELDS)) for h in k5_hits]
        flat_cast = [raycast(mesh, o, d, m) for m in (True, False)]
        notes = []
        for what, (other, other_nm) in (("K5", k5_hits),
                                        ("raycast", flat_cast)):
            f, err, ties, edges = sweep_agreement(label, what, got, other,
                                                  nm, other_nm)
            fails += f
            sweep_err = max(sweep_err, err)
            notes.append(f"{what}: max |t, pos diff| {err:.3g}, {ties} "
                         f"exact-t ties, {edges} on an edge")
        print(f"    against {'; '.join(notes)}")
    if fails:
        raise AssertionError("K6:\n" + "\n".join(fails))

    # The grid module's entry points, as a user calls them, counts at 0.
    grid_cast.launches = 0
    cuda0 = grid_cast.cuda_launches()
    taccel = GC.build_grid_accel(track["verts"], track["tris"],
                                 device=device)
    hits = GC.grid_raycast_grouped(tmesh, taccel, *frame[:2])
    rhits = GC.grid_raycast(rmesh, GC.build_grid_accel(
        refine["verts"], refine["tris"], device=device),
        *flat(*rsweep[:2]))
    torch.cuda.synchronize()
    launches = grid_cast.launches
    cuda = grid_cast.cuda_launches() - cuda0
    same = torch.equal(hits.prim_id.reshape(-1), grid_cast.grid_hits(
        *flat(*frame[:2]), taccel, tmesh.vertices, tmesh.triangles,
        tmesh.masked_triangles).prim_id) and bool(rhits.valid.any())
    print(f"  grid_raycast_grouped on a tracking frame and grid_raycast on "
          f"config 4's refresh: K6 launches {launches} (CUDA {cuda}); "
          f"the frame's ids equal K6's above: {same}; grid builds "
          f"(host, numpy) "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in build_ms.items()))
    if (launches, cuda) != (2, 2) or not same:
        raise AssertionError(f"K6: the grid module's entry points launched "
                             f"{launches} times (CUDA {cuda}), ids equal "
                             f"{same}")
    k5_frame = k5["scenes"]["tracking frame"][0]
    k6_frame = results["tracking frame"][0]
    print(f"  a tracking frame ({frame[1].shape[0] * frame[1].shape[1]} "
          f"rays, {tmesh.num_triangles} triangles): K6 {k6_frame:.4f} ms "
          f"against K5 {k5_frame:.4f} ms on {smi}")
    return dict(launches=launches, cuda_launches=cuda, scenes=results,
                max_abs_err=max_err, sweep_max_abs_err=sweep_err,
                threads=grid_cast.block_threads(
                    frame[1].shape[0] * frame[1].shape[1],
                    grid_cast._sm_count(device)),
                build_ms=build_ms["tracking frame"])


# ---------------------------------------------------------------------------
# Pin phase
# ---------------------------------------------------------------------------


def pin_phase(device):
    """Config 2's drags.  Returns the 8-pin ms per drag, K1's launches on
    the main path (the 20 drags and the 16,384-point one), and the largest
    pose difference of K1 against its plain version on the solver inputs
    of the drags that took the device route."""
    from polychase_tpu_torch import crossover
    from polychase_tpu_torch.engine import pinmode
    from polychase_tpu_torch.kernels import pnp_lm

    # The pins are cast on the host (a CPU copy of the mesh), not by K5.
    pins, scene = crossover.pin_scene(CPU, 8)
    big, _ = crossover.pin_scene(CPU, PIN_BIG, seed=1)
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
    return ms, launches, main_path_inputs_check(inputs)[0]


# ---------------------------------------------------------------------------
# Surface phase
# ---------------------------------------------------------------------------

# A worker thread with no done message after this long fails the run.
THREAD_DEADLINE_S = 300.0
SURFACE_PICKS = 64
# The facade adds no arithmetic to the engine calls it wraps.
SURFACE_ATOL = 1e-6


def drain(thread, frames=None, stop_after=None, pc=None):
    """Poll a worker thread of ``polychase_core`` (``pc``, by default the
    one ``import`` finds) until its done message, serving its frame
    requests from ``frames`` and asking it to stop once more than
    ``stop_after`` frames were requested.  Returns (its other messages, the
    exceptions it sent, the frames it requested)."""
    if pc is None:
        import polychase_tpu_torch.polychase_core as pc

    msgs, errors, requested = [], [], []
    deadline = time.monotonic() + THREAD_DEADLINE_S
    while True:
        msg = thread.try_pop()
        if msg is None:
            if time.monotonic() > deadline:
                thread.request_stop()
                raise AssertionError(
                    f"no done message within {THREAD_DEADLINE_S} s")
            time.sleep(0.001)
        elif isinstance(msg, bool):
            break
        elif isinstance(msg, Exception):
            errors.append(msg)
        elif isinstance(msg, pc.OpticalFlowRequest):
            requested.append(msg.frame_id)
            if stop_after is not None and len(requested) > stop_after:
                thread.request_stop()
            thread.provide_frame(msg.frame_id, frames[msg.frame_id])
        else:
            msgs.append(msg)
    thread.join()
    return msgs, errors, requested


def view_of(pose):
    """The view matrix of a (q, t) camera pose."""
    from polychase_tpu_torch.engine.pose import quat_to_mat_np

    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(pose[0])
    view[:3, 3] = pose[1]
    return view


def surface_phase(device, frames, analyze_db, track, refine, workdir, smi):
    """The earlier phases' data through ``polychase_core`` with no device
    argument: an ``OpticalFlowThread`` on the panning clip (the analyze
    gates, the rows of the direct run's DB, K2 and K3 once per level of
    every solve), a forward ``TrackerThread`` over the tracking clip (the
    ground truth, the direct run's poses, one K1 and one K5 launch a frame),
    a ``RefinerThread`` on config 4 (refine's gates), 20 8-pin drags and one
    16,384-point drag through ``find_transformation`` (the engine's result,
    K1 once per drag above ``HOST_PIN_MAX``), 64 ``ray_cast`` picks (the
    device ray cast's primitive ids), a ``CppException`` and a clean cancel;
    then tracking and analyze frames/s and the 8-pin drag's ms, direct and
    through the surface, in turns.  Returns the K1, K2 and K3 launches of
    its gated runs and what the add-on phase compares with: the thread's
    DB and the ``TrackerThread``'s poses by frame, with K5's launches in
    the ``TrackerThread``."""
    import polychase_tpu_torch.polychase_core as pc
    from polychase_tpu_torch import crossover
    from polychase_tpu_torch.backend import surface_devices
    from polychase_tpu_torch.engine import pinmode, raycast
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.opticalflow import (
        VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.kernels import (
        lk_iter, lk_prep, pnp_lm, raycast_sweep,
    )

    fails = []
    n = len(frames)
    height, width = frames[0].shape
    intrinsics = pc.CameraIntrinsics(FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0,
                                     WIDTH, HEIGHT, pc.CameraConvention.OpenCV)

    def analyze_thread(path):
        t0 = time.perf_counter()
        msgs, errors, requested = drain(
            pc.OpticalFlowThread(pc.VideoInfo(width, height, 0, n), path),
            frames)
        seconds = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return seconds, msgs, requested

    lk_prep.launches = lk_iter.launches = 0
    path = os.path.join(workdir, "surface_analyze.db")
    seconds, msgs, requested = analyze_thread(path)
    lk_launches = (lk_prep.launches, lk_iter.launches)
    kps, flows = read_analyze_db(path, n)
    # The thread takes every card. Config 1b's ~42.4k corners a frame take
    # the feature split, one shard a card, so every solve launches once per
    # level and card.
    cards = torch.cuda.device_count()
    levels, solves = analyze_solves(n, height, width)
    solves *= cards
    print(f"  OpticalFlowThread: {n} frames in {seconds:.3f} s, "
          f"{len(msgs)} progress messages, last {msgs[-1]}; K2 / K3 launches "
          f"{lk_launches[0]} / {lk_launches[1]} (= {solves} shards of solves "
          f"x {levels} levels, {cards} cards)")
    fails += analyze_gates(kps, flows, n)
    ref_kps, ref_flows = read_analyze_db(analyze_db, n)
    same_kps = all(np.array_equal(a, b) for a, b in zip(kps, ref_kps))
    same_kept = [k for k in flows if k in ref_flows and np.array_equal(
        flows[k].src_kps_indices, ref_flows[k].src_kps_indices)]
    dflow = max((float(np.abs(flows[k].tgt_kps - ref_flows[k].tgt_kps).max(
        initial=0.0)) for k in same_kept), default=0.0)
    print(f"  against the direct run's DB: keypoints "
          f"{'equal' if same_kps else 'DIFFER'}, {len(same_kept)} of "
          f"{len(ref_flows)} pairs keep the same flows, largest flow "
          f"difference on them {dflow:.3g} px")
    if not same_kps or set(flows) != set(ref_flows):
        fails.append("the thread's keypoints or pairs differ from the "
                     "direct analyze's")
    if requested != list(range(n)):
        fails.append(f"frames requested {requested}, want each once")
    if lk_launches != (levels * solves, levels * solves):
        fails.append(f"K2/K3 launched {lk_launches} times through the "
                     f"thread for {solves} solves of {levels} levels")

    poses = track["poses"]
    last = len(poses) - 1
    scene = pc.SceneTransformations(np.eye(4), view_of(poses[0]), intrinsics)
    accel = pc.AcceleratedMesh(track["verts"], track["tris"])

    def track_thread():
        t0 = time.perf_counter()
        results, errors, _ = drain(pc.TrackerThread(
            track["db"], 0, last, scene, accel, False, False,
            pc.BundleOptions()))
        seconds = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return results, seconds

    pnp_lm.launches = raycast_sweep.launches = 0
    results, seconds = track_thread()
    k1_track, k5_track = pnp_lm.launches, raycast_sweep.launches
    direct = {r.frame: (r.pose.q.numpy(), r.pose.t.numpy())
              for r in track["fwd"]}
    rot = max(quat_err(r.pose.q, poses[r.frame][0]) for r in results)
    terr = max(float(np.linalg.norm(r.pose.t - poses[r.frame][1]))
               for r in results)
    dpose = max(max(float(np.abs(r.pose.q - direct[r.frame][0]).max()),
                    float(np.abs(r.pose.t - direct[r.frame][1]).max()))
                for r in results)
    print(f"  TrackerThread: {len(results)} frames in {seconds:.3f} s, max "
          f"rot err {rot:.3g} rad, max t err {terr:.3g}; largest difference "
          f"from the direct run's poses {dpose:.3g}; K1 / K5 launches "
          f"{k1_track} / {k5_track}")
    if (k1_track, k5_track) != (last, last):
        fails.append(f"the TrackerThread launched K1 {k1_track} and K5 "
                     f"{k5_track} times for {last} frames")
    if [r.frame for r in results] != list(range(1, last + 1)):
        fails.append("the TrackerThread's frames are not 1..last")
    if rot > ROT_ERR_MAX or terr > T_ERR_MAX:
        fails.append("a TrackerThread pose is off the ground truth")
    if dpose > SURFACE_ATOL:
        fails.append(f"TrackerThread poses differ from the direct run's by "
                     f"{dpose:.3g}")
    if k1_track != last:
        fails.append(f"K1 launched {k1_track} times for {last} frames")

    rposes = refine["poses"]
    nf = len(rposes)
    start = refine["noisy"]()
    traj = pc.CameraTrajectory(0, nf)
    for i in range(nf):
        s = start.get(i)
        traj.set(i, pc.CameraState(intrinsics, pc.Pose(s.pose.q.numpy(),
                                                       s.pose.t.numpy())))

    def state(i):
        s = traj.get(i)
        return s.pose.q.copy(), s.pose.t.copy(), float(s.intrinsics.fy)

    ends = [state(i) for i in (0, nf - 1)]
    before = np.array([np.linalg.norm(state(i)[1] - rposes[i][1])
                       for i in range(nf)])
    opts = pc.BundleOptions()
    opts.loss_type = pc.LossType.Cauchy
    opts.max_iterations = REFINE_ITERS
    t0 = time.perf_counter()
    updates, errors, _ = drain(pc.RefinerThread(
        refine["db"], traj, np.eye(4, dtype=np.float32),
        pc.AcceleratedMesh(refine["verts"], refine["tris"]), True, False,
        opts))
    if errors:
        raise errors[0]
    print(f"  RefinerThread: config 4, {updates[-1].stats.iterations} "
          f"iterations in {time.perf_counter() - t0:.4f} s, "
          f"{len(updates)} updates")
    fails += refine_gates(state, rposes, ends, before, updates[-1].stats)

    pins, escene = crossover.pin_scene(CPU, 8)
    big, _ = crossover.pin_scene(CPU, PIN_BIG, seed=1)
    pscene = pc.SceneTransformations(np.eye(4), escene.view_matrix.numpy(),
                                     intrinsics)

    def drag(points, k):
        return pc.find_transformation(
            points, pscene, pscene,
            pc.PinUpdate(2, np.array([955.0 + k, 542.0], np.float32)),
            pc.TransformationType.Camera)

    pnp_lm.launches = 0
    t0 = time.perf_counter()
    outs = [drag(pins, k % 5) for k in range(PIN_REPS)]
    pin_ms = (time.perf_counter() - t0) * 1e3 / PIN_REPS
    out_big = drag(big, 0)
    k1_pin = pnp_lm.launches
    want = (PIN_REPS * (len(pins) > pinmode.HOST_PIN_MAX)
            + (len(big) > pinmode.HOST_PIN_MAX))
    dpin = 0.0
    for (points, k), out in ([((pins, k % 5), o) for k, o in enumerate(outs)]
                             + [((big, 0), out_big)]):
        ref = crossover.pin_drag(points, escene, k, device)
        for got, exp in ((out.view_matrix, ref.view_matrix),
                         (out.model_matrix, ref.model_matrix)):
            dpin = max(dpin, float(np.abs(got - exp.numpy()).max()))
    print(f"  find_transformation: 8-pin drag {pin_ms:.4f} ms ({PIN_REPS} "
          f"drags, {'device' if len(pins) > pinmode.HOST_PIN_MAX else 'host'}"
          f" route), one {PIN_BIG}-point drag; largest difference from the "
          f"engine's result {dpin:.3g}; K1 launches {k1_pin} (= {want} "
          f"drags above HOST_PIN_MAX = {pinmode.HOST_PIN_MAX})")
    if dpin > SURFACE_ATOL:
        fails.append(f"find_transformation differs from the engine by "
                     f"{dpin:.3g}")
    if k1_pin != want:
        fails.append(f"K1 launched {k1_pin} times for {want} device-route "
                     f"drags")

    view0 = view_of(poses[0]).astype(np.float64)
    # Pixels around the sphere's image (radius ~450 px), hits and misses.
    pix = np.random.default_rng(5).uniform((460, 40), (1460, 1040),
                                           (SURFACE_PICKS, 2))
    hits = [pc.ray_cast(accel, scene, p, False) for p in pix]
    inv = np.linalg.inv(view0)
    dirs = np.stack([(pix[:, 0] - WIDTH / 2) / FOCAL,
                     (pix[:, 1] - HEIGHT / 2) / FOCAL,
                     np.ones(SURFACE_PICKS)], -1) @ inv[:3, :3].T
    origins = np.broadcast_to(inv[:3, 3], dirs.shape)
    ref = raycast.raycast(
        Mesh.create(track["verts"], track["tris"], device=device),
        torch.as_tensor(origins.astype(np.float32), device=device),
        torch.as_tensor(dirs.astype(np.float32), device=device), False)
    ref_ids = ref.prim_id.cpu().numpy()
    got_ids = np.array([raycast.INVALID_ID if h is None else h.primitive_id
                        for h in hits])
    hit = [i for i, h in enumerate(hits) if h is not None]
    dpos = max((float(np.abs(hits[i].pos - ref.pos[i].cpu().numpy()).max())
                for i in hit), default=0.0)
    route = "host BVH" if accel._native_bvh() is not None else "device sweep"
    print(f"  ray_cast ({route}): {SURFACE_PICKS} picks, {len(hit)} hits; "
          f"primitive ids equal to the device ray cast's on "
          f"{int((got_ids == ref_ids).sum())}; largest hit difference "
          f"{dpos:.3g}")
    if not np.array_equal(got_ids, ref_ids):
        fails.append("ray_cast's primitive ids differ from the device ray "
                     "cast's")

    empty = os.path.join(workdir, "empty.db")
    pc.Database(empty).close()
    try:
        pc.track_sequence(empty, 0, 3, scene, accel, None)
        fails.append("a track on an empty DB raised nothing")
    except pc.CppException as exc:
        print(f"  track_sequence on an empty DB: CppException({exc.what()!r})")
    cancel = pc.OpticalFlowThread(pc.VideoInfo(width, height, 0, n),
                                  os.path.join(workdir, "cancel.db"))
    _, errors, requested = drain(cancel, frames, stop_after=3)
    print(f"  OpticalFlowThread stopped after {len(requested)} of {n} "
          f"frames requested, errors {errors}")
    if errors or not cancel.stopped or len(requested) >= n:
        fails.append("the OpticalFlowThread did not stop cleanly")
    if fails:
        raise AssertionError("surface:\n" + "\n".join(fails))

    # The surface's cost: direct, surface, surface, direct.
    engine_info = VideoInfo(width, height, 0, n)

    def analyze_direct(path):
        t0 = time.perf_counter()
        generate_optical_flow_database(engine_info, lambda f: frames[f], None,
                                       path, device=surface_devices(None))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def drags_ms(one):
        t0 = time.perf_counter()
        for k in range(PIN_REPS):
            one(k % 5)
        return (time.perf_counter() - t0) * 1e3 / PIN_REPS

    turns = {"tracking frames/s": [], "analyze frames/s": [],
             "8-pin drag ms": []}
    for i, how in enumerate(("direct", "surface", "surface", "direct")):
        if how == "direct":
            seconds = track["run"](track["db"], 0, last)[1]
        else:
            seconds = track_thread()[1]
        turns["tracking frames/s"].append((how, last / seconds))
        path = os.path.join(workdir, f"turn{i}.db")
        seconds = (analyze_direct(path) if how == "direct"
                   else analyze_thread(path)[0])
        turns["analyze frames/s"].append((how, n / seconds))
        turns["8-pin drag ms"].append((how, drags_ms(
            (lambda k: crossover.pin_drag(pins, escene, k, device))
            if how == "direct" else (lambda k: drag(pins, k)))))
    for what, runs in turns.items():
        print(f"  {what} (direct, through the surface, in turns): "
              + ", ".join(f"{how} {value:.4f}" for how, value in runs)
              + f" on {smi}")
    return k1_track + k1_pin, lk_launches, dict(
        db=path, poses={r.frame: (r.pose.q, r.pose.t) for r in results},
        k5_launches=k5_track)


# ---------------------------------------------------------------------------
# Segments phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def refine_records():
    """Record the accepted states of the refines run in the block, for
    :func:`refine_seq_gate`: yields ``(lock, seq)``.  ``lock`` gets, for
    each ``LockstepLM`` (one a ``refine_segments`` call on one device), its
    segments' lists of (t, prims), CPU copies of each segment's F stacked
    frames, at the start and after each step it took; ``seq`` gets, for
    each ``refine_trajectory`` call, the (t, prims) of each prim refresh,
    which it makes at the start and after each accepted step."""
    from polychase_tpu_torch.engine import refiner as R

    lock, seq = [], []
    real_iterate, real_make = R.LockstepLM.iterate, R._make_prim_refresher

    def iterate(self, scal_h):
        F = self.F
        rows = [slice(s * F, (s + 1) * F) for s in range(self.S)]
        if getattr(self, "_records", None) is None:
            self._records = [[(self.params.t[r].cpu(), self.prims[r].cpu())]
                             for r in rows]
            lock.append(self._records)
        before = self.params.t.clone()
        real_iterate(self, scal_h)
        for r, states in zip(rows, self._records):
            if not torch.equal(before[r], self.params.t[r]):
                states.append((self.params.t[r].cpu(), self.prims[r].cpu()))

    def make(*args, **kw):
        refresh, states = real_make(*args, **kw), []
        seq.append(states)

        def recorded(params):
            prims, cost = refresh(params)
            states.append((params.t.cpu(), prims.cpu()))
            return prims, cost
        return recorded

    R.LockstepLM.iterate, R._make_prim_refresher = iterate, make
    try:
        yield lock, seq
    finally:
        R.LockstepLM.iterate, R._make_prim_refresher = (real_iterate,
                                                        real_make)


def refine_seq_gate(lock_states, seq_states):
    """One segment of ``refine_segments`` against its sequential
    ``refine_trajectory``, from :func:`refine_records`' lists: the two
    paths' accepted states are walked in order, each held in t, up to and
    with the first whose refreshed prims differ (its t still came from the
    same prims; after it the two paths refine different problems, as the
    reference's rules have them do) or the shorter path's last (one path's
    tolerance stop).  Where neither comes first, the last states, the
    refined outputs, are held too.  Returns (the largest |dt| of the
    states held, the index of the first refresh whose prims differ or
    None, the share of the prims valid in either path that differ there
    (0 where none do), the lockstep's and the sequential path's accepted
    steps)."""
    dt, split, moved = 0.0, None, 0.0
    for j, ((ta, pa), (tb, pb)) in enumerate(zip(lock_states, seq_states)):
        n = tb.shape[0]
        dt = max(dt, float((ta[:n] - tb).abs().max()))
        pa = pa[:n]
        if not torch.equal(pa, pb):
            split = j
            moved = int((pa != pb).sum()) / max(1, int(((pa >= 0)
                                                        | (pb >= 0)).sum()))
            break
    return dt, split, moved, len(lock_states) - 1, len(seq_states) - 1


def refine_split_fails(label, split, moved):
    """The failures of a split that :func:`refine_seq_gate` reports: prims
    that differ at the start state, or more than ``REFINE_SPLIT_SHARE`` of
    them at the split."""
    fails = []
    if split == 0:
        fails.append(f"{label}: the prims differ at the start state")
    if moved > REFINE_SPLIT_SHARE:
        fails.append(f"{label}: {moved:.3g} of the prims differ at refresh "
                     f"{split}, over {REFINE_SPLIT_SHARE}")
    return fails


def segment_cost(db_path, traj, mesh, device, opts) -> float:
    """The refine cost of ``traj`` (its prims cast afresh), on ``device``."""
    from polychase_tpu_torch.engine import refiner as R
    from polychase_tpu_torch.io.database import Database

    db = Database(db_path)
    try:
        data = R.build_refiner_data(db, traj, mesh, np.eye(4), device=device)
    finally:
        db.close()
    eye = torch.eye(4, device=device)
    _, cost = R.refresh_prims_and_cost(
        R.traj_to_params(traj, device=device), data, mesh, eye, eye,
        mesh.triangle_corners(), opts.loss_scale, loss_type=opts.loss_type)
    return float(cost)


def segments_phase(device, track, refine, smi):
    """The segment-parallel paths on the tracking clip and config 4, direct
    and through ``polychase_core`` (module docstring, item 12).  Returns
    K1's launches in the gated ``track_segments`` run, K1's largest pose
    difference from its plain version on that path's recorded S = 4
    launches, and K5's launches in that run."""
    import polychase_tpu_torch.polychase_core as pc
    from polychase_tpu_torch.engine import refiner as R
    from polychase_tpu_torch.engine import tracker
    from polychase_tpu_torch.engine.camera import OPENCV, CameraState
    from polychase_tpu_torch.engine.camera import Intrinsics
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.levmarq import CAUCHY, BundleOptions
    from polychase_tpu_torch.engine.pose import Pose
    from polychase_tpu_torch.engine.trajectory import CameraTrajectory
    from polychase_tpu_torch.io.database import Database
    from polychase_tpu_torch.kernels import pnp_lm, raycast_sweep
    from polychase_tpu_torch.parallel.segments import refine_segments
    from polychase_tpu_torch.parallel.tracking import track_segments

    fails = []
    eye = np.eye(4, dtype=np.float32)
    intr = Intrinsics.create(FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0, WIDTH,
                             HEIGHT, OPENCV, device="cpu")

    def state(q, t):
        return CameraState(intr, Pose(torch.tensor(np.asarray(q, np.float32)),
                                      torch.tensor(np.asarray(t, np.float32))))

    # Tracking: four 30-frame segments of the tracking clip.
    poses = track["poses"]
    mesh = Mesh.create(track["verts"], track["tris"], device=device)
    track_opts = BundleOptions(loss_type=CAUCHY)  # track_segments' default
    steps = TRACK_SEGMENT - 1

    def seeded():
        out = []
        for a in TRACK_SEEDS:
            traj = CameraTrajectory(a, TRACK_SEGMENT)
            traj.set(a, state(*poses[a]))
            out.append(traj)
        return out

    def parallel_track():
        trajs = seeded()
        t0 = time.perf_counter()
        counts = track_segments(track["db"], trajs, eye, mesh,
                                bundle_opts=track_opts, device=device)
        return trajs, counts, time.perf_counter() - t0

    def sequential_track():
        trajs = seeded()
        t0 = time.perf_counter()
        db = Database(track["db"])
        try:
            for traj in trajs:
                a = traj.first_frame
                tracker.track_camera_trajectory(
                    db, traj, a, a + steps, eye, mesh,
                    bundle_opts=track_opts, device=device)
        finally:
            db.close()
        return trajs, time.perf_counter() - t0

    # Warm-up, recording K1's inputs on the path.
    inputs = []
    real = tracker.solve_arrays_lm

    def record(*args, **kw):
        inputs.append((args, kw))
        return real(*args, **kw)

    tracker.solve_arrays_lm = record
    try:
        parallel_track()
    finally:
        tracker.solve_arrays_lm = real
    seg_err, (k1_ms, k1_plain, _, _, got) = main_path_inputs_check(
        inputs, "track_segments")
    (S, N), kw = inputs[-1][0][0].shape[:2], inputs[-1][1]
    k1_b = k1_batch_bound(int(N), 9 if (kw["opt_f"] or kw["opt_pp"]) else 6,
                          got[:, 11].astype(int).tolist())
    print(f"  K1 at S = {S}, N = {N}: {k1_ms:.4f} ms a launch, "
          f"{k1_ms / S:.4f} ms a solve (plain {k1_plain:.4f} ms a launch); "
          f"bound {k1_b[0]:.6f} ms by {k1_b[1]}, {k1_b[0] / k1_ms:.4f} of it")
    if (S, len(inputs)) != (len(TRACK_SEEDS), steps):
        fails.append(f"track_segments launched {len(inputs)} solves of "
                     f"S = {S}, want {steps} of S = {len(TRACK_SEEDS)}")

    pnp_lm.launches = raycast_sweep.launches = 0
    trajs, counts, _ = parallel_track()
    launches, k5_launches = pnp_lm.launches, raycast_sweep.launches
    seq, _ = sequential_track()
    rot = terr = dq = dt = 0.0
    for a, b in zip(trajs, seq):
        for f in range(a.first_frame, a.last_frame + 1):
            sa, sb = a.get(f), b.get(f)
            q, t = sa.pose.q.numpy(), sa.pose.t.numpy()
            rot = max(rot, quat_err(q, poses[f][0]))
            terr = max(terr, float(np.linalg.norm(t - poses[f][1])))
            dq = max(dq, float(np.abs(q - sb.pose.q.numpy()).max()))
            dt = max(dt, float(np.abs(t - sb.pose.t.numpy()).max()))
    print(f"  track_segments: {len(TRACK_SEEDS)} segments x {steps} steps, "
          f"{int(counts.min())}-{int(counts.max())} correspondences a solve; "
          f"max rot err {rot:.3g} rad, max t err {terr:.3g}; against the "
          f"sequential tracks |dq| {dq:.3g}, |dt| {dt:.3g}; K1 / K5 "
          f"launches {launches} / {k5_launches} (= {steps} steps)")
    if (launches, k5_launches) != (steps, steps):
        fails.append(f"K1 and K5 launched {launches} and {k5_launches} "
                     f"times for {steps} steps")
    if counts.shape != (len(TRACK_SEEDS), steps) or (counts < 3).any():
        fails.append(f"track_segments counts {counts.shape}, min "
                     f"{int(counts.min())}")
    if rot > ROT_ERR_MAX or terr > T_ERR_MAX:
        fails.append("a track_segments pose is off the ground truth")
    if dq > Q_PAIR or dt > T_PAIR:
        fails.append(f"track_segments differs from the sequential tracks by "
                     f"{dq:.3g} (q) / {dt:.3g} (t)")

    # Refine: config 4 split at its keyframes, which are true.
    rposes = refine["poses"]
    rmesh = Mesh.create(refine["verts"], refine["tris"], device=device)
    ropts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                          max_iterations=REFINE_ITERS)
    start = refine["noisy"]()
    bounds = list(zip(REFINE_KEYS[:-1], REFINE_KEYS[1:]))

    def segments():
        out = []
        for a, b in bounds:
            traj = CameraTrajectory(a, b - a + 1)
            for f in range(a, b + 1):
                s = start.get(f)
                traj.set(f, state(*rposes[f]) if f in REFINE_KEYS else
                         CameraState(s.intrinsics, Pose(s.pose.q.clone(),
                                                        s.pose.t.clone())))
            out.append(traj)
        return out

    def parallel_refine():
        segs = segments()
        t0 = time.perf_counter()
        out = refine_segments(refine["db"], segs, eye, rmesh,
                              optimize_focal_length=True, bundle_opts=ropts,
                              device=device)
        torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    def sequential_refine():
        segs = segments()
        t0 = time.perf_counter()
        for traj in segs:
            R.refine_trajectory(refine["db"], traj, eye, rmesh,
                                optimize_focal_length=True,
                                bundle_opts=ropts, device=device)
        torch.cuda.synchronize(device)
        return segs, time.perf_counter() - t0

    banded = []
    real_band = R.damped_block_tridiag_solve
    R.damped_block_tridiag_solve = (
        lambda *a, **k: banded.append(k) or real_band(*a, **k))
    try:
        parallel_refine()
    finally:
        R.damped_block_tridiag_solve = real_band
    inputs = segments()
    with refine_records() as (lock, seq_states):
        out, _ = parallel_refine()
        seq, _ = sequential_refine()
    print(f"  refine_segments: {len(bounds)} segments of "
          f"{[b - a + 1 for a, b in bounds]} frames, the batched banded solve "
          f"{banded[0] if banded else 'NOT taken'}")
    if not banded or banded[0]["nb"] < 6:
        fails.append("refine_segments did not take the batched banded solve")

    def fields(traj, f):
        s = traj.get(f)
        return (s.pose.q.numpy(), s.pose.t.numpy(), float(s.intrinsics.fy))

    def mean_t_err(traj, frames, carried):
        return float(np.mean([translation_err(traj.get(f), rposes[f][1],
                                              carried) for f in frames]))

    dseq = 0.0
    for k, ((a, b), t_in, t_out, t_seq) in enumerate(zip(bounds, inputs, out,
                                                         seq)):
        frames = range(a, b + 1)
        # The focal is free, and the clip pins down depth only with it:
        # the refined translation is judged carried to the true focal, as
        # translation_err does for the free-intrinsics tracking run (the
        # start has the true focal, so there the two agree).
        before = mean_t_err(t_in, frames, False)
        raw, after = (mean_t_err(t_out, frames, c) for c in (False, True))
        c0 = segment_cost(refine["db"], t_in, rmesh, device, ropts)
        c1 = segment_cost(refine["db"], t_out, rmesh, device, ropts)
        d = max(float(np.abs(fields(t_out, f)[1] - fields(t_seq, f)[1]).max())
                for f in frames)
        held, split, moved, n_lock, n_seq = refine_seq_gate(lock[0][k],
                                                            seq_states[k])
        dseq = max(dseq, held)
        fails += refine_split_fails(f"segment {a}-{b}", split, moved)
        print(f"    segment {a}-{b}: cost {c0:.4f} -> {c1:.4f}, mean t err "
              f"{before:.3g} -> {after:.3g} ({after / before:.3f} of it; "
              f"{raw:.3g} before the focal trade-off); against the "
              f"sequential refine: accepted steps {n_lock} / {n_seq}, "
              f"prims first differ at refresh "
              f"{'none' if split is None else split} ({moved:.3g} of "
              f"them), |dt| {held:.3g} up to it ({d:.3g} at the end)")
        if not c1 < c0:
            fails.append(f"segment {a}-{b}: the cost did not fall")
        if not after < REFINE_T_SHARE * before:
            fails.append(f"segment {a}-{b}: mean t err {after:.3g} not below "
                         f"{REFINE_T_SHARE} x {before:.3g}")
        for f in (a, b):
            x, y = fields(t_in, f), fields(t_out, f)
            if not (np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                    and x[2] == y[2]):
                fails.append(f"segment {a}-{b}: anchor frame {f} moved")
    if len(lock) != 1 or len(seq_states) != len(bounds):
        fails.append(f"recorded {len(lock)} lockstep runs and "
                     f"{len(seq_states)} sequential refines")
    if dseq > REFINE_SEQ_ATOL:
        fails.append(f"refine_segments differs from the sequential refines "
                     f"by {dseq:.3g} before their prims part")

    # Through polychase_core, with no device argument.
    pintr = pc.CameraIntrinsics(FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0,
                                WIDTH, HEIGHT, pc.CameraConvention.OpenCV)

    def facade(traj, frames):
        ct = pc.CameraTrajectory(traj.first_frame, traj.count)
        for f in frames:
            s = traj.get(f)
            ct.set(f, pc.CameraState(pintr, pc.Pose(s.pose.q.numpy(),
                                                    s.pose.t.numpy())))
        return ct

    def diff(cts, engine):
        return max(max(float(np.abs(ct.get(f).pose.q
                                    - e.get(f).pose.q.numpy()).max()),
                       float(np.abs(ct.get(f).pose.t
                                    - e.get(f).pose.t.numpy()).max()))
                   for ct, e in zip(cts, engine)
                   for f in range(e.first_frame, e.last_frame + 1))

    if pc.device_count() != torch.cuda.device_count():
        fails.append(f"device_count() {pc.device_count()}")
    cts = [facade(t, [t.first_frame]) for t in seeded()]
    pnp_lm.launches = 0
    pc_counts = pc.track_segments(track["db"], cts, eye,
                                  pc.AcceleratedMesh(track["verts"],
                                                     track["tris"]))
    d_track = diff(cts, trajs)
    rts = [facade(t, range(t.first_frame, t.last_frame + 1))
           for t in segments()]
    ropts_pc = pc.BundleOptions()
    ropts_pc.loss_type = pc.LossType.Cauchy
    ropts_pc.max_iterations = REFINE_ITERS
    msgs, errors, _ = drain(pc.RefineSegmentsThread(
        refine["db"], rts, eye, pc.AcceleratedMesh(refine["verts"],
                                                   refine["tris"]),
        True, False, ropts_pc))
    if errors:
        raise errors[0]
    d_refine = diff(rts, out)
    print(f"  polychase_core: device_count() {pc.device_count()}; "
          f"track_segments counts equal: "
          f"{np.array_equal(pc_counts, counts)}, poses within {d_track:.3g} "
          f"of the engine's, K1 launches {pnp_lm.launches}; "
          f"RefineSegmentsThread messages {[m.message for m in msgs]}, poses "
          f"within {d_refine:.3g} of the engine's")
    if not np.array_equal(pc_counts, counts) or d_track > SURFACE_ATOL:
        fails.append("pc.track_segments differs from the engine call")
    if len(msgs) != 1 or d_refine > SURFACE_ATOL:
        fails.append("RefineSegmentsThread differs from the engine call")
    if fails:
        raise AssertionError("segments:\n" + "\n".join(fails))

    # Sequential against segment-parallel, in turns.
    frames = len(TRACK_SEEDS) * steps
    turns = {"tracking frames/s": [], "refine s": []}
    for how in ("sequential", "parallel", "parallel", "sequential"):
        seconds = (sequential_track()[1] if how == "sequential"
                   else parallel_track()[2])
        turns["tracking frames/s"].append((how, frames / seconds))
        turns["refine s"].append((how, (sequential_refine() if how ==
                                        "sequential" else
                                        parallel_refine())[1]))
    for what, runs in turns.items():
        n = frames if what.startswith("track") else REFINE_KEYS[-1] + 1
        print(f"  {what} ({n} "
              f"frames; sequential, segment-parallel, in turns): "
              + ", ".join(f"{how} {value:.4f}" for how, value in runs)
              + f" on {smi}")
    return launches, seg_err, k5_launches


# ---------------------------------------------------------------------------
# Sharded phase
# ---------------------------------------------------------------------------

# The split analyze against the one-device DB: equal to the bit, or failing
# that, the same kept flows within this many px.
SHARD_POS_ATOL = 1e-4
# The sharded normal equations (tests/test_sharded.py:67-78).
SHARD_JTJ_RTOL, SHARD_JTJ_ATOL = 1e-3, 1e-5
# The sharded refine against the one-device refine: the same iterations,
# the final cost within this relative difference and every pose within
# this many rad and scene units. The two differ only in the order the
# normal equations are summed (poses 5.25e-6 apart on an H100 80GB HBM3,
# two shards on one card).  On config 4's DB cast on the card; on the one
# cast on the host the two refines accept the same 4 steps, their prims
# part at the last refresh and one stops an iteration later (4 against 5),
# which this gate does not allow for (ROADMAP, Queue 3).
SHARD_COST_RTOL = 1e-4
SHARD_POSE = 1e-4


def shard_devices():
    """Every card when there are two or more; else two shards on card 0,
    which run the split but measure no scaling."""
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)], True
    return [torch.device("cuda", 0)] * 2, False


def kernel_device_ms(fn, names, reps=3):
    """The device time (ms) of the kernels whose names contain each of
    ``names``, per run of ``fn``, over ``reps`` runs under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in e.name():
                    out[name] += (e.end_ns() - e.start_ns()) / 1e6 / reps
    return out


def same_solve(got, ref):
    """Largest position difference of a split solve from the one-device
    solve on the pairs both keep, and whether status, positions and err are
    equal to the bit."""
    bits = all(torch.equal(a, b) for a, b in zip(got, ref))
    both = got[1] & ref[1]
    dpos = float((got[0] - ref[0]).abs()[both].max()) if bool(both.any()) \
        else 0.0
    return bits, bool(torch.equal(got[1], ref[1])), dpos


def sharded_phase(device, frames, analyze_db, refine, smi):
    """Analyze and refine split over several devices (module docstring,
    item 13).  Returns the K2 and K3 launches of the gated split analyze."""
    from polychase_tpu_torch.engine import lk
    from polychase_tpu_torch.engine import refiner as R
    from polychase_tpu_torch.engine.camera import CameraState
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.gftt import good_features_to_track
    from polychase_tpu_torch.engine.levmarq import CAUCHY, BundleOptions
    from polychase_tpu_torch.engine.opticalflow import (
        IMAGE_SKIPS, VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.engine.pose import Pose
    from polychase_tpu_torch.engine.trajectory import CameraTrajectory
    from polychase_tpu_torch.io.database import Database
    from polychase_tpu_torch.kernels import lk_iter, lk_prep
    from polychase_tpu_torch.parallel.analyze import (
        sharded_lk_multi, sharded_lk_multi_feat,
    )
    from polychase_tpu_torch.parallel import mesh_on
    from polychase_tpu_torch.parallel.raycast import (
        sharded_raycast_flat, split_cast,
    )
    from polychase_tpu_torch.parallel.sharded import EdgeShards

    fails = []
    devices, cards = shard_devices()
    print(f"  devices: {[str(d) for d in devices]} "
          + ("(every card)" if cards else
             "(two shards on the one card: this runs the split, the "
             "per-shard launches and the sum, and measures no scaling)"))
    n = len(frames)
    height, width = frames[0].shape
    info = VideoInfo(width, height, 0, n)
    workdir = os.path.dirname(analyze_db)

    def analyze(path, on):
        t0 = time.perf_counter()
        generate_optical_flow_database(info, lambda f: frames[f], None, path,
                                       device=on)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # Analyze over the devices, against the analyze phase's one-device DB.
    lk_prep.launches = lk_iter.launches = 0
    split_db = os.path.join(workdir, "sharded_analyze.db")
    seconds = analyze(split_db, devices)
    launches = (lk_prep.launches, lk_iter.launches)
    kps, flows = read_analyze_db(split_db, n)
    ref_kps, ref_flows = read_analyze_db(analyze_db, n)
    # Every frame keeps over FEAT_SHARD_MIN corners, so every solve splits
    # by features, one shard a device, each shard launching K2 and K3 once
    # a level.
    levels, solves = analyze_solves(n, height, width)
    n_shards = solves * len(devices)
    routes = {lk.split_route(k.shape[0], 8, len(devices)) for k in ref_kps}
    same_kps = all(np.array_equal(a, b) for a, b in zip(kps, ref_kps))
    same_kept = all(np.array_equal(flows[k].src_kps_indices,
                                   ref_flows[k].src_kps_indices)
                    for k in ref_flows if k in flows)
    dflow = max((float(np.abs(flows[k].tgt_kps - ref_flows[k].tgt_kps).max(
        initial=0.0)) for k in ref_flows if k in flows), default=0.0)
    print(f"  analyze over the devices: {n} frames in {seconds:.3f} s, "
          f"route {sorted(routes)} (corners per frame "
          f"{min(k.shape[0] for k in ref_kps)}.."
          f"{max(k.shape[0] for k in ref_kps)}, FEAT_SHARD_MIN "
          f"{lk.FEAT_SHARD_MIN}); K2 / K3 launches {launches[0]} / "
          f"{launches[1]} (= {n_shards} shards of solves x {levels} levels); "
          f"against the one-device DB: keypoints "
          f"{'equal' if same_kps else 'DIFFER'}, kept flows "
          f"{'the same' if same_kept else 'DIFFER'}, largest flow "
          f"difference {dflow:.3g} px"
          + (" (equal to the bit)" if dflow == 0.0 else ""))
    if routes != {"features"}:
        fails.append(f"the split analyze's solves took {sorted(routes)}, "
                     f"want the feature split")
    if launches != (levels * n_shards,) * 2:
        fails.append(f"K2/K3 launched {launches} times, want "
                     f"{levels * n_shards}")
    if not same_kps or set(flows) != set(ref_flows) or not same_kept:
        fails.append("the split analyze's keypoints, pairs or kept flows "
                     "differ from the one-device analyze's")
    if dflow > SHARD_POS_ATOL:
        fails.append(f"the split analyze's flows differ by {dflow:.3g} px")

    # One interior source frame's solve (T = 8), split by targets and by
    # features, against the one-device solve on the same inputs.
    opts = lk.LKOptions()
    pts, _ = good_features_to_track(frames[PAN_SOURCE], device=device)
    pts = torch.as_tensor(lk._spatial_sort(pts)[0], device=device)
    src = lk.prepare_pyramid(frames[PAN_SOURCE], opts, device=device)
    tgts = [lk.prepare_pyramid(frames[PAN_SOURCE + s], opts, device=device)
            for s in IMAGE_SKIPS]
    stacked = [torch.stack([t.levels[lvl][0] for t in tgts])
               for lvl in range(src.num_levels)]
    args = (src.levels, stacked, pts, float(opts.term_epsilon ** 2),
            float(opts.min_eigen_threshold))
    kw = dict(win=opts.window_size, max_iters=opts.term_max_iters,
              levels=src.num_levels)
    solves = {"one device": lambda: lk._lk_all_levels_multi(*args, **kw),
              "targets": lambda: sharded_lk_multi(devices, *args, **kw),
              "features": lambda: sharded_lk_multi_feat(devices, *args, **kw)}
    ref = solves["one device"]()
    for name in ("targets", "features"):
        bits, status, dpos = same_solve(solves[name](), ref)
        print(f"  source frame {PAN_SOURCE}, {pts.shape[0]} corners x "
              f"{len(tgts)} targets split by {name}: "
              + ("equal to the bit" if bits else
                 f"status {'equal' if status else 'DIFFERS'}, largest "
                 f"position difference {dpos:.3g} px"))
        if not bits and (not status or dpos > SHARD_POS_ATOL):
            fails.append(f"the solve split by {name} differs from the "
                         f"one-device solve ({dpos:.3g} px)")
    # In turns: one device, targets, features, features, targets, one.
    for name in ("one device", "targets", "features", "features", "targets",
                 "one device"):
        fn = solves[name]
        ms = event_ms(fn, 5)
        k = kernel_device_ms(fn, ("lk_prep_kernel", "lk_iter_kernel"))
        print(f"    {name}: {ms:.4f} ms a solve (CUDA events); device time "
              f"of K2 {k['lk_prep_kernel']:.4f} ms, K3 "
              f"{k['lk_iter_kernel']:.4f} ms a solve (all levels, every "
              f"shard; profiler, 3 solves)")
    if devices[-1] != devices[0]:
        # What a solve copies to another card under the feature split: the
        # source levels and every target's levels.
        moved = [t for lv in src.levels for t in lv[:3]] + stacked
        nbytes = sum(t.numel() * 4 for t in moved)
        ms = event_ms(lambda: [t.to(devices[-1]) for t in moved], 5)
        print(f"  a solve's levels to {devices[-1]} ({nbytes} bytes): "
              f"{ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s")
    else:
        print("  a solve's levels to the other shard: none, both shards are "
              f"on {devices[0]} (not measured)")

    # Refine, config 4, over the devices, on the clip cast on the card.
    refine_db = refine["card_db"](os.path.join(workdir, "refine_card.db"))
    poses = refine["poses"]
    nf = len(poses)
    mesh = Mesh.create(refine["verts"], refine["tris"], device=device)
    ropts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                          max_iterations=REFINE_ITERS)
    start = refine["noisy"]()
    eye4 = np.eye(4, dtype=np.float32)

    def copy(traj):
        out = CameraTrajectory(0, nf)
        for i in range(nf):
            s = traj.get(i)
            out.set(i, CameraState(s.intrinsics, Pose(s.pose.q.clone(),
                                                      s.pose.t.clone())))
        return out

    def refined(on, callback=None):
        traj = copy(start)
        t0 = time.perf_counter()
        R.refine_trajectory(refine_db, traj, eye4, mesh,
                            optimize_focal_length=True, callback=callback,
                            bundle_opts=ropts, device=on)
        torch.cuda.synchronize()
        return traj, time.perf_counter() - t0

    db = Database(refine_db)
    try:
        data = R.build_refiner_data(db, start, mesh, eye4, device=device)
    finally:
        db.close()
    params = R.traj_to_params(start, device=device)
    eye = torch.eye(4, device=device)
    tri = mesh.triangle_corners()
    prims = R.refresh_prims(params, data, mesh, eye)
    # The refresh refine_trajectory runs on the devices (the frames' ray
    # groups split over them), and the ported flat cast (each ray a group
    # of one), against the one-device refresh.
    routed = "host BVH" if R._refresh_routing(mesh) else "device sweep"
    split_prims = R._make_prim_refresher(data, mesh, eye, eye, tri, 1.0,
                                         CAUCHY, devices=devices)(params)[0]
    F, K = data.kp_valid.shape
    origin_o, dir_o = R._all_rays(params, data, eye)
    o_flat = origin_o[:, None, :].expand(F, K, 3).reshape(-1, 3)
    d_flat = dir_o.reshape(-1, 3)
    hits = sharded_raycast_flat(devices, mesh, o_flat, d_flat)
    flat = torch.where(hits.valid.reshape(F, K) & data.kp_valid,
                       hits.prim_id.reshape(F, K), -1)
    same_prims = (bool(torch.equal(split_prims, prims)),
                  bool(torch.equal(flat, prims)))
    meshes = [mesh_on(mesh, d) for d in devices]
    cast_ms = (event_ms(lambda: R.refresh_prims(params, data, mesh, eye), 5),
               event_ms(lambda: split_cast(devices, meshes, origin_o, dir_o),
                        5),
               event_ms(lambda: sharded_raycast_flat(devices, meshes, o_flat,
                                                     d_flat), 5))
    nkw = dict(loss_type=CAUCHY, opt_f=True, opt_pp=False, ppc=9)
    edges = EdgeShards(devices, data, tri, eye, eye)
    split_ne = edges.normal_equations(params, prims, 1.0, **nkw)
    one_ne = R.build_normal_equations(params, data, prims, tri, eye, eye,
                                      1.0, **nkw)
    rel = []
    for got, want in zip(split_ne, one_ne):
        excess = ((got - want).abs() - SHARD_JTJ_RTOL * want.abs()
                  - SHARD_JTJ_ATOL * float(want.abs().max()))
        rel.append(float((got - want).abs().max() / want.abs().max()))
        if float(excess.max()) > 0:
            fails.append("the sharded normal equations differ from "
                         "build_normal_equations beyond rtol 1e-3, atol "
                         "1e-5 x max")
    ne_ms = (event_ms(lambda: R.build_normal_equations(
        params, data, prims, tri, eye, eye, 1.0, **nkw), 5),
        event_ms(lambda: edges.normal_equations(params, prims, 1.0, **nkw), 5))
    P = split_ne[0].shape[0]
    print(f"  refine, config 4 (P = {P}, {int(data.src_frame.shape[0])} "
          f"edges): the split prim refresh ({routed}) "
          f"{'equal to' if same_prims[0] else 'DIFFERS from'} refresh_prims', "
          f"sharded_raycast_flat's prims "
          f"{'equal' if same_prims[1] else 'DIFFER'} (the cast "
          f"{cast_ms[0]:.4f} ms grouped on one device, {cast_ms[1]:.4f} ms "
          f"grouped and split, {cast_ms[2]:.4f} ms flat and split); the "
          f"sharded system's largest difference from build_normal_equations "
          f"{rel[0]:.3g} (JtJ) / {rel[1]:.3g} (Jtr) of the largest entry; "
          f"the build {ne_ms[0]:.4f} ms on one device, {ne_ms[1]:.4f} ms "
          f"split")
    if not same_prims[0]:
        fails.append("the split prim refresh differs from refresh_prims'")
    if not same_prims[1]:
        fails.append("sharded_raycast_flat's prims differ from refresh_prims'")
    part = split_ne[0].to(devices[-1])
    if devices[-1] != devices[0]:
        copy_ms = event_ms(lambda: part.to(devices[0]), 10)
        peer = torch.cuda.can_device_access_peer(devices[0].index,
                                                 devices[-1].index)
        print(f"  the per-rebuild copy of a partial JtJ ({part.numel() * 4} "
              f"bytes) from {devices[-1]} to {devices[0]}: {copy_ms:.4f} ms, "
              f"{part.numel() * 4 / copy_ms / 1e6:.1f} GB/s; peer access "
              f"{peer}")
    else:
        print(f"  the per-rebuild copy of a partial JtJ ({part.numel() * 4} "
              f"bytes): none, both shards are on {devices[0]} (not measured)")

    updates, one_updates = [], []
    split, _ = refined(devices, lambda u: updates.append(u) or True)
    one, _ = refined(device, lambda u: one_updates.append(u) or True)

    def state(i):
        s = split.get(i)
        return (s.pose.q.numpy().copy(), s.pose.t.numpy().copy(),
                float(s.intrinsics.fy))

    ends = [(start.get(i).pose.q.numpy().copy(),
             start.get(i).pose.t.numpy().copy(),
             float(start.get(i).intrinsics.fy)) for i in (0, nf - 1)]
    before = np.array([np.linalg.norm(start.get(i).pose.t.numpy()
                                      - poses[i][1]) for i in range(nf)])
    stats, one_stats = updates[-1].stats, one_updates[-1].stats
    iters = (int(stats.iterations), int(one_stats.iterations))
    dcost = abs(float(stats.cost) - float(one_stats.cost)) / abs(
        float(one_stats.cost))
    print(f"  refine over the devices: {iters[0]} iterations (one device "
          f"{iters[1]}), final cost {float(stats.cost):.6g} (one device "
          f"{float(one_stats.cost):.6g}, relative difference {dcost:.3g})")
    fails += refine_gates(state, poses, ends, before, stats)
    drot = max(quat_err(split.get(i).pose.q.numpy(), one.get(i).pose.q.numpy())
               for i in range(nf))
    dt = max(float(np.linalg.norm(split.get(i).pose.t.numpy()
                                  - one.get(i).pose.t.numpy()))
             for i in range(nf))
    print(f"  against the one-device refine: max rot {drot:.3g} rad, max "
          f"|dt| {dt:.3g}")
    if iters[0] != iters[1]:
        fails.append(f"the sharded refine took {iters[0]} iterations, the "
                     f"one-device refine {iters[1]}")
    if dcost > SHARD_COST_RTOL:
        fails.append(f"the sharded refine's final cost differs from the "
                     f"one-device refine's by {dcost:.3g} (relative)")
    if drot > SHARD_POSE or dt > SHARD_POSE:
        fails.append(f"the sharded refine differs from the one-device "
                     f"refine by {drot:.3g} rad / {dt:.3g}")
    if fails:
        raise AssertionError("sharded:\n" + "\n".join(fails))

    # One device against the device list, in turns.
    turns = {"analyze frames/s": [], "refine s": []}
    for i, how in enumerate(("one device", "split", "split", "one device")):
        on = device if how == "one device" else devices
        turns["analyze frames/s"].append((how, n / analyze(
            os.path.join(workdir, f"sharded_turn{i}.db"), on)))
        turns["refine s"].append((how, refined(on)[1]))
    for what, runs in turns.items():
        print(f"  {what} (one device, split over {len(devices)} shards, in "
              f"turns): " + ", ".join(f"{how} {value:.4f}"
                                      for how, value in runs)
              + f" on {smi}")
    return launches


# ---------------------------------------------------------------------------
# Analyze-routes phase: GFTT's device suppression (K4), the chained fan
# ---------------------------------------------------------------------------

K4_DISCS = (1.0, 2.5, 5.0, 8.0)
# Frame sizes of the suppression crossover (host route against device).
ROUTE_SIZES = ((80, 60), (160, 120), (320, 240), (640, 480), (1280, 720),
               (1920, 1080), (3840, 2160))
ROUTE_REPS = 5
# gftt.DEVICE_SUPPRESS_MIN above any frame: every frame on the host route.
HOST_ONLY = 1 << 62
CHAIN_MEDIAN_MAX = 0.05   # px, tests/test_opticalflow.py:119-170's gates
CHAIN_AGREE_MIN = 0.97


def k4_bound(h, w, rounds):
    """K4 on one frame: the quality map read once and the kept map written
    once; one state compare a pixel and pass for the rounds it ran."""
    return bound_ms(h * w * (4 + 1), 2.0 * rounds * h * w)


def gftt_route_ms(img, device, host: bool, reps=ROUTE_REPS):
    """Wall ms of one frame's GFTT (dispatch and finish, the frame already
    on the card) on the host route or the device route."""
    from polychase_tpu_torch.engine import gftt

    saved = gftt.DEVICE_SUPPRESS_MIN
    gftt.DEVICE_SUPPRESS_MIN = HOST_ONLY if host else 0
    try:
        def run():
            return gftt.gftt_finish(gftt.gftt_dispatch(img, device=device))

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps
    finally:
        gftt.DEVICE_SUPPRESS_MIN = saved


def chain_gates(kps, flows, ref_kps, ref_flows):
    """The chained DB against the unchained one: the same keypoints and
    pairs and, on the pairs of skips ±1 and ±2 (inside LK's basin on this
    clip; at ±4 and ±8 the unchained solve leaves it and the chained one,
    seeded, need not), tests/test_opticalflow.py:119-170's gates: each
    pair's flows kept by both within a median CHAIN_MEDIAN_MAX px, and
    over those pairs more than CHAIN_AGREE_MIN of the flows kept by both.
    Returns (agreement, largest median, failures)."""
    fails = []
    if not all(np.array_equal(a, b) for a, b in zip(kps, ref_kps)):
        fails.append("chained keypoints differ from the unchained DB's")
    if set(flows) != set(ref_flows):
        fails.append("chained pairs differ from the unchained DB's")
    agree = total = 0
    worst = 0.0
    for (f, g), fu in ref_flows.items():
        fc = flows.get((f, g))
        if fc is None or abs(g - f) > 2:
            continue
        ic = dict(zip(fc.src_kps_indices.tolist(), fc.tgt_kps))
        iu = dict(zip(fu.src_kps_indices.tolist(), fu.tgt_kps))
        shared = sorted(set(ic) & set(iu))
        total += max(len(ic), len(iu))
        agree += len(shared)
        if shared:
            d = np.linalg.norm(np.array([ic[i] - iu[i] for i in shared]),
                               axis=1)
            worst = max(worst, float(np.median(d)))
    share = agree / max(total, 1)
    if worst >= CHAIN_MEDIAN_MAX:
        fails.append(f"a pair's chained flows lie a median {worst:.3g} px "
                     f"from the unchained ones")
    if share <= CHAIN_AGREE_MIN:
        fails.append(f"only {share:.4f} of the flows kept by both runs")
    return share, worst, fails


def routes_phase(device, frames, analyze_db, smi):
    """GFTT's device suppression route and the chained skip fan (module
    docstring, item 14).  Returns K4's comparison results and the launches
    of the gated chained runs."""
    from polychase_tpu_torch.engine import gftt, lk
    from polychase_tpu_torch.engine.opticalflow import (
        IMAGE_SKIPS, VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.kernels import gftt_suppress, lk_iter, lk_prep
    from polychase_tpu_torch.synthetic import panning_clip

    fails = []
    n = len(frames)
    height, width = frames[0].shape
    opts = gftt.GFTTOptions()
    print(f"  device route from {gftt.DEVICE_SUPPRESS_MIN} pixels "
          f"(gftt.DEVICE_SUPPRESS_MIN), min_distance "
          f"{opts.min_distance:g}; frames resumed on the card so far "
          f"{gftt.resumed_frames}")

    # K4 against its plain version (suppress_plain + _compact_kept): the
    # clip's response maps (every 4th frame) and one 4K noise frame, at
    # each disc: the kept map, the kept list, rounds and converged.
    big = panning_clip(np.random.default_rng(5), 1, 3840, 2160,
                       PAN_STEP)[0]
    images = [("clip frame %d" % f, frames[f]) for f in range(0, n, 4)]
    images.append(("4K noise frame", big))
    k4_err = 0.0
    for name, frame in images:
        img = torch.as_tensor(frame, device=device)
        eig, cand = gftt.gftt_response(img.to(torch.float32), None,
                                       opts.quality_level, opts.harris_k)
        q = torch.where(cand, eig, 0.0).contiguous()
        h, w = frame.shape
        line = []
        for d in K4_DISCS:
            offs = gftt._circle_offsets(d)
            k = gftt.kept_capacity(h, w, d)
            got = gftt_suppress.gftt_suppress_kept(q, offs, k)
            ref = gftt.suppress_plain(q, offs)
            want = gftt._compact_kept(q, ref[0], k)
            same = (torch.equal(got[5] >= 2, ref[0]) and all(
                torch.equal(a, b) for a, b in zip(got[:3], want)))
            k4_err = max(k4_err, float(((got[5] >= 2).float()
                                        - ref[0].float()).abs().max()),
                         float((got[0] - want[0]).abs().max()))
            conv = (bool(got[3]), bool(ref[1]))
            agree = same and conv == (True, True) and int(got[4]) == int(
                ref[2])
            line.append(f"d {d:g}: {int(got[2])} kept, {int(got[4])} "
                        f"rounds" + ("" if agree else " (DIFFERS)"))
            if not agree:
                fails.append(f"K4 vs plain on {name} at d {d:g}: kept map "
                             f"and list {'equal' if same else 'DIFFER'}, "
                             f"converged {conv}, rounds {int(got[4])} / "
                             f"{int(ref[2])}")
        print(f"  K4 vs plain, {name} ({int(cand.sum())} candidates; kept "
              f"maps, kept lists, rounds and converged): " + "; ".join(line))
        # The device route's corners against the host route's, at every
        # disc: equal, in the same order.
        corners = {}
        for d in K4_DISCS:
            o = opts._replace(min_distance=d)
            saved = gftt.DEVICE_SUPPRESS_MIN
            try:
                gftt.DEVICE_SUPPRESS_MIN = 0
                dev_pts, dev_q = gftt.good_features_to_track(
                    img, None, o, device=device)
                gftt.DEVICE_SUPPRESS_MIN = HOST_ONLY
                host_pts, host_q = gftt.good_features_to_track(
                    img, None, o, device=device)
            finally:
                gftt.DEVICE_SUPPRESS_MIN = saved
            corners[d] = dev_pts.shape[0]
            if not (np.array_equal(dev_pts, host_pts)
                    and np.array_equal(dev_q, host_q)):
                fails.append(f"device-route corners differ from the host "
                             f"route's on {name} at d {d:g}")
        print(f"    device-route corners (equal to the host route's unless "
              f"a failure says so): {corners}; the kept buffer at d 5 holds "
              f"{gftt.kept_capacity(h, w, 5.0)}")
    # K4 timed on a clip frame at the default disc, as the main path calls
    # it; its floor (the same frame at d 1: one round, no neighbour reads)
    # and its plain version.
    img = torch.as_tensor(frames[PAN_SOURCE], device=device)
    eig, cand = gftt.gftt_response(img.to(torch.float32), None,
                                   opts.quality_level, opts.harris_k)
    q = torch.where(cand, eig, 0.0).contiguous()
    offs = gftt._circle_offsets(opts.min_distance)
    k = gftt.kept_capacity(height, width, opts.min_distance)

    def k4(o=offs):
        return lambda: gftt_suppress.gftt_suppress_kept(q, o, k)

    k4_ms = event_ms(k4(), 20)
    floor_ms = event_ms(k4(gftt._circle_offsets(1.0)), 20)
    k4_plain = event_ms(lambda: gftt._compact_kept(
        q, gftt.suppress_plain(q, offs)[0], k), 3)
    whole = gftt_suppress.gftt_suppress_kept(q, offs, k)
    rounds = int(whole[4])
    # Cut at 2 rounds a call and resumed from its state: the uncut kept
    # list and rounds.
    cut = gftt_suppress.gftt_suppress_kept(q, offs, k, 2)
    cut_rounds, calls = int(cut[4]), 1
    while not bool(cut[3]):
        cut = gftt_suppress.gftt_suppress_kept(q, offs, k, 2, cut[5])
        cut_rounds, calls = cut_rounds + int(cut[4]), calls + 1
    resumed_same = all(torch.equal(a, b) for a, b in zip(cut[:3], whole[:3]))
    print(f"  K4 cut at 2 rounds a call: {calls} calls, {cut_rounds} rounds, "
          f"kept list {'equal' if resumed_same else 'DIFFERS'} to the uncut "
          f"call's")
    if not resumed_same or cut_rounds != rounds:
        fails.append("K4 resumed from its state differs from the uncut call")
    # The rounds K4 runs on each of the main path's frames (their response
    # maps at the default options, as the analyze phase suppressed them).
    clip_rounds = []
    for frame in frames:
        fi = torch.as_tensor(frame, device=device).to(torch.float32)
        e, c = gftt.gftt_response(fi, None, opts.quality_level,
                                  opts.harris_k)
        clip_rounds.append(int(gftt_suppress.gftt_suppress_kept(
            torch.where(c, e, 0.0).contiguous(), offs, 1)[4]))
    print(f"  K4 rounds on the clip's {n} frames at d {opts.min_distance:g}: "
          f"{clip_rounds} ({sum(clip_rounds)} in all)")
    k4_b = k4_bound(height, width, rounds)
    print(f"  K4, clip frame {PAN_SOURCE} at d {opts.min_distance:g}, "
          f"{rounds} rounds in one launch: {k4_ms:.4f} ms; floor (d 1) "
          f"{floor_ms:.4f} ms; plain {k4_plain:.4f} ms; bound "
          f"{k4_b[0]:.5f} ms by {k4_b[1]}, {k4_b[0] / k4_ms:.4f} of it")

    # The crossover: one frame's GFTT by route, in turns (host, device,
    # device, host) at each size; the crossover is the smallest size from
    # which the device route wins both turns.
    crossover = None
    for w, h in ROUTE_SIZES:
        frame = (frames[0] if (w, h) == (width, height) else big
                 if (w, h) == (3840, 2160) else panning_clip(
                     np.random.default_rng(6), 1, w, h, PAN_STEP)[0])
        img = torch.as_tensor(frame, device=device)
        t = [gftt_route_ms(img, device, host) for host in
             (True, False, False, True)]
        print(f"  GFTT {w}x{h} ({w * h} px) a frame: host route "
              f"{t[0]:.4f} / {t[3]:.4f} ms, device route {t[1]:.4f} / "
              f"{t[2]:.4f} ms (in turns) on {smi}")
        if max(t[1], t[2]) < min(t[0], t[3]):
            crossover = w * h if crossover is None else crossover
        else:
            crossover = None
    print(f"  suppression crossover: the device route wins both turns at "
          f"every size from {crossover} px; gftt.DEVICE_SUPPRESS_MIN = "
          f"{gftt.DEVICE_SUPPRESS_MIN}")

    # The chained analyze of the clip against the unchained one, in turns.
    info = VideoInfo(width, height, 0, n)
    workdir = os.path.dirname(analyze_db)
    levels, solves = analyze_solves(n, height, width)
    phases = sum(len({abs(s) for s in IMAGE_SKIPS if 0 <= f + s < n})
                 for f in range(n))

    def run(path, chained, on=device):
        os.environ["POLYCHASE_LK_CHAIN"] = "1" if chained else "0"
        try:
            t0 = time.perf_counter()
            generate_optical_flow_database(info, lambda f: frames[f], None,
                                           path, device=on)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            os.environ.pop("POLYCHASE_LK_CHAIN")

    # In turns: GFTT's host route, its device route, chained (device
    # route), then back; the first chained run is the gated one.
    seconds = {}
    saved = gftt.DEVICE_SUPPRESS_MIN
    for i, name in enumerate(("host route", "device route", "chained",
                              "chained", "device route", "host route")):
        path = os.path.join(workdir, f"routes_{i}.db")
        if i == 2:
            lk_prep.launches = lk_iter.launches = gftt_suppress.launches = 0
        gftt.DEVICE_SUPPRESS_MIN = (height * width + 1 if name == "host route"
                                    else saved)
        try:
            seconds.setdefault(name, []).append(run(path, name == "chained"))
        finally:
            gftt.DEVICE_SUPPRESS_MIN = saved
        if i == 2:
            launches = (lk_prep.launches, lk_iter.launches,
                        gftt_suppress.launches)
            chain_db = path
    host_kps = read_analyze_db(os.path.join(workdir, "routes_0.db"), n)[0]
    dev_kps = read_analyze_db(os.path.join(workdir, "routes_1.db"), n)[0]
    same_kps = all(np.array_equal(a, b) for a, b in zip(host_kps, dev_kps))
    print(f"  analyze keypoints, GFTT's device route (K4) against its host "
          f"route: {'equal' if same_kps else 'DIFFER'}")
    if not same_kps:
        fails.append("the device route's analyze keypoints differ from the "
                     "host route's")
    kps, flows = read_analyze_db(chain_db, n)
    ref_kps, ref_flows = read_analyze_db(analyze_db, n)
    fails += analyze_gates(kps, flows, n)
    share, worst, f = chain_gates(kps, flows, ref_kps, ref_flows)
    fails += f
    k4_want = n if gftt.device_suppress_route(height * width, opts) else 0
    want = (levels * solves, levels * phases, k4_want)
    print(f"  chained analyze: K2 / K3 / K4 launches {launches} (want "
          f"{want}: {solves} solves x {levels} levels, {phases} phases); "
          f"against the unchained DB at skips ±1/±2: {share:.4f} of the "
          f"flows kept by both, largest median distance {worst:.4g} px"
          + "".join(f"; {m}" for m in f))
    if launches != want:
        fails.append(f"chained K2/K3/K4 launched {launches}, want {want}")
    print(f"  analyze {width}x{height}, {n} frames, frames/s in turns "
          f"(host route, device route, chained, chained, device route, host "
          f"route): " + ", ".join(
              f"{k} {n / v[0]:.4f} / {n / v[1]:.4f}"
              for k, v in seconds.items()) + f" on {smi}")

    # The chained analyze split over the devices, against one device's.
    devices, cards = shard_devices()
    lk_prep.launches = lk_iter.launches = 0
    split_db = os.path.join(workdir, "routes_split.db")
    split_s = run(split_db, True, devices)
    split_launches = (lk_prep.launches, lk_iter.launches)
    skps, sflows = read_analyze_db(split_db, n)
    same_kps = all(np.array_equal(a, b) for a, b in zip(skps, kps))
    same_kept = set(sflows) == set(flows) and all(
        np.array_equal(sflows[k].src_kps_indices, flows[k].src_kps_indices)
        for k in flows)
    dflow = max((float(np.abs(sflows[k].tgt_kps - flows[k].tgt_kps).max(
        initial=0.0)) for k in flows if k in sflows), default=0.0)
    D = len(devices)
    split_want = (levels * solves * D, levels * phases * D)
    print(f"  chained analyze over {[str(d) for d in devices]}"
          + ("" if cards else " (two shards on one card)")
          + f": {n / split_s:.4f} frames/s; K2 / K3 launches "
          f"{split_launches} (want {split_want}); against the one-device "
          f"chained DB: keypoints {'equal' if same_kps else 'DIFFER'}, kept "
          f"flows {'the same' if same_kept else 'DIFFER'}, largest flow "
          f"difference {dflow:.3g} px")
    if split_launches != split_want:
        fails.append(f"split chained K2/K3 launched {split_launches}, want "
                     f"{split_want}")
    if not same_kps or not same_kept or dflow > SHARD_POS_ATOL:
        fails.append("the split chained analyze differs from the one-device"
                     f" chained analyze ({dflow:.3g} px)")
    # The device route never hands a frame to the host; a frame whose
    # fixed point outlasts MAX_ROUNDS rounds is resumed on the card.
    print(f"  GFTT frames resumed on the card in this run: "
          f"{gftt.resumed_frames}")
    torch.cuda.synchronize()
    if fails:
        raise AssertionError("analyze routes:\n" + "\n".join(fails))
    return dict(ms=k4_ms, floor_ms=floor_ms, plain_ms=k4_plain,
                bound=k4_b, max_abs_err=k4_err,
                routes_launches=launches, split_launches=split_launches,
                clip_rounds=sum(clip_rounds))


# ---------------------------------------------------------------------------
# Add-on phase
# ---------------------------------------------------------------------------

ADDON_SOURCES = ("pnp_lm.cu", "lk_prep.cu", "lk_iter.cu", "gftt_suppress.cu",
                 "raycast_sweep.cu")
# Between the OpenCV and the OpenGL camera frame (its own inverse).
GL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])
PIN_DRAG_TO = (955.0, 542.0)  # crossover.pin_drag's target of pin 2 (k = 0)


class Event:
    """A window-manager event as the add-on's modal handlers read it."""

    def __init__(self, etype, value="NOTHING", x=0.0, y=0.0):
        self.type, self.value = etype, value
        self.mouse_x, self.mouse_y, self.ctrl = x, y, False


def pump(op, ctx):
    """Tick a modal operator on its timer until it leaves RUNNING_MODAL;
    anything but FINISHED fails."""
    deadline = time.monotonic() + THREAD_DEADLINE_S
    timer = Event("TIMER")
    while time.monotonic() < deadline:
        res = op.modal(ctx, timer)
        if res == {"FINISHED"}:
            return
        if res != {"RUNNING_MODAL"}:
            raise AssertionError(f"{type(op).__name__} ended {res}: "
                                 f"{op.reports}")
        time.sleep(0.001)
    raise AssertionError(f"{type(op).__name__} did not finish within "
                         f"{THREAD_DEADLINE_S} s")


def gl_flow_db(src_path, dst_path, n):
    """A copy of an OpenCV-convention flow DB in the OpenGL convention the
    add-on tracks in: pixel y counted up, y' = HEIGHT - y (Blender's image
    rows run bottom-up; the principal point is at HEIGHT / 2 in both)."""
    from polychase_tpu_torch.io.database import Database

    def flip(a):
        return np.stack([a[:, 0], np.float32(HEIGHT) - a[:, 1]], -1)

    src, dst = Database(src_path), Database(dst_path)
    try:
        with dst.deferred_commits():
            for f in range(n):
                dst.write_keypoints(f, flip(src.read_keypoints(f)))
            for f in range(n):
                for t in src.find_optical_flows_from_image(f):
                    fl = src.read_image_pair_flow(f, t)
                    dst.write_image_pair_flow(f, t, fl.src_kps_indices,
                                              flip(fl.tgt_kps),
                                              fl.flow_errors)
    finally:
        src.close()
        dst.close()


class CameraView3D:
    """A 3D view looking through the scene camera (Blender's camera view):
    the view follows the camera, the projection is the clip's pinhole."""

    def __init__(self, mu, camera, near=0.1, far=1000.0):
        self.camera = camera
        self.view_perspective = "CAMERA"
        self.window_matrix = mu.Matrix((
            (2.0 * FOCAL / WIDTH, 0.0, 0.0, 0.0),
            (0.0, 2.0 * FOCAL / HEIGHT, 0.0, 0.0),
            (0.0, 0.0, -(far + near) / (far - near),
             -2.0 * far * near / (far - near)),
            (0.0, 0.0, -1.0, 0.0),
        ))

    @property
    def view_matrix(self):
        return self.camera.matrix_world.inverted()

    @property
    def perspective_matrix(self):
        return self.window_matrix @ self.view_matrix


def cv_view(world) -> np.ndarray:
    """The OpenCV view matrix of a Blender camera's world matrix."""
    return GL_FLIP @ np.linalg.inv(np.asarray(world, np.float64))


def rot_angle(ra, rb) -> float:
    """The angle between two rotation matrices, in float64."""
    c = (np.trace(np.asarray(ra, np.float64) @ np.asarray(rb).T) - 1) / 2
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@contextlib.contextmanager
def extracted_addon(zip_path, tests_dir):
    """The add-on zip extracted into a temporary directory outside any
    checkout and its shim imported as Blender would, with a fresh user
    cache as the build root (``XDG_CACHE_HOME``), the fake bpy of
    ``tests/`` installed and the checkout's ``polychase_tpu_torch`` set
    aside so that the import takes the zip's copy.  Yields (the shim, the
    extract directory, the cache directory, fake_bpy, the scene, bpy);
    restores everything on exit."""
    import importlib.util
    import sys
    import zipfile

    ours = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] == "polychase_tpu_torch"}
    path, cache_env = list(sys.path), os.environ.get("XDG_CACHE_HOME")
    with tempfile.TemporaryDirectory() as extract, \
            tempfile.TemporaryDirectory() as cache:
        zipfile.ZipFile(zip_path).extractall(extract)
        os.environ["XDG_CACHE_HOME"] = cache
        for name in ours:
            del sys.modules[name]
        sys.path.insert(0, tests_dir)
        import fake_bpy

        scene = fake_bpy.FakeScene()
        bpy, saved = fake_bpy.install(scene)
        try:
            spec = importlib.util.spec_from_file_location(
                "polychase_torch_addon", os.path.join(extract, "__init__.py"))
            shim = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(shim)
            yield shim, extract, cache, fake_bpy, scene, bpy
        finally:
            fake_bpy.uninstall(saved)
            for name in [k for k in sys.modules
                         if k.split(".")[0] == "polychase_tpu_torch"]:
                del sys.modules[name]
            sys.modules.update(ours)
            sys.path[:] = path
            if cache_env is None:
                os.environ.pop("XDG_CACHE_HOME", None)
            else:
                os.environ["XDG_CACHE_HOME"] = cache_env


def addon_phase(device, frames, track, surface, workdir, smi,
                addon_device=None):
    """The Blender add-on copy installed from its release zip (module
    docstring, item 15), its engine calls on ``addon_device``, the copy's
    ``core.DEVICE`` (None: the card, as a user's Blender runs it).
    ``device`` runs the checkout's reference calls.  Returns the K1, K2,
    K3, K4 and K5 launches of its gated runs."""
    import importlib
    import sys
    from pathlib import Path

    import polychase_tpu_torch.polychase_core as spc
    from polychase_tpu_torch import crossover
    from polychase_tpu_torch.synthetic import uv_sphere

    fails = []
    root = os.path.dirname(os.path.abspath(__file__))
    n = len(frames)
    height, width = frames[0].shape
    poses = track["poses"]
    last = len(poses) - 1
    # The checkout's references, before its package is set aside: the pin
    # phase's 8-pin drag and the surface phase's threads (timed in turns).
    pins, escene = crossover.pin_scene(CPU, 8)
    pin_ref = crossover.pin_drag(pins, escene, 0, device).view_matrix.numpy()
    pin_view = escene.view_matrix.numpy().astype(np.float64)
    track_cv = spc.SceneTransformations(
        np.eye(4), view_of(poses[0]), spc.CameraIntrinsics(
            FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0, WIDTH, HEIGHT,
            spc.CameraConvention.OpenCV))
    track_mesh = spc.AcceleratedMesh(track["verts"], track["tris"])

    def surface_analyze(path):
        t0 = time.perf_counter()
        _, errors, _ = drain(spc.OpticalFlowThread(
            spc.VideoInfo(width, height, 0, n), path), frames, pc=spc)
        if errors:
            raise errors[0]
        return time.perf_counter() - t0

    def surface_track():
        t0 = time.perf_counter()
        _, errors, _ = drain(spc.TrackerThread(
            track["db"], 0, last, track_cv, track_mesh, False, False,
            spc.BundleOptions()), pc=spc)
        if errors:
            raise errors[0]
        return time.perf_counter() - t0

    zip_path = os.path.join(workdir, "addon.zip")
    subprocess.run([sys.executable, os.path.join(
        root, "scripts", "package_addon_torch.py"), zip_path], check=True,
        capture_output=True, timeout=120)
    gl_db = os.path.join(workdir, "addon_track.db")
    with extracted_addon(zip_path, os.path.join(root, "tests")) as (
            shim, extract, cache, fake_bpy, scene, bpy):
        import fake_mathutils as mu
        import polychase_tpu_torch
        import polychase_tpu_torch.polychase_core as pc
        from polychase_tpu_torch import native
        from polychase_tpu_torch.kernels import (
            build, gftt_suppress, lk_iter, lk_prep, pnp_lm, raycast_sweep,
        )

        pkg = "polychase_tpu_torch.blender_addon"
        core = importlib.import_module(f"{pkg}.core")
        analysis = importlib.import_module(f"{pkg}.operators.analysis")
        tracking = importlib.import_module(f"{pkg}.operators.tracking")
        pin_mode = importlib.import_module(
            f"{pkg}.operators.pin_mode.pin_mode")
        keyframes = importlib.import_module(f"{pkg}.keyframes")
        shim.register()
        core.DEVICE = addon_device
        ctx = bpy.context

        # The install: the zip's package, no JAX, the host library and the
        # five kernels built from the zip's sources into the user cache.
        cache_root = Path(cache) / "polychase_tpu_torch"
        t0 = time.perf_counter()
        libs = build.load_all(ADDON_SOURCES)
        for mod in (pnp_lm, lk_prep, lk_iter, gftt_suppress, raycast_sweep):
            mod.load()
        build_s = time.perf_counter() - t0
        checks = {
            "polychase_tpu_torch comes from the zip":
                polychase_tpu_torch.__file__.startswith(extract),
            "no jax and no polychase_tpu module is loaded": not [
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "polychase_tpu")],
            "the host library is built and loaded": native.available(),
            "the build root is the user cache":
                build.build_root() == cache_root
                and build.build_root() != Path(extract).parent / "build",
            "the host library lies in the user cache":
                native.library_path().parent == cache_root / "torch_native",
            "K1-K5 lie in the user cache, built from the zip's csrc/":
                all(lib.path.parent == cache_root / "torch_kernels"
                    for lib in libs)
                and str(build.CSRC).startswith(extract),
        }
        print(f"  zip: {os.path.getsize(zip_path)} bytes, extracted outside "
              f"the checkout; bl_info {shim.bl_info['name']!r}; "
              f"core.DEVICE {core.DEVICE}")
        print(f"  build root {build.build_root()}: host library "
              f"{native.library_path().name}, "
              + ", ".join(f"{lib.path.name} (nvcc {lib.build_seconds:.2f} s)"
                          for lib in libs)
              + f"; built and loaded in {build_s:.2f} s")
        for what, ok in checks.items():
            print(f"  {what}: {'yes' if ok else 'NO'}")
            if not ok:
                fails.append(what)

        def new_tracker(size, nframes, db_path, world=None, mesh=None):
            """A fresh tracker on a fresh clip of ``size`` (width, height)
            and a fresh camera of focal length FOCAL in pixels."""
            clip = fake_bpy.FakeClip("clip", os.path.join(workdir,
                                                          "clip.mp4"),
                                     *size, 0, nframes)
            cam_data = fake_bpy.FakeCameraData()
            cam_data.lens = FOCAL * cam_data.sensor_width / size[0]
            camera = fake_bpy.FakeObject("Camera", data=cam_data)
            if world is not None:
                camera.matrix_world = mu.Matrix(world)
            geometry = None if mesh is None else fake_bpy.FakeObject(
                "Sphere", mesh_arrays=mesh)
            tracker = fake_bpy.FakeTracker(clip=clip, camera=camera,
                                           geometry=geometry,
                                           database_path=db_path)
            scene._image_users.clear()
            scene.polychase_state = fake_bpy.FakeState([tracker])
            scene.frame_set(0)
            return tracker

        rgba = np.ones((height, width, 4), np.float32)

        def addon_analyze(path):
            tracker = new_tracker((width, height), n, path)
            op = analysis.PC_OT_AnalyzeVideo()
            op.invoke(ctx, Event("RET"))
            t0 = time.perf_counter()
            if op.execute(ctx) != {"RUNNING_MODAL"}:
                raise AssertionError(f"analyze did not start: {op.reports}")
            image = bpy.data.images.get(f"polychase_source_"
                                        f"{tracker.clip.name}")

            def pixels():
                # The clip frame at the scene's frame, as Blender's float
                # pixels of an 8-bit image (grey in R, G and B).
                rgba[..., :3] = (frames[scene.frame_current][..., None]
                                 .astype(np.float32) / 255.0)
                return rgba

            image.provider = pixels
            scene._image_users.extend(
                bg.image_user for bg in tracker.camera.data.background_images
                if bg.source == "IMAGE" and bg.image is image)
            pump(op, ctx)
            return time.perf_counter() - t0

        gl_flow_db(track["db"], gl_db, len(poses))
        track_world = np.linalg.inv(GL_FLIP @ view_of(poses[0]))
        track_mesh_arrays = (track["verts"], track["tris"])

        def addon_track(tracker=None):
            """The track through PC_OT_TrackSequence, on a fresh tracker or
            on ``tracker`` with its camera's animation cleared."""
            if tracker is None:
                tracker = new_tracker((WIDTH, HEIGHT), len(poses), gl_db,
                                      track_world, track_mesh_arrays)
            else:
                scene.polychase_state = fake_bpy.FakeState([tracker])
                tracker.camera.animation_data = None
                tracker.camera.keyframe_matrices.clear()
                tracker.camera.matrix_world = mu.Matrix(track_world)
                scene.frame_set(0)
            start = core.scene_transformations(tracker, WIDTH, HEIGHT)
            op = tracking.PC_OT_TrackSequence()
            t0 = time.perf_counter()
            if op.execute(ctx) != {"RUNNING_MODAL"}:
                raise AssertionError(f"tracking did not start: "
                                     f"{op.reports}")
            pump(op, ctx)
            return time.perf_counter() - t0, tracker, start

        def addon_pin_drag():
            tracker = new_tracker((WIDTH, HEIGHT), 1, "",
                                  np.linalg.inv(GL_FLIP @ pin_view),
                                  uv_sphere(24, 32))
            tracker.pins_data = np.ascontiguousarray(pins,
                                                     np.float32).tobytes()
            tracker.pins_version += 1
            rv3d = CameraView3D(mu, tracker.camera)
            area = fake_bpy.FakeView3DArea(WIDTH, HEIGHT, rv3d)
            ctx.screen.areas[:] = [area]
            op = pin_mode.PC_OT_PinMode()
            if op.invoke(ctx, Event("NONE")) != {"RUNNING_MODAL"}:
                raise AssertionError(f"pin mode did not start: "
                                     f"{op.reports}")
            grab = op._project_pins(tracker, core.Trackers.get(tracker),
                                    area.regions[0], rv3d)[2]
            op.modal(ctx, Event("LEFTMOUSE", "PRESS", *map(float, grab)))
            if op._drag_pin != 2:
                raise AssertionError(f"pin mode picked pin {op._drag_pin}, "
                                     f"want 2")
            # Region y runs up: the OpenCV pixel y of the target, flipped.
            to = (PIN_DRAG_TO[0], HEIGHT - PIN_DRAG_TO[1])
            op.modal(ctx, Event("MOUSEMOVE", "NOTHING", *to))
            op.modal(ctx, Event("LEFTMOUSE", "RELEASE", *to))
            op.modal(ctx, Event("ESC", "PRESS"))
            ctx.screen.areas.clear()
            return cv_view(tracker.camera.matrix_world)

        # The gated runs, with the launch counts of the zip's wrappers.
        kernels = (pnp_lm, lk_prep, lk_iter, gftt_suppress, raycast_sweep)
        for mod in kernels:
            mod.launches = 0
        analyze_s = addon_analyze(os.path.join(workdir, "addon_analyze.db"))
        track_s, tracker, start = addon_track()
        pin_got = addon_pin_drag()
        launches = tuple(mod.launches for mod in kernels)

        # Analyze: the surface phase's DB, to the bit.
        kps, flows = read_analyze_db(os.path.join(workdir,
                                                  "addon_analyze.db"), n)
        ref_kps, ref_flows = read_analyze_db(surface["db"], n)
        same_kps = all(np.array_equal(a, b) for a, b in zip(kps, ref_kps))
        same_flows = set(flows) == set(ref_flows) and all(
            np.array_equal(getattr(flows[k], a), getattr(ref_flows[k], a))
            for k in flows
            for a in ("src_kps_indices", "tgt_kps", "flow_errors"))
        levels, solves = analyze_solves(n, height, width)
        solves *= torch.cuda.device_count() if addon_device is None else 1
        print(f"  PC_OT_AnalyzeVideo: {n} frames in {analyze_s:.3f} s; "
              f"against the surface phase's DB: keypoints "
              f"{'equal' if same_kps else 'DIFFER'}, pairs and flows "
              f"{'equal to the bit' if same_flows else 'DIFFER'}")
        if not (same_kps and same_flows):
            fails.append("the add-on's analyze DB differs from the surface "
                         "phase's")
        fails += analyze_gates(kps, flows, n)

        # Tracking: every frame keyed; the keyframes against the direct
        # track_sequence on the add-on's own inputs, written back by the
        # add-on's own code; the truth; the surface phase's poses.
        gen = keyframes.keyframes_of_type(
            keyframes.tracker_fcurves(tracker, include_lens=False),
            keyframes.GENERATED_KEYFRAME)
        if gen != set(range(1, last + 1)):
            fails.append(f"{len(gen)} frames keyed, want {last}")
        opts = pc.BundleOptions()
        opts.loss_type = pc.LossType.Cauchy
        opts.loss_scale = 1.0
        direct = []
        pc.track_sequence(gl_db, 0, last, start,
                          core.Trackers.get(tracker).accel_mesh,
                          lambda r: direct.append(r) or True, False, False,
                          opts, device=addon_device)
        replay = fake_bpy.FakeObject("Camera", data=tracker.camera.data)
        replay.matrix_world = mu.Matrix(track_world)
        replay_tracker = fake_bpy.FakeTracker(
            clip=tracker.clip, camera=replay, geometry=tracker.geometry)
        for r in direct:
            tracking.apply_tracking_result(replay_tracker, r)
        keyed = {f: np.asarray(tracker.camera.keyframe_matrices[f])
                 for f in sorted(gen)}
        dkey = max(float(np.abs(keyed[f] - replay.keyframe_matrices[f])
                         .max()) for f in keyed)
        views = {f: cv_view(m) for f, m in keyed.items()}
        rot = max(rot_angle(v[:3, :3], view_of(poses[f])[:3, :3])
                  for f, v in views.items())
        terr = max(float(np.linalg.norm(v[:3, 3] - poses[f][1]))
                   for f, v in views.items())
        dsurf = max(float(np.abs(v - view_of(surface["poses"][f])).max())
                    for f, v in views.items())
        print(f"  PC_OT_TrackSequence: {len(gen)} frames keyed in "
              f"{track_s:.3f} s (OpenGL, the DB flipped to y up); "
              f"against the direct track_sequence written back by the "
              f"add-on {dkey:.3g}; max rot err {rot:.3g} rad, max t err "
              f"{terr:.3g}; against the surface phase's OpenCV poses "
              f"(Huber, y down) {dsurf:.3g}")
        if dkey > SURFACE_ATOL:
            fails.append(f"the add-on's keyframes differ from the direct "
                         f"track by {dkey:.3g}")
        if rot > ROT_ERR_MAX or terr > T_ERR_MAX:
            fails.append("an add-on keyframe is off the ground truth")

        dpin = float(np.abs(pin_got - pin_ref).max())
        print(f"  pin mode: one 8-pin drag of pin 2 to {PIN_DRAG_TO}; "
              f"against the pin phase's drag {dpin:.3g}")
        if dpin > PIN_ROUTE_ATOL:
            fails.append(f"the add-on's pin drag differs from the pin "
                         f"phase's by {dpin:.3g}")
        want = (last, levels * solves, levels * solves,
                n if analyze_k4(height, width) else 0, last)
        print(f"  K1 / K2 / K3 / K4 / K5 launches through the add-on: "
              f"{' / '.join(map(str, launches))} (want "
              f"{' / '.join(map(str, want))})")
        if launches != want:
            fails.append(f"the add-on's runs launched {launches}, want "
                         f"{want}")
        if fails:
            raise AssertionError("add-on:\n" + "\n".join(fails))

        # Through the add-on against through the surface, in turns.
        turns = {"analyze frames/s": [], "tracking frames/s": []}
        for i, how in enumerate(("surface", "add-on", "add-on", "surface")):
            path = os.path.join(workdir, f"addon_turn{i}.db")
            seconds = (surface_analyze(path) if how == "surface"
                       else addon_analyze(path))
            turns["analyze frames/s"].append((how, n / seconds))
            seconds = (surface_track() if how == "surface"
                       else addon_track(tracker)[0])
            turns["tracking frames/s"].append((how, last / seconds))
        for what, runs in turns.items():
            print(f"  {what} (through the surface, through the add-on, in "
                  f"turns): " + ", ".join(f"{how} {value:.4f}"
                                          for how, value in runs)
                  + f" on {smi}")
        shim.unregister()
    return launches


def main() -> None:
    started = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    from polychase_tpu_torch.backend import require_cuda
    from polychase_tpu_torch.kernels import (
        build, gftt_suppress, grid_cast, lk_iter, lk_prep, pnp_lm,
        raycast_sweep,
    )
    from polychase_tpu_torch.synthetic import panning_clip

    smi = nvidia_smi()
    print(f"card: {smi}")
    device = require_cuda()

    print("build (one nvcc per source, in parallel):")
    t0 = time.perf_counter()
    libs = build.load_all(["pnp_lm.cu", "lk_prep.cu", "lk_iter.cu",
                           "gftt_suppress.cu", "raycast_sweep.cu",
                           "grid_cast.cu"])
    for mod in (pnp_lm, lk_prep, lk_iter, gftt_suppress, raycast_sweep,
                grid_cast):
        mod.load()
    for lib in libs:
        print(f"  {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if ("registers" in line or "spill" in line
                    or ("entry function" in line and lib in libs[4:])):
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
    with tempfile.TemporaryDirectory() as workdir:
        print("analyze phase (generate_optical_flow_database on the card):")
        lk_launches, analyze_fps, analyze_db = analyze_phase(device, frames,
                                                             workdir)
        print(f"analyze {analyze_fps:.2f} frames/s at 1920x1080 on {smi}")
        print("tracking phase (track_sequence on the card):")
        launches, fps, path_err, track = main_path_phase(device, workdir)
        print(f"tracking {fps:.2f} frames/s at 1920x1080 on {smi}")
        print("refine phase (refine_trajectory, config 4, on the card):")
        refine_s, refine_iters, refine = refine_phase(device, workdir)
        print(f"refine {refine_s:.4f} s, {refine_iters} iterations, 250 "
              f"frames on {smi}")
        print("K5 phase (the ray cast sweep vs plain torch, on the card):")
        k5 = k5_phase(device, track, refine, smi)
        print("K6 phase (the grid cast vs plain torch, K5 and the flat "
              "cast, on the card):")
        k6 = k6_phase(device, track, refine, k5, smi)
        print("pin phase (find_transformation, config 2):")
        pin_ms, pin_launches, pin_err = pin_phase(device)
        print(f"pin drag {pin_ms:.4f} ms per 8-pin solve on {smi}")
        print("surface phase (polychase_core with no device argument):")
        k1_surface, lk_surface, surface = surface_phase(
            device, frames, analyze_db, track, refine, workdir, smi)
        print("segments phase (track_segments and refine_segments):")
        k1_segments, seg_err, k5_segments = segments_phase(device, track,
                                                           refine, smi)
        print("sharded phase (analyze and refine split over devices):")
        lk_sharded = sharded_phase(device, frames, analyze_db, refine, smi)
        print("analyze-routes phase (GFTT device suppression, chained fan):")
        routes = routes_phase(device, frames, analyze_db, smi)
        print("add-on phase (the Blender add-on from its zip, on the card):")
        addon = addon_phase(device, frames, track, surface, workdir, smi)

    (k2_ms, k2_plain), (k3_ms, k3_plain) = lk_times
    (k2_bound_ms, k2_by), (k3_bound_ms, k3_by) = lk_bounds
    k1_ms, k1_plain, _, _, (k1_bound_ms, k1_by) = times[
        "loss1_ftol1e-05_f0_pp0"]
    frame_ms, frame_plain, frame_bound, frame_plan = k5["scenes"][
        "tracking frame"]
    refresh, flat = (k5["scenes"][k] for k in ("config 4 refresh",
                                              "groups of one ray"))
    k5_regs, k5_spills = k5_registers(libs[4].build_log, frame_plan)
    k6_regs, k6_spills = kernel_registers(libs[5].build_log, "grid_kernel")
    k6_frame, k6_refresh = (k6["scenes"][k] for k in ("tracking frame",
                                                      "config 4 refresh"))
    # No single PyTorch call computes any of the six (library_ms null).
    # ``launches`` counts the main path's runs (analyze; tracking and the pin
    # drags), ``surface_launches`` the surface phase's gated runs,
    # ``segments_launches`` the gated ``track_segments`` run,
    # ``sharded_launches`` the gated split analyze, ``routes_launches`` the
    # gated chained analyze, ``routes_sharded_launches`` its split and
    # ``addon_launches`` the add-on phase's gated runs.
    kernels = [{
        "name": "pnp_lm",
        "route": "cuda",
        "source": "polychase_tpu_torch/csrc/pnp_lm.cu",
        "replaces": "polychase_tpu/kernels/pnp_pallas.py:183",
        "launches": launches + pin_launches,
        "surface_launches": k1_surface,
        "segments_launches": k1_segments,
        "addon_launches": addon[0],
        "max_abs_err": max(max_err, path_err, pin_err, seg_err),
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
        "surface_launches": lk_surface[0],
        "sharded_launches": lk_sharded[0],
        "routes_launches": routes["routes_launches"][0],
        "routes_sharded_launches": routes["split_launches"][0],
        "addon_launches": addon[1],
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
        "surface_launches": lk_surface[1],
        "sharded_launches": lk_sharded[1],
        "routes_launches": routes["routes_launches"][1],
        "routes_sharded_launches": routes["split_launches"][1],
        "addon_launches": addon[2],
        "max_abs_err": pos_err,
        "ms": k3_ms,
        "plain_ms": k3_plain,
        "bound_ms": k3_bound_ms,
        "bound_by": k3_by,
        "library_ms": None,
    }, {
        "name": "gftt_suppress",
        "route": "cuda",
        "source": "polychase_tpu_torch/csrc/gftt_suppress.cu",
        # A kernel of the port alone: the JAX package runs this fixed point
        # as XLA, not Pallas.
        "replaces": "polychase_tpu/engine/gftt.py:540",
        # Wrapper calls, one a frame; cuda_launches: the cooperative
        # launches the library counted for them, one each; rounds: those the
        # main path's frames ran; floor_ms: the same frame at d 1 (one
        # round, no neighbour reads).
        "launches": lk_launches[2],
        "cuda_launches": lk_launches[3],
        "rounds": routes["clip_rounds"],
        "floor_ms": routes["floor_ms"],
        "routes_launches": routes["routes_launches"][2],
        "addon_launches": addon[3],
        "max_abs_err": routes["max_abs_err"],
        "ms": routes["ms"],
        "plain_ms": routes["plain_ms"],
        "bound_ms": routes["bound"][0],
        "bound_by": routes["bound"][1],
        "library_ms": None,
    }, {
        "name": "raycast_sweep",
        "route": "cuda",
        "source": "polychase_tpu_torch/csrc/raycast_sweep.cu",
        # A kernel of the port alone: the JAX package runs this sweep as
        # XLA (raycast_grouped's scan), not Pallas.
        "replaces": "polychase_tpu/engine/raycast.py:153",
        # One a frame step of the tracking phase's runs; refine_launches:
        # one a prim refresh of the refine phase's timed run; cuda_launches:
        # those the library counted for the main path's, one a call. ms,
        # plain_ms and the bound: a recorded tracking frame (8192 rays,
        # 20,224 triangles), its whole cast in one launch, the plain route
        # its sweep and hits in torch; refresh_*: config 4's recorded
        # refresh; flat_*: its rays as 32,000 groups of one.
        # rays_per_thread, cluster and registers: the frame's launch;
        # frame_step_kernels: the device kernels of one tracking frame's
        # raycast_grouped.
        "launches": track["k5_launches"],
        "cuda_launches": track["k5_cuda_launches"],
        "refine_launches": refine["k5_launches"],
        "surface_launches": surface["k5_launches"],
        "segments_launches": k5_segments,
        "addon_launches": addon[4],
        "max_abs_err": k5["max_abs_err"],
        "ms": frame_ms,
        "plain_ms": frame_plain,
        "bound_ms": frame_bound[0],
        "bound_by": frame_bound[1],
        "refresh_ms": refresh[0],
        "refresh_plain_ms": refresh[1],
        "refresh_bound_ms": refresh[2][0],
        "flat_ms": flat[0],
        "flat_plain_ms": flat[1],
        "flat_bound_ms": flat[2][0],
        "rays_per_thread": frame_plan.rays_per_thread,
        "cluster": frame_plan.cluster,
        "registers": k5_regs,
        "spill_bytes": k5_spills,
        "frame_step_kernels": k5["frame_step_kernels"],
        "library_ms": None,
    }, {
        "name": "grid_cast",
        "route": "cuda",
        "source": "polychase_tpu_torch/csrc/grid_cast.cu",
        # A kernel of the port alone: the JAX package runs this walk as an
        # XLA lax.while_loop, not Pallas.
        "replaces": "polychase_tpu/engine/gridcast.py:212",
        # launches: the grid module's entry points in the K6 phase (a
        # tracking frame's grid_raycast_grouped, config 4's refresh through
        # grid_raycast), counted from 0; cuda_launches: those the library
        # counted, one a call.  ms, plain_ms and the bound: the recorded
        # tracking frame (8192 rays, 20,224 triangles), the bound from the
        # candidate tests and cell actions its walks took; refresh_*:
        # config 4's recorded refresh; max_abs_err: against grid_plain;
        # sweep_max_abs_err: t and positions against K5 and the flat cast.
        "launches": k6["launches"],
        "cuda_launches": k6["cuda_launches"],
        "max_abs_err": k6["max_abs_err"],
        "sweep_max_abs_err": k6["sweep_max_abs_err"],
        "ms": k6_frame[0],
        "plain_ms": k6_frame[1],
        "bound_ms": k6_frame[2][0],
        "bound_by": k6_frame[2][1],
        "refresh_ms": k6_refresh[0],
        "refresh_plain_ms": k6_refresh[1],
        "refresh_bound_ms": k6_refresh[2][0],
        "frame_tests": k6_frame[3][0],
        "frame_cell_actions": k6_frame[3][1],
        "threads": k6["threads"],
        "registers": k6_regs,
        "spill_bytes": k6_spills,
        "build_ms": k6["build_ms"],
        "library_ms": None,
    }]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - started:.1f} s, the build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
