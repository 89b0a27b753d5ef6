"""The port runs with jax and the JAX package unimportable: a tiny track
(with K5's wrapper, ``kernels.raycast_sweep``, imported) and a grid cast
(K6's wrapper, ``kernels.grid_cast``, imported), a tiny analyze, a
tiny refine followed by a pin drag, the tracker and optical-flow threads of
its ``polychase_core``, the segment-parallel
track and refine (the refine through ``RefineSegmentsThread``) with the
sharded modules and a refine split over two CPU devices, analyze's GFTT
device suppression route and its chained skip fan (on one device and split
by features over two), and an import of every module of the package and of
``chip_smoke.py``, each in a fresh process whose import system refuses
``jax``, ``jaxlib``, ``polychase_tpu`` and every ``polychase_tpu.*`` module
(``polychase_tpu_torch`` is another top-level name and stays
importable): the add-on copy's modules under the fake bpy
(tests/fake_bpy.py) and the stub generator too.  The sources of the port
and of the scripts that package it or drive it on the card are also read
for import statements naming jax or the JAX package."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFUSE_JAX = textwrap.dedent(
    """
    import importlib.abc
    import os
    import sys
    import tempfile

    REFUSED = ("jax", "jaxlib", "polychase_tpu")

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"{name} is refused in this process")
            return None

    sys.meta_path.insert(0, RefuseJax())

    def assert_nothing_leaked():
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in REFUSED)
        assert not leaked, leaked
    """
)

SCRIPT = REFUSE_JAX + textwrap.dedent(
    """
    import numpy as np
    import torch

    torch.set_num_threads(1)

    import polychase_tpu_torch  # noqa: F401
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import Mesh, SceneTransformations
    from polychase_tpu_torch.engine.pose import quat_to_mat_np
    from polychase_tpu_torch.engine.tracker import track_sequence
    from polychase_tpu_torch.kernels import raycast_sweep
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, uv_sphere,
    )

    assert callable(raycast_sweep.raycast_hits)
    dev = torch.device("cpu")
    verts, tris = uv_sphere(12, 16)
    mesh = Mesh.create(verts, tris, device=dev)
    intr = Intrinsics.create(1800, 1800, 960, 540, 1, 1920, 1080, OPENCV,
                             device=dev)
    poses = orbit_poses(8)
    with tempfile.TemporaryDirectory() as td:
        db = os.path.join(td, "flow.db")
        build_flow_db(db, mesh, 1800.0, 1920, 1080, poses,
                      np.random.default_rng(0), 128, 0.0)
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = quat_to_mat_np(poses[0][0])
        view[:3, 3] = poses[0][1]
        scene = SceneTransformations(torch.eye(4), torch.as_tensor(view),
                                     intr)
        got = []
        track_sequence(db, 0, 7, scene, mesh,
                       callback=lambda r: got.append(r) or True, device=dev)
    assert [r.frame for r in got] == list(range(1, 8)), got
    for r in got:
        dt = np.linalg.norm(r.pose.t.numpy() - poses[r.frame][1])
        assert dt < 5e-3, (r.frame, dt)
    # The grid cast (K6's wrapper imported, the plain version on the CPU).
    from polychase_tpu_torch.engine.gridcast import (
        build_grid_accel, grid_raycast,
    )
    from polychase_tpu_torch.engine.raycast import raycast
    from polychase_tpu_torch.kernels import grid_cast

    assert callable(grid_cast.grid_hits)
    o = torch.tensor([[0.0, 0.0, 4.0], [0.0, 4.0, 0.1]])
    d = torch.tensor([[0.05, 0.02, -1.0], [0.01, -1.0, 0.0]])
    hits = grid_raycast(mesh, build_grid_accel(verts, tris, device=dev), o,
                        d)
    assert hits.valid.all()
    assert torch.equal(hits.prim_id, raycast(mesh, o, d).prim_id)
    assert_nothing_leaked()
    print("tracked", len(got), "frames without jax")
    """
)


ANALYZE = REFUSE_JAX + textwrap.dedent(
    """
    import numpy as np
    import torch

    torch.set_num_threads(1)

    from polychase_tpu_torch.io.database import Database
    from polychase_tpu_torch.engine.opticalflow import (
        IMAGE_SKIPS, VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.synthetic import panning_clip

    frames = panning_clip(np.random.default_rng(0), 6, 128, 96, (2, 1))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "flow.db")
        generate_optical_flow_database(
            VideoInfo(128, 96, 0, 6), lambda f: frames[f], None, path,
            device=torch.device("cpu"))
        db = Database(path)
        pairs = 0
        for f in range(6):
            kps = db.read_keypoints(f)
            assert kps.shape[0] > 50, f
            for s in IMAGE_SKIPS:
                if 0 <= f + s < 6:
                    fl = db.read_image_pair_flow(f, f + s)
                    pairs += 1
                    if abs(s) == 1:
                        d = fl.tgt_kps - kps[fl.src_kps_indices]
                        med = np.median(d, axis=0)
                        assert np.abs(med + s * np.array([2, 1])).max() < 0.05
        db.close()
    assert_nothing_leaked()
    print("analyzed", pairs, "pairs without jax")
    """
)


REFINE_AND_PIN = REFUSE_JAX + textwrap.dedent(
    """
    import numpy as np
    import torch

    torch.set_num_threads(1)

    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import (
        TRANSFORM_CAMERA, Mesh, SceneTransformations,
    )
    from polychase_tpu_torch.engine.levmarq import CAUCHY, BundleOptions
    from polychase_tpu_torch.engine.pinmode import (
        PinUpdate, find_transformation,
    )
    from polychase_tpu_torch.engine.pose import quat_to_mat_np
    from polychase_tpu_torch.engine.refiner import refine_trajectory
    from polychase_tpu_torch.synthetic import (
        build_flow_db, noisy_trajectory, orbit_poses, surface_pins,
        uv_sphere,
    )

    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    verts, tris = uv_sphere(12, 16)
    mesh = Mesh.create(verts, tris, device=dev)
    intr = Intrinsics.create(1800, 1800, 960, 540, 1, 1920, 1080, OPENCV,
                             device=dev)
    poses = orbit_poses(12)

    def t_err(traj):
        return np.median([np.linalg.norm(traj.get(i).pose.t.numpy()
                                         - poses[i][1]) for i in range(12)])

    with tempfile.TemporaryDirectory() as td:
        db = os.path.join(td, "flow.db")
        build_flow_db(db, mesh, 1800.0, 1920, 1080, poses, rng, 128, 0.3)
        traj = noisy_trajectory(poses, intr, rng)
        before = t_err(traj)
        refine_trajectory(db, traj, np.eye(4, dtype=np.float32), mesh,
                          optimize_focal_length=True,
                          bundle_opts=BundleOptions(loss_type=CAUCHY,
                                                    max_iterations=30),
                          device=dev)
    assert t_err(traj) < before, (t_err(traj), before)
    pins = surface_pins(mesh, poses[0], 1800.0, 1920, 1080, rng)
    assert pins.shape == (8, 3), pins.shape
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(poses[0][0])
    view[:3, 3] = poses[0][1]
    scene = SceneTransformations(torch.eye(4), torch.as_tensor(view), intr)
    out = find_transformation(pins, scene, scene,
                              PinUpdate(2, np.array([955.0, 542.0])),
                              TRANSFORM_CAMERA, device=dev)
    assert torch.isfinite(out.view_matrix).all()
    assert not torch.equal(out.view_matrix, scene.view_matrix)
    assert_nothing_leaked()
    print("refined and pinned without jax")
    """
)


SURFACE = REFUSE_JAX + textwrap.dedent(
    """
    import time

    import numpy as np
    import torch

    torch.set_num_threads(1)

    import polychase_tpu_torch.polychase_core as pc
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.pose import quat_to_mat_np
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, panning_clip, uv_sphere,
    )

    def drain(thread, frames=None):
        msgs, deadline = [], time.monotonic() + 60
        while time.monotonic() < deadline:
            msg = thread.try_pop()
            if msg is None:
                time.sleep(0.005)
            elif msg is True:
                thread.join()
                return msgs
            elif isinstance(msg, Exception):
                raise msg
            elif isinstance(msg, pc.OpticalFlowRequest):
                thread.provide_frame(msg.frame_id, frames[msg.frame_id])
            else:
                msgs.append(msg)
        raise AssertionError("no done message within 60 s")

    verts, tris = uv_sphere(12, 16)
    poses = orbit_poses(8)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(poses[0][0])
    view[:3, 3] = poses[0][1]
    scene = pc.SceneTransformations(
        np.eye(4), view, pc.CameraIntrinsics(
            1800, 1800, 960, 540, 1, 1920, 1080, pc.CameraConvention.OpenCV))
    frames = panning_clip(np.random.default_rng(0), 6, 128, 96, (2, 1))
    with tempfile.TemporaryDirectory() as td:
        db = os.path.join(td, "flow.db")
        build_flow_db(db, Mesh.create(verts, tris, device="cpu"), 1800.0,
                      1920, 1080, poses, np.random.default_rng(0), 128, 0.0)
        got = drain(pc.TrackerThread(
            db, 0, 7, scene, pc.AcceleratedMesh(verts, tris), False, False,
            pc.BundleOptions(), device="cpu"))
        flow_db = os.path.join(td, "analyze.db")
        progress = drain(pc.OpticalFlowThread(
            pc.VideoInfo(128, 96, 0, 6), flow_db, device="cpu"), frames)
        out = pc.Database(flow_db)
        kps = out.read_keypoints(5)
        out.close()
    assert [r.frame for r in got] == list(range(1, 8)), got
    for r in got:
        assert np.linalg.norm(r.pose.t - poses[r.frame][1]) < 5e-3
    assert progress[-1] == (1.0, "Done") and kps.shape[0] > 50
    assert_nothing_leaked()
    print("ran the tracker and optical-flow threads without jax")
    """
)


SEGMENTS = REFUSE_JAX + textwrap.dedent(
    """
    import time

    import numpy as np
    import torch

    torch.set_num_threads(1)

    import polychase_tpu_torch.polychase_core as pc
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.parallel.analyze import sharded_lk_multi_feat
    from polychase_tpu_torch.parallel.raycast import sharded_raycast_flat
    from polychase_tpu_torch.parallel.segments import refine_segments
    from polychase_tpu_torch.parallel.sharded import sharded_normal_equations
    from polychase_tpu_torch.parallel.tracking import track_segments
    from polychase_tpu_torch.runtime.threads import RefineSegmentsThread
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, uv_sphere,
    )

    assert pc.RefineSegmentsThread is RefineSegmentsThread
    assert all(callable(f) for f in (
        refine_segments, track_segments, sharded_lk_multi_feat,
        sharded_raycast_flat, sharded_normal_equations))
    verts, tris = uv_sphere(12, 16)
    poses = orbit_poses(10)
    intr = pc.CameraIntrinsics(600, 600, 320, 240, 1, 640, 480,
                               pc.CameraConvention.OpenCV)
    mesh = pc.AcceleratedMesh(verts, tris)

    def seeded(a, b, filled):
        traj = pc.CameraTrajectory(a, b - a + 1)
        for f in range(a, b + 1 if filled else a + 1):
            traj.set(f, pc.CameraState(intr, pc.Pose(*poses[f])))
        return traj

    with tempfile.TemporaryDirectory() as td:
        db = os.path.join(td, "flow.db")
        build_flow_db(db, Mesh.create(verts, tris, device="cpu"), 600.0,
                      640, 480, poses, np.random.default_rng(0), 96, 0.0)
        tracked = [seeded(0, 4, False), seeded(5, 9, False)]
        counts = pc.track_segments(db, tracked, np.eye(4), mesh,
                                   device="cpu")
        refined = [seeded(0, 4, True), seeded(5, 9, True)]
        split = seeded(0, 9, True)
        pc.refine_trajectory(db, split, np.eye(4), mesh, False, False, None,
                             device=["cpu"] * 2)
        thread = RefineSegmentsThread(db, refined, np.eye(4), mesh, False,
                                      False, pc.BundleOptions(),
                                      device="cpu")
        msgs, deadline = [], time.monotonic() + 60
        while (msg := thread.try_pop()) is not True:
            assert time.monotonic() < deadline, "no done message in 60 s"
            if isinstance(msg, Exception):
                raise msg
            if msg is None:
                time.sleep(0.005)
            else:
                msgs.append(msg)
        thread.join()
    assert counts.shape == (2, 4) and (counts >= 3).all(), counts
    for traj in tracked:
        for f in range(traj.first_frame(), traj.last_frame() + 1):
            assert np.linalg.norm(traj.get(f).pose.t - poses[f][1]) < 5e-3
    assert [m.message for m in msgs] == ["Refining 2 segments in parallel"]
    for traj in refined + [split]:
        for f in range(traj.first_frame(), traj.last_frame() + 1):
            assert np.linalg.norm(traj.get(f).pose.t - poses[f][1]) < 5e-3
    assert_nothing_leaked()
    print("tracked and refined segments without jax")
    """
)


ANALYZE_ROUTES = REFUSE_JAX + textwrap.dedent(
    """
    import numpy as np
    import torch

    torch.set_num_threads(1)

    from polychase_tpu_torch.engine import gftt, lk
    from polychase_tpu_torch.engine.opticalflow import (
        VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.io.database import Database
    from polychase_tpu_torch.kernels import gftt_suppress
    from polychase_tpu_torch.parallel.analyze import (
        sharded_lk_chain_phase, sharded_lk_chain_prep,
    )
    from polychase_tpu_torch.synthetic import panning_clip

    assert callable(gftt_suppress.gftt_suppress)
    assert callable(sharded_lk_chain_prep) and callable(sharded_lk_chain_phase)
    os.environ["POLYCHASE_LK_CHAIN"] = "1"
    gftt.DEVICE_SUPPRESS_MIN = 0
    lk.FEAT_SHARD_MIN = 1
    frames = panning_clip(np.random.default_rng(0), 6, 128, 96, (2, 1))
    dbs = []
    with tempfile.TemporaryDirectory() as td:
        for device in ("cpu", ["cpu"] * 2):
            path = os.path.join(td, f"flow{len(dbs)}.db")
            generate_optical_flow_database(
                VideoInfo(128, 96, 0, 6), lambda f: frames[f], None, path,
                device=device)
            db = Database(path)
            dbs.append([(db.read_keypoints(f),
                         db.read_image_pair_flow(f, f + 1).tgt_kps)
                        for f in range(5)])
            db.close()
    for (k0, t0), (k1, t1) in zip(*dbs):
        assert k0.shape[0] > 50
        np.testing.assert_array_equal(k0, k1)
        np.testing.assert_array_equal(t0, t1)
    assert gftt.resumed_frames == 0
    assert_nothing_leaked()
    print("analyzed on the device route, chained, without jax")
    """
)


IMPORT_ALL = REFUSE_JAX + textwrap.dedent(
    """
    import importlib
    import importlib.util
    import pkgutil

    # The add-on's modules import bpy: the behavioral fake stands in.
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import fake_bpy

    fake_bpy.install(fake_bpy.FakeScene())

    import polychase_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        polychase_tpu_torch.__path__, "polychase_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    addon = [n for n in names
             if n.startswith("polychase_tpu_torch.blender_addon.")]
    assert len(addon) == 19, addon
    import chip_smoke  # noqa: F401

    spec = importlib.util.spec_from_file_location(
        "generate_stubs_torch", os.path.join("scripts",
                                             "generate_stubs_torch.py"))
    stubs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stubs)
    assert "class AcceleratedMesh" in stubs.main()

    assert_nothing_leaked()
    print("imported", len(names), "modules and chip_smoke without jax")
    """
)

# What must import neither jax nor the JAX package: the port, its add-on
# and the scripts that package it or run it on the card.
NO_JAX_FILES = ["chip_smoke.py", "scripts/package_addon_torch.py",
                "scripts/generate_stubs_torch.py"]


def _imported_roots(path):
    """The top-level names of the absolute imports of a source file."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _run(script):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_port_runs_without_jax():
    proc = _run(SCRIPT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "tracked 7 frames without jax" in proc.stdout


def test_port_analyzes_without_jax():
    proc = _run(ANALYZE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analyzed 22 pairs without jax" in proc.stdout


def test_port_refines_and_pins_without_jax():
    proc = _run(REFINE_AND_PIN)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "refined and pinned without jax" in proc.stdout


def test_port_threads_run_without_jax():
    proc = _run(SURFACE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("ran the tracker and optical-flow threads without jax"
            in proc.stdout)


def test_port_segments_run_without_jax():
    proc = _run(SEGMENTS)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "tracked and refined segments without jax" in proc.stdout


def test_port_analyze_routes_run_without_jax():
    proc = _run(ANALYZE_ROUTES)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analyzed on the device route, chained, without jax" in proc.stdout


def test_every_module_and_chip_smoke_import_without_jax():
    proc = _run(IMPORT_ALL)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "modules and chip_smoke without jax" in proc.stdout


def test_no_source_imports_jax_or_the_jax_package():
    """No module of the port (its add-on copy included) and none of the
    scripts that package it or drive it on the card names jax, jaxlib or
    ``polychase_tpu`` in an import statement."""
    files = list(NO_JAX_FILES)
    for root, _, names in os.walk(os.path.join(REPO, "polychase_tpu_torch")):
        files += [os.path.relpath(os.path.join(root, n), REPO)
                  for n in names if n.endswith(".py")]
    assert any("blender_addon" in f for f in files)
    for path in files:
        bad = _imported_roots(os.path.join(REPO, path)) & {
            "jax", "jaxlib", "polychase_tpu"}
        assert not bad, (path, bad)
