"""The port runs with jax unimportable: a tiny track, a tiny analyze, and a
tiny refine followed by a pin drag, each in a fresh process whose import
system refuses ``jax`` and ``jaxlib``."""

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

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError(f"{name} is refused in this process")
            return None

    sys.meta_path.insert(0, RefuseJax())
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
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, uv_sphere,
    )

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
    leaked = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    assert not leaked, leaked
    print("tracked", len(got), "frames without jax")
    """
)


ANALYZE = REFUSE_JAX + textwrap.dedent(
    """
    import numpy as np
    import torch

    torch.set_num_threads(1)

    from polychase_tpu.io.database import Database
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
    leaked = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    assert not leaked, leaked
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
    leaked = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    assert not leaked, leaked
    print("refined and pinned without jax")
    """
)


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
