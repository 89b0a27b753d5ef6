"""The port's ``polychase_core`` facade against the JAX package's.

- The manifest of ``test_api_parity.py`` (25 classes, 5 functions, the
  enums and defaults) run against the port's facade.
- The single-device free-function cases of ``test_api.py``, each held
  against the JAX facade on the same inputs: ``ray_cast`` primitive ids
  equal and hit positions within 1e-5, on the host BVH and on the device
  route; a 1-pin drag within 1e-6 (both run the same float64 host math).
- The pin route at both packages' defaults: 3 to 8 surface pins of config
  2's scene, focal free or fixed, Camera and Model drags.  Both packages
  solve them on their float64 host routes (up to ``pinmode.HOST_PIN_MAX``
  = 4096 points), so the matrices agree within 1e-6.  The float32 device
  route leaves the reference's answer by more than 1e-4 at 4 to 8 pins
  (``tests/pin_route_scan.py``).
- Without a card, every free function called with no ``device`` raises
  ``CppException``, and nothing runs on the CPU.  With two cards visible,
  no ``device`` is both cards for analyze and refine and the first for
  tracking and pin drags; a device list (``["cpu"] * 2``) gives analyze's
  one-device DB to the bit and refine's poses within 2e-3 rad and 4e-3.
- The extensions: the facade's ``__all__`` equals the JAX package's,
  ``device_count()`` is 0 without a card, and ``track_segments`` /
  ``refine_segments`` with ``device="cpu"`` give the engine calls'
  results within 1e-6 (the same computation, so in fact to the bit).
"""

import numpy as np
import pytest
import torch

import polychase_tpu.polychase_core as jpc
from polychase_tpu.engine import pose as JP

import polychase_tpu_torch.polychase_core as pc
from polychase_tpu_torch.engine import pinmode as TPM
from polychase_tpu_torch.engine.pose import quat_to_mat_np
from polychase_tpu_torch.kernels import pnp_lm
from polychase_tpu_torch.synthetic import orbit_poses, surface_pins, uv_sphere

from synthetic import make_sphere_mesh, orbit_pose
from test_api_parity import CLASSES, FUNCTIONS

torch.set_num_threads(1)

CPU = "cpu"
POS_ATOL = 1e-5
JAX_ATOL = 1e-6
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1800.0


# ---------------------------------------------------------------------------
# The manifest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_surface(name):
    ctor, attrs, methods = CLASSES[name]
    cls = getattr(pc, name, None)
    assert cls is not None, f"polychase_core.{name} missing"
    for meth in methods:
        assert callable(getattr(cls, meth, None)), f"{name}.{meth} missing"
    if ctor is not None and attrs:
        obj = cls(*ctor())
        for attr in attrs:
            assert hasattr(obj, attr), f"{name}.{attr} missing"
    elif attrs:
        for attr in attrs:
            ok = (
                hasattr(cls, attr)
                or attr in getattr(cls, "__annotations__", {})
                or attr in getattr(cls, "_fields", ())
                or "__init__" in cls.__dict__
            )
            assert ok, f"{name}.{attr} unreachable"


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_signatures(name):
    import inspect

    fn = getattr(pc, name, None)
    assert callable(fn), f"polychase_core.{name} missing"
    sig = inspect.signature(fn)
    params = list(sig.parameters)
    prefix = FUNCTIONS[name]
    assert params[: len(prefix)] == prefix, (
        f"{name} argument order {params} != {prefix}"
    )
    # The one addition: a trailing keyword-only device, the card by default.
    extra = [sig.parameters[p] for p in params[len(prefix):]]
    assert [(p.name, p.kind, p.default) for p in extra] == [
        ("device", inspect.Parameter.KEYWORD_ONLY, None)]


def test_enums_and_defaults():
    assert hasattr(pc.TransformationType, "Camera")
    assert hasattr(pc.TransformationType, "Model")
    assert hasattr(pc.CameraConvention, "OpenGL")
    assert hasattr(pc.CameraConvention, "OpenCV")
    for member in ("Trivial", "Huber", "Cauchy"):
        assert hasattr(pc.LossType, member)
    for a, b in ((pc.BundleOptions(), jpc.BundleOptions()),
                 (pc.GFTTOptions(), jpc.GFTTOptions()),
                 (pc.OpticalFlowOptions(), jpc.OpticalFlowOptions())):
        want = {k: (v.name if hasattr(v, "name") else v)
                for k, v in vars(b).items()}
        got = {k: (v.name if hasattr(v, "name") else v)
               for k, v in vars(a).items()}
        assert got == want
    assert repr(pc.BundleStats(3, 2.0, 1.0, 1e-5)) == repr(
        jpc.BundleStats(3, 2.0, 1.0, 1e-5))


# ---------------------------------------------------------------------------
# Free functions against the JAX facade
# ---------------------------------------------------------------------------


def _intrinsics(mod, w=640, h=480, f=600.0):
    return mod.CameraIntrinsics(
        fx=f, fy=f, cx=w / 2, cy=h / 2, aspect_ratio=1.0,
        width=w, height=h, convention=mod.CameraConvention.OpenCV,
    )


def _scene(mod, view, model=None, **kw):
    return mod.SceneTransformations(
        model_matrix=np.eye(4, dtype=np.float32) if model is None else model,
        view_matrix=view, intrinsics=_intrinsics(mod, **kw),
    )


@pytest.fixture
def meshes():
    m = make_sphere_mesh()
    v, t = np.asarray(m.vertices), np.asarray(m.triangles)
    return jpc.AcceleratedMesh(v, t), pc.AcceleratedMesh(v, t)


def _cast(mod, mesh, scene, px, check_mask, route):
    if route == "device":
        mesh._bvh_tried = True  # no BVH: the batched device cast
    kw = {} if mod is jpc else dict(device=CPU)
    return mod.ray_cast(mesh, scene, px, check_mask, **kw)


def _same_hit(got, ref):
    assert (got is None) == (ref is None)
    if ref is not None:
        assert got.primitive_id == ref.primitive_id
        np.testing.assert_allclose(got.pos, ref.pos, atol=POS_ATOL)
        np.testing.assert_allclose(got.t, ref.t, atol=POS_ATOL)
        np.testing.assert_allclose(got.barycentric_coordinate,
                                   ref.barycentric_coordinate, atol=POS_ATOL)


@pytest.mark.parametrize("route", ["host", "device"])
def test_ray_cast_and_masking(meshes, route):
    jmesh, tmesh = meshes
    view = np.asarray(JP.pose_rt4x4(orbit_pose(0.0)))
    jscene, tscene = _scene(jpc, view), _scene(pc, view)
    centre = np.array([320.0, 240.0])
    hit = _cast(pc, tmesh, tscene, centre, True, route)
    assert hit is not None
    assert abs(np.linalg.norm(hit.pos) - 1.0) < 0.05
    assert hit.t > 0
    _same_hit(hit, _cast(jpc, jmesh, jscene, centre, True, route))
    prim = hit.primitive_id

    # Mask the hit triangle: the same ray misses (masked tris still
    # occlude); check_mask=False sees it again.
    for m in (jmesh, tmesh):
        m.inner_mut().mask_triangle(prim)
    assert tmesh.inner().is_triangle_masked(prim)
    hit2 = _cast(pc, tmesh, tscene, centre, True, route)
    assert hit2 is None or hit2.primitive_id != prim
    _same_hit(hit2, _cast(jpc, jmesh, jscene, centre, True, route))
    hit3 = _cast(pc, tmesh, tscene, centre, False, route)
    assert hit3 is not None and hit3.primitive_id == prim
    _same_hit(hit3, _cast(jpc, jmesh, jscene, centre, False, route))
    # More picks over the sphere, hits and misses.
    for px in np.random.default_rng(0).uniform((150, 60), (490, 420),
                                               (16, 2)):
        _same_hit(_cast(pc, tmesh, tscene, px, False, route),
                  _cast(jpc, jmesh, jscene, px, False, route))


def _same_scene(got, ref, atol):
    np.testing.assert_allclose(got.model_matrix, ref.model_matrix, atol=atol)
    np.testing.assert_allclose(got.view_matrix, ref.view_matrix, atol=atol)
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_allclose(getattr(got.intrinsics, f),
                                   getattr(ref.intrinsics, f),
                                   rtol=atol, atol=atol)
    assert got.intrinsics.convention.name == ref.intrinsics.convention.name


def test_find_transformation_api():
    view = np.asarray(JP.pose_rt4x4(orbit_pose(0.0)))
    pts = np.array([[0.0, 0.0, -1.0]], np.float32)
    out = {}
    for mod in (jpc, pc):
        scene = _scene(mod, view)
        kw = {} if mod is jpc else dict(device=CPU)
        out[mod] = mod.find_transformation(
            pts, scene, scene,
            mod.PinUpdate(0, np.array([300.0, 220.0], np.float32)),
            mod.TransformationType.Model, **kw)
    assert isinstance(out[pc], pc.SceneTransformations)
    assert not np.allclose(out[pc].model_matrix, np.eye(4))
    _same_scene(out[pc], out[jpc], JAX_ATOL)


@pytest.fixture(scope="module")
def config2():
    """Config 2's scene: the 24×32 sphere seen from the orbit clip's first
    frame at 1920×1080, f = 1800, and the view matrix of that frame."""
    from polychase_tpu_torch.engine.geometry import Mesh

    q, t = orbit_poses(1)[0]
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(q)
    view[:3, 3] = t
    return Mesh.create(*uv_sphere(24, 32), device=CPU), (q, t), view


_PIN_DIFFS = {}


@pytest.mark.parametrize("trans_type", ["Camera", "Model"])
@pytest.mark.parametrize("opt_f", [False, True])
@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_pin_route_matches_reference(config2, n, opt_f, trans_type):
    """Both facades at their defaults: each route as it stands, one drag of
    pin 2 as config 2 drags it."""
    mesh, pose, view = config2
    pins = surface_pins(mesh, pose, FOCAL, WIDTH, HEIGHT,
                        np.random.default_rng(n), n)
    assert pins.shape == (n, 3)
    kw = dict(w=WIDTH, h=HEIGHT, f=FOCAL)
    out = {}
    before = pnp_lm.launches
    for mod in (jpc, pc):
        scene = _scene(mod, view, **kw)
        extra = {} if mod is jpc else dict(device=CPU)
        out[mod] = mod.find_transformation(
            pins, scene, scene,
            mod.PinUpdate(2, np.array([955.0, 542.0], np.float32)),
            getattr(mod.TransformationType, trans_type), opt_f, False,
            **extra)
    assert pnp_lm.launches == before  # CPU: the plain version, if any
    diff = max(float(np.abs(out[pc].model_matrix
                            - out[jpc].model_matrix).max()),
               float(np.abs(out[pc].view_matrix
                            - out[jpc].view_matrix).max()))
    _PIN_DIFFS[(n, opt_f, trans_type)] = diff
    route = "host" if n <= TPM.HOST_PIN_MAX else "device"
    print(f"{n} pins, opt_f={opt_f}, {trans_type}: port's {route} route, "
          f"largest matrix difference {diff:.3g} (largest so far "
          f"{max(_PIN_DIFFS.values()):.3g})")
    _same_scene(out[pc], out[jpc], JAX_ATOL)


def test_pose_quaternion_convention():
    from polychase_tpu_torch.engine import pose as TP

    p = pc.Pose()
    np.testing.assert_array_equal(p.q, [1, 0, 0, 0])  # identity, w first
    p.q = np.array([0.0, 1.0, 0.0, 0.0], np.float32)  # 180° about x
    v = TP.quat_rotate(p._to_engine().q, torch.tensor([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(v.numpy(), [0, 0, -1], atol=1e-6)
    jp = jpc.Pose(p.q, [0.1, 0.2, 0.3])
    tp = pc.Pose(p.q, [0.1, 0.2, 0.3])
    assert repr(tp) == repr(jp)
    back = pc.Pose._from_engine(tp._to_engine())
    np.testing.assert_array_equal(back.q, tp.q)
    np.testing.assert_array_equal(back.t, tp.t)


def test_engine_errors_surface_as_cpp_exception(tmp_path):
    """The pybind contract: engine failures raise CppException
    (cpp/polychase_pybind.cc:311-312), in both facades."""
    db_path = str(tmp_path / "empty.db")
    pc.Database(db_path).close()
    for mod in (jpc, pc):
        st = mod.SceneTransformations(
            model_matrix=np.eye(4, dtype=np.float32),
            view_matrix=np.eye(4, dtype=np.float32),
            intrinsics=mod.CameraIntrinsics(
                100.0, 100.0, 50.0, 50.0, 1.0, 100, 100,
                mod.CameraConvention.OpenCV,
            ),
        )
        mesh = mod.AcceleratedMesh(
            np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.uint32)
        )
        kw = {} if mod is jpc else dict(device=CPU)
        with pytest.raises(mod.CppException):
            # no flows in the database -> tracker raises
            mod.track_sequence(db_path, 0, 3, st, mesh, lambda r: True, **kw)


def test_camera_trajectory_keeps_metadata():
    """A trajectory hands back the intrinsics' width, height and
    convention as they were set, as the reference's does."""
    for mod in (jpc, pc):
        traj = mod.CameraTrajectory(5, 3)
        assert (traj.count(), traj.first_frame(), traj.last_frame()) == (
            3, 5, 7)
        state = mod.CameraState(_intrinsics(mod, w=1001, h=777),
                                mod.Pose([1, 0, 0, 0], [0.5, 0.0, 2.0]))
        traj.set(6, state)
        assert traj.is_frame_filled(6) and not traj.is_frame_filled(5)
        assert not traj.is_valid_frame(8)
        got = traj.get(6)
        assert (got.intrinsics.width, got.intrinsics.height) == (1001, 777)
        assert got.intrinsics.convention.name == "OpenCV"
        np.testing.assert_array_equal(got.pose.t, [0.5, 0.0, 2.0])
        assert traj.get(5) is None


# ---------------------------------------------------------------------------
# The card is the default, with no fallback
# ---------------------------------------------------------------------------


def test_free_functions_refuse_without_card(tmp_path, monkeypatch):
    """No device and no card: CppException from each free function, and
    no kernel or plain version runs."""
    from polychase_tpu_torch.engine import (
        opticalflow, pinmode, raycast, refiner, tracker,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for eng, fn in ((pinmode, "find_transformation"),
                    (tracker, "track_sequence"),
                    (refiner, "refine_trajectory"),
                    (opticalflow, "generate_optical_flow_database"),
                    (raycast, "raycast")):
        monkeypatch.setattr(eng, fn, lambda *a, _fn=fn, **k: ran.append(_fn))
    monkeypatch.setattr(pc.AcceleratedMesh, "_native_bvh",
                        lambda self: ran.append("bvh"))
    accel = pc.AcceleratedMesh(np.zeros((3, 3), np.float32),
                               np.array([[0, 1, 2]], np.uint32))
    scene = _scene(pc, np.eye(4, dtype=np.float32))
    db = str(tmp_path / "flow.db")
    traj = pc.CameraTrajectory(0, 3)
    calls = {
        "ray_cast": lambda: pc.ray_cast(accel, scene, [320.0, 240.0], True),
        "find_transformation": lambda: pc.find_transformation(
            np.zeros((3, 3), np.float32), scene, scene,
            pc.PinUpdate(0, [1.0, 2.0]), pc.TransformationType.Camera),
        "generate_optical_flow_database":
            lambda: pc.generate_optical_flow_database(
                pc.VideoInfo(16, 16, 0, 2), lambda f: None, None, db),
        "track_sequence": lambda: pc.track_sequence(
            db, 0, 2, scene, accel, None),
        "refine_trajectory": lambda: pc.refine_trajectory(
            db, traj, np.eye(4), accel, False, False, None),
    }
    assert set(calls) == set(FUNCTIONS)
    for name, call in calls.items():
        with pytest.raises(pc.CppException, match="no CUDA device"):
            call()
    assert ran == []


class _Recorded(RuntimeError):
    pass


@pytest.mark.parametrize("fn", ["find_transformation",
                                "generate_optical_flow_database",
                                "refine_trajectory", "track_sequence"])
def test_none_is_every_card_for_analyze_and_refine(tmp_path, monkeypatch,
                                                    fn):
    """With two cards visible and no device: analyze and refine get every
    card, as the JAX package shards them over ``jax.devices()``; tracking
    and pin drags keep one (the engine calls are stubbed)."""
    from polychase_tpu_torch.engine import (
        opticalflow, pinmode, refiner, tracker,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    seen = {}

    def record(name):
        def stub(*a, device, **k):
            seen[name] = device
            raise _Recorded
        return stub

    for eng, name in ((pinmode, "find_transformation"),
                      (tracker, "track_sequence"),
                      (refiner, "refine_trajectory"),
                      (opticalflow, "generate_optical_flow_database")):
        monkeypatch.setattr(eng, name, record(name))
    monkeypatch.setattr(pc.AcceleratedMesh, "_to_engine",
                        lambda self, device: seen.setdefault("mesh", device))
    accel = pc.AcceleratedMesh(np.zeros((3, 3), np.float32),
                               np.array([[0, 1, 2]], np.uint32))
    scene = _scene(pc, np.eye(4, dtype=np.float32))
    db = str(tmp_path / "flow.db")
    calls = {
        "find_transformation": lambda: pc.find_transformation(
            np.zeros((TPM.HOST_PIN_MAX + 1, 3), np.float32), scene, scene,
            pc.PinUpdate(0, [1.0, 2.0]), pc.TransformationType.Camera),
        "generate_optical_flow_database":
            lambda: pc.generate_optical_flow_database(
                pc.VideoInfo(16, 16, 0, 2), lambda f: None, None, db),
        "track_sequence": lambda: pc.track_sequence(
            db, 0, 2, scene, accel, None),
        "refine_trajectory": lambda: pc.refine_trajectory(
            db, pc.CameraTrajectory(0, 3), np.eye(4), accel, False, False,
            None),
    }
    with pytest.raises(pc.CppException):
        calls[fn]()
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    if fn in ("generate_optical_flow_database", "refine_trajectory"):
        assert seen[fn] == cards
    else:
        assert seen[fn] == cards[0]
    if "mesh" in seen:
        assert seen["mesh"] == cards[0]  # the mesh lives on the first card


def _analyze_db(path):
    """An analyze DB's keypoints and flows, for equality checks."""
    db = pc.Database(path)
    try:
        return [(db.read_keypoints(f), [
            (g, db.read_image_pair_flow(f, g).src_kps_indices,
             db.read_image_pair_flow(f, g).tgt_kps)
            for g in db.find_optical_flows_from_image(f)])
            for f in range(db.get_max_image_id_with_keypoints() + 1)]
    finally:
        db.close()


def _assert_same(a, b):
    assert len(a) == len(b)
    for (ka, fa), (kb, fb) in zip(a, b):
        np.testing.assert_array_equal(ka, kb)
        assert [g for g, _, _ in fa] == [g for g, _, _ in fb]
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x[1], y[1])
            np.testing.assert_array_equal(x[2], y[2])


@pytest.mark.parametrize("fn", ["generate_optical_flow_database",
                                "refine_trajectory"])
def test_analyze_and_refine_on_a_device_list(tmp_path, fn):
    """A list of one device gives the one-device result to the bit; a
    device list, ``["cpu"] * 2``, splits the work and gives the one-device
    results: analyze's DB to the bit, refine's poses within 2e-3 rad and
    4e-3 (test_sharded.py's bars)."""
    lists = {"one": CPU, "list of one": [CPU], "two": [CPU, CPU]}
    if fn == "generate_optical_flow_database":
        from polychase_tpu_torch.synthetic import panning_clip

        frames = panning_clip(np.random.default_rng(0), 4, 160, 120, (3, 2))
        info = pc.VideoInfo(160, 120, 0, 4)
        dbs = {}
        for name, device in lists.items():
            pc.generate_optical_flow_database(
                info, lambda f: frames[f], None, str(tmp_path / name),
                device=device)
            dbs[name] = _analyze_db(str(tmp_path / name))
        assert len(dbs["one"]) == 4
        _assert_same(dbs["list of one"], dbs["one"])
        _assert_same(dbs["two"], dbs["one"])
        return
    db = str(tmp_path / "flow.db")
    v, t, poses, intr = segment_scene(db)
    opts = pc.BundleOptions()
    opts.max_iterations = 8
    mesh = pc.AcceleratedMesh(v, t)
    out = {}
    for name, device in lists.items():
        out[name] = segment_trajectories(poses, intr, filled=True)[0]
        pc.refine_trajectory(db, out[name], np.eye(4), mesh, False, False,
                             None, opts, device=device)
    one = out["one"]
    np.testing.assert_array_equal(_traj_poses(out["list of one"]),
                                  _traj_poses(one))
    for f in range(one.first_frame(), one.last_frame() + 1):
        a, b = one.get(f).pose, out["two"].get(f).pose
        assert np.linalg.norm(a.t - b.t) < 4e-3
        assert 2 * np.arccos(min(abs(float(np.dot(a.q, b.q))), 1.0)) < 2e-3
    assert np.abs(_traj_poses(one) - _traj_poses(
        segment_trajectories(poses, intr, filled=True)[0])).max() > 1e-4


# ---------------------------------------------------------------------------
# The extensions: device_count and the segment-parallel paths
# ---------------------------------------------------------------------------

SEG_ATOL = 1e-6
SEG_FRAMES, SEG_BOUNDS = 18, ((0, 5), (6, 11), (12, 17))


def segment_scene(db_path, seed=4):
    """A jax-free 18-frame orbit of a 12×16 sphere at 640×480, f = 600,
    with 96 keypoints a frame and 0.2 px flow noise, written to
    ``db_path``; returns the facade mesh's arrays, the poses and the
    intrinsics."""
    from polychase_tpu_torch.engine.geometry import Mesh as TMesh
    from polychase_tpu_torch.synthetic import build_flow_db

    v, t = uv_sphere(12, 16)
    poses = orbit_poses(SEG_FRAMES)
    build_flow_db(db_path, TMesh.create(v, t, device=CPU), 600.0, 640, 480,
                  poses, np.random.default_rng(seed), 96, 0.2)
    return v, t, poses, _intrinsics(pc)


def segment_trajectories(poses, intr, filled: bool, seed=9):
    """Facade trajectories over ``SEG_BOUNDS``: seeded at their first
    frame, or filled with N(0, 0.004) noise on every translation but the
    segment's first and last."""
    rng = np.random.default_rng(seed)
    out = []
    for a, b in SEG_BOUNDS:
        traj = pc.CameraTrajectory(a, b - a + 1)
        for f in range(a, b + 1 if filled else a + 1):
            q, t = poses[f]
            if f not in (a, b):
                t = t + rng.normal(0, 0.004, 3).astype(np.float32)
            traj.set(f, pc.CameraState(intr, pc.Pose(q, t)))
        out.append(traj)
    return out


def _traj_poses(traj):
    return np.stack([np.concatenate([traj.get(f).pose.q, traj.get(f).pose.t])
                     for f in range(traj.first_frame(), traj.last_frame() + 1)
                     if traj.is_frame_filled(f)])


@pytest.fixture(scope="module")
def seg_scene(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("segments") / "flow.db")
    return (db, *segment_scene(db))


def test_extensions_complete_the_surface():
    assert pc.__all__ == jpc.__all__
    import inspect

    for name in ("device_count", "track_segments", "refine_segments"):
        ref = list(inspect.signature(getattr(jpc, name)).parameters.values())
        got = list(inspect.signature(getattr(pc, name)).parameters.values())
        assert [(p.name, p.default) for p in got[:len(ref)]] == [
            (p.name, p.default) for p in ref]
        assert [(p.name, p.kind, p.default) for p in got[len(ref):]] == (
            [] if name == "device_count" else
            [("device", inspect.Parameter.KEYWORD_ONLY, None)])
    assert callable(pc.RefineSegmentsThread)
    assert pc.device_count() == torch.cuda.device_count() == 0


def test_track_segments_facade_matches_engine(seg_scene):
    from polychase_tpu_torch.engine.levmarq import CAUCHY, BundleOptions
    from polychase_tpu_torch.parallel.tracking import track_segments

    db, v, t, poses, intr = seg_scene
    mesh = pc.AcceleratedMesh(v, t)
    facade = segment_trajectories(poses, intr, filled=False)
    engine = segment_trajectories(poses, intr, filled=False)
    counts = pc.track_segments(db, facade, np.eye(4), mesh, device=CPU)
    ref = track_segments(db, [tr._traj for tr in engine], np.eye(4),
                         mesh._to_engine(torch.device(CPU)),
                         bundle_opts=BundleOptions(loss_type=CAUCHY),
                         device=CPU)
    np.testing.assert_array_equal(counts, ref)
    assert counts.shape == (3, 5) and (counts >= 3).all()
    for a, b in zip(facade, engine):
        assert all(a.is_frame_filled(f)
                   for f in range(a.first_frame(), a.last_frame() + 1))
        np.testing.assert_allclose(_traj_poses(a), _traj_poses(b),
                                   atol=SEG_ATOL)
        assert (a.get(a.last_frame()).intrinsics.width,
                a.get(a.last_frame()).intrinsics.height) == (640, 480)


def test_refine_segments_facade_matches_engine(seg_scene):
    from polychase_tpu_torch.parallel.segments import refine_segments

    db, v, t, poses, intr = seg_scene
    mesh = pc.AcceleratedMesh(v, t)
    opts = pc.BundleOptions()
    opts.max_iterations = 8
    facade = segment_trajectories(poses, intr, filled=True)
    engine = segment_trajectories(poses, intr, filled=True)
    before = [_traj_poses(tr) for tr in facade]
    assert pc.refine_segments(db, facade, np.eye(4), mesh, False, False,
                              opts, device=CPU) is None
    ref = refine_segments(db, [tr._traj for tr in engine], np.eye(4),
                          mesh._to_engine(torch.device(CPU)),
                          bundle_opts=opts._to_engine(), device=CPU)
    for a, b, start in zip(facade, ref, before):
        got = _traj_poses(a)
        want = np.stack([np.concatenate([b.get(f).pose.q.numpy(),
                                         b.get(f).pose.t.numpy()])
                         for f in range(b.first_frame, b.last_frame + 1)])
        np.testing.assert_allclose(got, want, atol=SEG_ATOL)
        assert np.abs(got - start).max() > 1e-4  # it moved
        np.testing.assert_array_equal(got[[0, -1]], start[[0, -1]])


def test_segment_extensions_refuse_without_card(seg_scene, monkeypatch):
    from polychase_tpu_torch.parallel import segments, tracking

    db, v, t, poses, intr = seg_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for mod, fn in ((tracking, "track_segments"),
                    (segments, "refine_segments")):
        monkeypatch.setattr(mod, fn, lambda *a, _fn=fn, **k: ran.append(_fn))
    mesh = pc.AcceleratedMesh(v, t)
    for call in (
            lambda: pc.track_segments(
                db, segment_trajectories(poses, intr, False), np.eye(4),
                mesh),
            lambda: pc.refine_segments(
                db, segment_trajectories(poses, intr, True), np.eye(4),
                mesh, False, False)):
        with pytest.raises(pc.CppException, match="no CUDA device"):
            call()
    assert ran == []
