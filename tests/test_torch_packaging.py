"""The port's release artifacts: the wheel (the host library's source, the
five CUDA sources, the polychase_core stub, py.typed and the port's console
scripts), the wheel installed outside a checkout building its host library
into the user's cache with jax refused, the add-on zip (the manifest at the
root, the whole port, nothing of ``polychase_tpu``, a shim that registers
under a stubbed bpy with jax refused) and the stub in sync with the
facade's ``__all__`` (tests/test_packaging.py's checks, for the port)."""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
import zipfile

import pytest

from test_torch_nojax import REFUSE_JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA_SOURCES = ["pnp_lm.cu", "lk_prep.cu", "lk_iter.cu", "gftt_suppress.cu",
                "raycast_sweep.cu", "grid_cast.cu"]
SCRIPTS = {
    "polychase-torch-generate-database":
        "polychase_tpu_torch.cli.generate_database:main",
    "polychase-torch-visualize-flow":
        "polychase_tpu_torch.cli.visualize_flow:main",
}
RELEASE_FILES = (
    ["polychase_tpu_torch/native/host.cc",
     "polychase_tpu_torch/polychase_core.pyi",
     "polychase_tpu_torch/py.typed"]
    + [f"polychase_tpu_torch/csrc/{name}" for name in CUDA_SOURCES]
)


def _clean_env(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["HOME"] = str(tmp_path / "home")
    env["XDG_CACHE_HOME"] = str(tmp_path / "cache")
    return env


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The wheel built from a copy of the tree (so that no build directory
    is shared with another test's build of the checkout)."""
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    ignore = shutil.ignore_patterns("__pycache__", "*.so", "*.pyc")
    for name in ("polychase_tpu", "polychase_tpu_torch"):
        shutil.copytree(os.path.join(REPO, name), src / name, ignore=ignore)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(REPO, name), src / name)
    r = subprocess.run(
        [sys.executable, "-m", "build", "--wheel", "--no-isolation",
         "--outdir", str(tmp / "dist"), str(src)],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = list((tmp / "dist").glob("polychase_tpu-*.whl"))
    assert len(wheels) == 1
    return wheels[0]


def test_wheel_ships_the_ports_release_files(wheel):
    zf = zipfile.ZipFile(wheel)
    names = zf.namelist()
    for name in RELEASE_FILES:
        assert name in names, name
    assert "polychase_tpu_torch/blender_addon/addon.py" in names
    entry_points = next(n for n in names if n.endswith("entry_points.txt"))
    text = zf.read(entry_points).decode()
    for script, target in SCRIPTS.items():
        assert f"{script} = {target}" in text, text
    assert "polychase-generate-database = " in text  # the reference's stay


def test_wheel_outside_a_checkout_builds_into_the_user_cache(wheel, tmp_path):
    """Installed from the wheel, with jax refused, the port finds its
    ``host.cc``, builds it with g++ into ``$XDG_CACHE_HOME`` (else
    ``~/.cache``) and loads it; its kernels would build there too."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host library")
    site = tmp_path / "site"
    zipfile.ZipFile(wheel).extractall(site)
    cache = tmp_path / "cache" / "polychase_tpu_torch"
    code = REFUSE_JAX + f"""
sys.path.insert(0, {str(site)!r})
from pathlib import Path
import polychase_tpu_torch
from polychase_tpu_torch import native
from polychase_tpu_torch.kernels import build
assert polychase_tpu_torch.__file__.startswith({str(site)!r})
assert native.available(), "the host library did not build"
assert native.library_path().parent == Path({str(cache)!r}) / "torch_native"
assert native.library_path().is_file()
assert build.BUILD_DIR == Path({str(cache)!r}) / "torch_kernels"
del os.environ["XDG_CACHE_HOME"]
assert build.build_root() == (
    Path(os.environ["HOME"]) / ".cache" / "polychase_tpu_torch")
assert_nothing_leaked()
print("WHEEL_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env=_clean_env(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "WHEEL_OK" in r.stdout
    assert not (tmp_path / "build").exists()


def test_checkout_builds_under_its_build_directory():
    from polychase_tpu_torch import native
    from polychase_tpu_torch.kernels import build

    root = os.path.join(REPO, "build")
    assert str(build.build_root()) == root
    assert str(build.BUILD_DIR) == os.path.join(root, "torch_kernels")
    assert str(native.BUILD_DIR) == os.path.join(root, "torch_native")


def test_addon_zip_vendors_the_port_and_registers(tmp_path):
    out = tmp_path / "addon.zip"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "package_addon_torch.py"), str(out)],
        check=True, capture_output=True,
    )
    names = zipfile.ZipFile(out).namelist()
    assert "__init__.py" in names
    assert "blender_manifest.toml" in names  # extension spec: at the root
    for name in RELEASE_FILES + [
            "polychase_tpu_torch/blender_addon/addon.py",
            "polychase_tpu_torch/polychase_core.py"]:
        assert name in names, name
    assert not [n for n in names if n.startswith("polychase_tpu/")]
    assert not [n for n in names if "__pycache__" in n]

    extract = tmp_path / "x"
    zipfile.ZipFile(out).extractall(extract)
    code = REFUSE_JAX + f"""
import importlib.util
from unittest import mock
for name in ["bpy", "bpy.types", "bpy.props", "bpy.utils", "bpy.path",
             "mathutils", "gpu", "gpu.types", "gpu.state", "gpu.shader",
             "gpu_extras", "gpu_extras.batch"]:
    m = mock.MagicMock(name=name)
    m.types.PropertyGroup = type("PG", (), {{}})
    m.types.Operator = type("Op", (), {{}})
    m.types.Panel = type("Pl", (), {{}})
    m.types.UIList = type("UL", (), {{}})
    sys.modules[name] = m
extract = {str(extract)!r}
spec = importlib.util.spec_from_file_location(
    "polychase_torch_addon", os.path.join(extract, "__init__.py"))
shim = importlib.util.module_from_spec(spec)
spec.loader.exec_module(shim)
assert shim.bl_info["name"] == "Polychase (PyTorch + CUDA)"
shim.register()
shim.unregister()
import polychase_tpu_torch
assert polychase_tpu_torch.__file__.startswith(extract)
assert "polychase_tpu_torch.blender_addon.addon" in sys.modules
assert_nothing_leaked()
print("ZIP_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env=_clean_env(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "ZIP_OK" in r.stdout


def test_polychase_core_stub_in_sync():
    """The checked-in stub equals a fresh generation and declares the
    facade's whole ``__all__``."""
    spec = importlib.util.spec_from_file_location(
        "generate_stubs_torch",
        os.path.join(REPO, "scripts", "generate_stubs_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    fresh = gen.main()
    with open(os.path.join(REPO, "polychase_tpu_torch",
                           "polychase_core.pyi")) as f:
        committed = f.read()
    assert committed == fresh, (
        "polychase_core.pyi is stale: rerun scripts/generate_stubs_torch.py")
    tree = ast.parse(committed)
    declared = {
        n.name for n in ast.walk(tree)
        if isinstance(n, (ast.ClassDef, ast.FunctionDef))
    } | {
        n.target.id for n in ast.walk(tree)
        if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
    }
    import polychase_tpu_torch.polychase_core as pc

    missing = set(pc.__all__) - declared
    assert not missing, f"stub missing: {sorted(missing)}"
