#!/usr/bin/env python3
"""Package the PyTorch + CUDA port's Blender add-on as an installable zip.

The layout of ``scripts/package_addon.py`` (the Blender 4.2 extension
spec), with the port in place of the JAX package:

    blender_manifest.toml     <- at the archive ROOT (Blender's extension
                                 installer only looks there)
    __init__.py               <- generated shim: bl_info + register()
    polychase_tpu_torch/...   <- the whole port, including its add-on,
                                 the host library source (native/host.cc),
                                 the CUDA kernel sources (csrc/*.cu), the
                                 polychase_core typing stub and py.typed

The shim puts its own directory on sys.path so ``import
polychase_tpu_torch`` resolves to the vendored copy, then delegates to
``polychase_tpu_torch.blender_addon``.  Nothing of ``polychase_tpu`` is
packed.  torch with CUDA is not vendored: it is installed into Blender's
Python by the user.  The kernels and the host library build at first use
into the user's cache (``kernels.build.build_root``), not beside the
extension.

Usage: python scripts/package_addon_torch.py [out.zip]
"""

import pathlib
import sys
import zipfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "polychase_tpu_torch"
MANIFEST = PKG / "blender_addon" / "blender_manifest.toml"
SKIP_DIRS = {"__pycache__"}
SUFFIXES = (".py", ".cc", ".cu", ".pyi")

SHIM = '''\
"""Polychase (PyTorch + CUDA) Blender add-on (generated loader shim)."""

import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
if _here not in sys.path:
    sys.path.insert(0, _here)

from polychase_tpu_torch.blender_addon import bl_info  # noqa: E402,F401
from polychase_tpu_torch.blender_addon import (  # noqa: E402,F401
    register,
    unregister,
)
'''


def want(path: pathlib.Path) -> bool:
    if any(part in SKIP_DIRS for part in path.parts):
        return False
    return path.suffix in SUFFIXES or path.name == "py.typed"


def main() -> int:
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                       else ROOT / "polychase_torch_blender_addon.zip")
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("__init__.py", SHIM)
        zf.write(MANIFEST, "blender_manifest.toml")
        for f in sorted(PKG.rglob("*")):
            if f.is_file() and want(f.relative_to(PKG)):
                zf.write(f, str(pathlib.Path(PKG.name) / f.relative_to(PKG)))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
