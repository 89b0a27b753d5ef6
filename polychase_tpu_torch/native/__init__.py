"""Host C++ of the port (``host.cc``) with a ctypes loader.

``host.cc`` holds the BVH ray caster (refine's prim refresh on large
meshes), GFTT's fused quality sort + suppression and the quality order of
the device-suppressed GFTT route (:func:`quality_order`).  It is built at first
use with ``g++ -O3 -shared -fPIC -std=c++17`` into ``torch_native/`` under
``kernels.build.build_root()`` (``build/`` in a checkout, else the user's
cache), under a name keyed by a hash of the source (as ``kernels/build.py``
keys the CUDA kernels), so an edit rebuilds and an unchanged source is built
once.  Where no compiler is found or the build fails, :func:`available` is
False and :func:`native_fn` returns None: the callers then take their host
routes (GFTT's numpy finish, refine's device sweep), which compute the same
results, and a warning says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels.build import build_root

SOURCE = Path(__file__).resolve().parent / "host.cc"
BUILD_DIR = build_root() / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
_fns: dict = {}


def library_path() -> Path:
    """Where the library of the current source lives once built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhost_{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError) as exc:
            logging.getLogger(__name__).warning(
                "host library unavailable (%s); host routes in use", exc)
            _failed = True
            return None
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                  ctypes.c_void_p, ctypes.c_uint32]
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        lib.bvh_raycast.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_uint32] + [ctypes.c_void_p] * 6
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded."""
    return _load() is not None


def native_fn(name: str, restype, argtypes):
    """Exported function ``name`` bound with its types, or None when the
    library is unavailable."""
    with _lock:
        if name in _fns:
            return _fns[name]
    lib = _load()
    fn = None
    if lib is not None:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    with _lock:
        _fns[name] = fn
    return fn


def quality_order(vals: np.ndarray, lin: np.ndarray) -> np.ndarray:
    """Order of GFTT candidates by quality descending, ties by the later
    row-major position first: ``np.lexsort((-lin, -vals))``, by the native
    ``gftt_quality_order`` (one keyed sort) where the library is built."""
    fn = native_fn("gftt_quality_order", None, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p])
    if fn is None:
        return np.lexsort((-lin, -vals))
    vals_f = np.ascontiguousarray(vals, np.float32)
    lin_i = np.ascontiguousarray(lin, np.int64)
    out = np.empty(len(vals_f), np.uint32)
    fn(vals_f.ctypes.data_as(ctypes.c_void_p),
       lin_i.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint32(len(vals_f)),
       out.ctypes.data_as(ctypes.c_void_p))
    return out


class BvhRaycaster:
    """Host BVH over a triangle mesh (the reference's Embree caster,
    cpp/ray_casting.cc:21-121)."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("the port's host library is unavailable")
        self._lib = lib
        self._vertices = np.ascontiguousarray(vertices, np.float32)
        self._triangles = np.ascontiguousarray(triangles, np.uint32)
        self._handle = lib.bvh_build(
            self._vertices.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint32(len(self._vertices)),
            self._triangles.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint32(len(self._triangles)),
        )

    def raycast(self, origins: np.ndarray, dirs: np.ndarray,
                masked_triangles: Optional[np.ndarray] = None):
        """Closest-hit cast of N rays.

        Returns ``(pos (N,3), normal (N,3), bary (N,2), t (N,),
        prim (N,) uint32)`` with prim == 0xFFFFFFFF on miss.
        """
        origins = np.ascontiguousarray(origins, np.float32).reshape(-1, 3)
        dirs = np.ascontiguousarray(dirs, np.float32).reshape(-1, 3)
        n = origins.shape[0]
        pos = np.empty((n, 3), np.float32)
        normal = np.empty((n, 3), np.float32)
        bary = np.empty((n, 2), np.float32)
        t = np.empty((n,), np.float32)
        prim = np.empty((n,), np.uint32)
        mask_ptr = None
        if masked_triangles is not None and np.size(masked_triangles):
            masked_triangles = np.ascontiguousarray(masked_triangles,
                                                    np.uint32)
            mask_ptr = masked_triangles.ctypes.data_as(ctypes.c_void_p)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        self._lib.bvh_raycast(self._handle, ptr(origins), ptr(dirs),
                              ctypes.c_uint32(n), mask_ptr, ptr(pos),
                              ptr(normal), ptr(bary), ptr(t), ptr(prim))
        return pos, normal, bary, t, prim

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.bvh_free(handle)
