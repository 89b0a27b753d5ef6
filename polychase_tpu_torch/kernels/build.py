"""Build a CUDA source of ``csrc/`` into a shared library at first use.

The library has a plain C interface and is loaded with ctypes.  It is built
with ``nvcc`` for ``sm_90a`` (Hopper) into ``torch_kernels/`` under
:func:`build_root`, under a name keyed by a hash of the source, so an edit
rebuilds and an unchanged source is built once.  No ``--use_fast_math``: the
kernels keep IEEE f32 division, square roots and denormals.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def build_root() -> Path:
    """Where the port builds its libraries (the kernels here, the host
    library in ``native``): ``build/`` at the root of a checkout (the
    package's parent holds ``pyproject.toml``), else the user's cache,
    ``$XDG_CACHE_HOME/polychase_tpu_torch/`` or
    ``~/.cache/polychase_tpu_torch/``, since an installed wheel or an
    extracted add-on does not own the directory around it."""
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build"
    cache = os.environ.get("XDG_CACHE_HOME", "")
    if not os.path.isabs(cache):  # unset, or not absolute: the XDG default
        cache = os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "polychase_tpu_torch"


BUILD_DIR = build_root() / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class Library:
    """A loaded kernel library with its build record."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds  # 0.0 when an existing build was reused
        self.build_log = log


def _artifact(source: str, csrc: Path):
    src = Path(csrc) / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{src.stem}_{digest}.so"


def load_all(sources, csrc: Path = CSRC) -> list:
    """Build (if needed) and load ``<csrc>/<source>`` for each source (by
    default the package's ``csrc/``); raises on failure.  Missing libraries
    are compiled in parallel, one ``nvcc`` per source, all started
    together."""
    with _lock:
        t0 = time.perf_counter()
        todo = []
        for source in sources:
            if str(Path(csrc) / source) in _loaded:
                continue
            src, out = _artifact(source, csrc)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            log = open(tmp + ".log", "w+")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=log, stderr=subprocess.STDOUT, text=True,
            )
            todo.append((source, src, out, tmp, log, proc))
        seconds = {}
        while len(seconds) < len(todo):
            for source, *_, proc in todo:
                if source not in seconds and proc.poll() is not None:
                    seconds[source] = time.perf_counter() - t0
            time.sleep(0.02)
        failed = []
        for source, src, out, tmp, log, proc in todo:
            log.seek(0)
            text = log.read()
            log.close()
            os.unlink(log.name)
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed on {src}:\n{text}")
                continue
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for source in sources:
            key = str(Path(csrc) / source)
            if key in _loaded:
                continue
            _, out = _artifact(source, csrc)
            log_path = out.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            _loaded[key] = Library(ctypes.CDLL(str(out)), out,
                                   seconds.get(source, 0.0), log)
        return [_loaded[str(Path(csrc) / source)] for source in sources]


def load(source: str, csrc: Path = CSRC) -> Library:
    """Build (if needed) and load ``<csrc>/<source>``; raises on failure."""
    return load_all([source], csrc)[0]
