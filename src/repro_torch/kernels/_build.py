"""Build and load the hand-written CUDA kernels.

Every ``kernels/<name>/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, and loaded
with ``ctypes``.  Nothing is built when a module is imported: the first
:func:`load` builds every source, one ``nvcc`` process per source, all
started together.  A library is named by a hash of its source and flags,
so an unchanged source is built once per build directory.

The build directory is ``build/kernels`` at the root of the checkout (the
repository's ``.gitignore`` lists ``build/``).  A missing ``nvcc`` or a
failed build raises ``RuntimeError``; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per kernel: nvcc's stderr (ptxas register/shared-memory report)
BUILD_LOGS: Dict[str, str] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its CUDA source."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then NVCC_FALLBACK."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path(NVCC_FALLBACK))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Build every kernel library that is not built yet, in parallel.
    Returns the wall seconds of each build this call ran."""
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src in sources().items():
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    seconds: Dict[str, float] = {}
    failed: List[str] = []
    for name, out, tmp, t0, p in procs:
        stdout, stderr = p.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = stdout + stderr
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels first if
    needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = sources().get(name)
            if src is None:
                raise RuntimeError(f"no CUDA source for kernel {name!r}")
            if not _lib_path(src).exists():
                build_all()
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(src)))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
