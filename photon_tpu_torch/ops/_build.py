"""Build and load the port's CUDA kernels (route: nvcc → shared library
with a plain C interface → ``ctypes``).

Each source under ``ops/csrc/`` is compiled on first use, for ``sm_90a``
only, into ``ops/build/`` (listed in ``.gitignore``). The library's name
carries a hash of its source, so an edited kernel is rebuilt and a stale
one is never loaded. Processes that build one source at once (node
processes spawned together) take turns on a file lock in ``ops/build/``:
the first runs nvcc, the others find its library; the build writes to a
temp name and renames, so no process loads a half-written file. Nothing
is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "build"
#: ``-Xptxas -v``: ptxas reports each kernel's registers, shared memory and
#: spills (kept in ``build_log``)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 = found built,
#: also after waiting for another process's build)
build_seconds: dict[str, float] = {}
#: the compiler's report for each library built in this process
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(source: str) -> pathlib.Path:
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> pathlib.Path:
    """Compile ``csrc/<source>`` unless this exact source is built."""
    out = library_path(source)
    if out.exists():
        build_seconds.setdefault(source, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            build_seconds.setdefault(source, 0.0)
            return out
        return _compile(source, out)


def _compile(source: str, out: pathlib.Path) -> pathlib.Path:
    tmp = out.with_suffix(f".tmp-{os.getpid()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[source] = time.perf_counter() - t0
    build_log[source] = proc.stdout + proc.stderr
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
