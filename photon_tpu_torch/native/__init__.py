"""The native host helpers: ``gather_rows``, ``parallel_memcpy`` and
``crc32`` (the port of ``photon_tpu/native/__init__.py``).

The port builds its own library from ``native/csrc/photon_native.cpp``
with ``g++`` on first use, into ``native/build/`` (listed in
``.gitignore``), under a name that carries a hash of the source, and loads
it with ``ctypes``; processes building at once take turns on a lock file,
as ``ops/_build.py`` does for the kernels. Nothing is built or loaded when
this module is imported. Where no compiler is found, or the build fails,
:func:`available` is False and every helper takes its numpy (or
``zlib``) fallback, with the JAX package's semantics. ``calls`` counts the
calls each helper served through the library (a fallback adds nothing),
so a caller can show that the library did the work.
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
import zlib

import numpy as np

SOURCE = pathlib.Path(__file__).parent / "csrc" / "photon_native.cpp"
BUILD_DIR = pathlib.Path(__file__).parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

#: None: not resolved yet; False: no library (the fallbacks run)
_LIB: ctypes.CDLL | None | bool = None
_lock = threading.Lock()
#: why the library is missing, once :func:`get_lib` has looked
build_error: str = ""
#: calls each helper served through the library
calls = {"gather_rows": 0, "parallel_memcpy": 0, "crc32": 0}

_N_THREADS = min(8, os.cpu_count() or 1)


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libphoton_native_{digest}.so"


def build() -> pathlib.Path:
    """Compile the source unless this exact source is built; raises
    ``RuntimeError`` without a compiler or on a failed build."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++ or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".tmp-{os.getpid()}.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load(path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.pts_gather_widen.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.pts_gather_widen.restype = None
    lib.par_memcpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.par_memcpy.restype = None
    lib.crc32.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
    lib.crc32.restype = ctypes.c_uint32
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None where it cannot be
    built (``build_error`` says why)."""
    global _LIB, build_error
    with _lock:
        if _LIB is None:
            try:
                _LIB = _load(build())
            except (RuntimeError, OSError) as e:
                build_error, _LIB = str(e), False
        return _LIB or None


def available() -> bool:
    return get_lib() is not None


def gather_rows(row_arrays: list[np.ndarray], out: np.ndarray) -> None:
    """Gather token rows (uint16/uint32 views into mmapped shards) into the
    preallocated ``out [n, seq] int32`` batch, widening as it copies."""
    lib = get_lib()
    n = len(row_arrays)
    if n == 0:
        return
    if lib is None:
        for i, r in enumerate(row_arrays):
            out[i] = r
        return
    elem = row_arrays[0].dtype.itemsize
    ptrs = (ctypes.c_void_p * n)(*(r.ctypes.data for r in row_arrays))
    lib.pts_gather_widen(ptrs, n, out.shape[1], elem,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _N_THREADS)
    calls["gather_rows"] += 1


def _bytes_of(x: memoryview | np.ndarray) -> np.ndarray:
    if isinstance(x, memoryview):
        return np.frombuffer(x, np.uint8)
    return x.view(np.uint8).reshape(-1)


def parallel_memcpy(dst: memoryview | np.ndarray, src: memoryview | np.ndarray) -> None:
    """Copy ``src`` into ``dst`` (the same number of bytes) on up to 8
    threads, one per 8 MiB at least."""
    lib = get_lib()
    d, s = _bytes_of(dst), _bytes_of(src)
    if lib is None:
        np.copyto(d, s)
        return
    if d.nbytes != s.nbytes:
        raise ValueError(f"parallel_memcpy: {d.nbytes} destination bytes for {s.nbytes}")
    lib.par_memcpy(d.ctypes.data_as(ctypes.c_void_p), s.ctypes.data_as(ctypes.c_void_p),
                   d.nbytes, _N_THREADS)
    calls["parallel_memcpy"] += 1


def crc32(data: bytes | np.ndarray, seed: int = 0) -> int:
    """zlib's CRC-32 of ``data``, continuing from ``seed``."""
    lib = get_lib()
    if lib is None:
        buf = data if isinstance(data, bytes) else np.ascontiguousarray(data).tobytes()
        return zlib.crc32(buf, seed)
    arr = (np.frombuffer(data, np.uint8) if isinstance(data, bytes)
           else np.ascontiguousarray(data).view(np.uint8).reshape(-1))
    out = int(lib.crc32(seed, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes))
    calls["crc32"] += 1
    return out
