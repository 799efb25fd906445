"""ctypes binding of the native host engine ``native/tv1d_host.cpp`` (the
port's counterpart of ``proxtv_tpu.runtime.native``).

The reference's policy for a single short signal (``proxtv_tpu/api.py``
``tv1_1d`` / ``tv1w_1d`` with ``backend="auto"``) is the host taut string:
microseconds of compute, where a device round trip costs milliseconds.  The
C++ source is compiled from where it stands in the repo, with the flags of
``native/Makefile`` less two (see :data:`CXXFLAGS`), into
``build/proxtv_tpu_torch/`` (the library's name carries a hash of the source
and flags), at first use; nothing runs at import.  The build writes a temporary file and renames it into place, so
concurrent processes never load a half-written library, and it never
writes ``native/libproxtv_host.so`` (the JAX package's own build target).

:func:`available` is False when no C++ compiler is found.  A build that
fails raises with the compiler's log: it does not report "unavailable".
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "tv1d_host.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "proxtv_tpu_torch")
# native/Makefile's CXXFLAGS and link step, less -fopenmp and -march=native:
# a toolchain without the OpenMP runtime refuses the flag (the source guards
# its OpenMP lines with _OPENMP, so the batch entry point runs its loop on one
# thread), and the library's name does not record the machine -march=native
# would tune it for.
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None
_PD = ctypes.POINTER(ctypes.c_double)


def _compiler():
    """The C++ compiler: $CXX if set, else g++ (the Makefile's default), or
    None when neither is on the PATH."""
    cxx = os.environ.get("CXX") or "g++"
    return shutil.which(cxx)


def available() -> bool:
    """Whether the host engine can run here: False when no C++ compiler is
    found (and no library was built before); otherwise the library is built
    now if need be, and a failed build raises."""
    return _lib is not None or _compiler() is not None and lib() is not None


def build() -> str:
    """Compile ``native/tv1d_host.cpp`` into the build directory and return
    the library's path; a library built from the same source and flags is
    reused.  Raises with the compiler's output when the build fails."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) for the native host "
                           "engine")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS).encode())
    path = os.path.join(BUILD_DIR,
                        f"libproxtv_host_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, *CXXFLAGS, SOURCE, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native host engine failed "
                           f"({cxx}):\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def lib():
    """The loaded host library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            handle.ptv_tv1_host.restype = None
            handle.ptv_tv1_host.argtypes = [_PD, ctypes.c_int,
                                            ctypes.c_double, _PD]
            handle.ptv_tv1w_host.restype = None
            handle.ptv_tv1w_host.argtypes = [_PD, ctypes.c_int, _PD, _PD]
            handle.ptv_tv1_batch_host.restype = None
            handle.ptv_tv1_batch_host.argtypes = [_PD, ctypes.c_int,
                                                  ctypes.c_int,
                                                  ctypes.c_double, _PD,
                                                  ctypes.c_int]
            handle.ptv_ws_new.restype = ctypes.c_void_p
            handle.ptv_ws_new.argtypes = [ctypes.c_int]
            handle.ptv_ws_free.restype = None
            handle.ptv_ws_free.argtypes = [ctypes.c_void_p]
            handle.ptv_ws_double.restype = _PD
            handle.ptv_ws_double.argtypes = [ctypes.c_void_p, ctypes.c_int]
            _lib = handle
    return _lib


class HostWorkspace:
    """Reusable host-side buffer pool — the reference ``Workspace`` analog
    (src/utils.h:20-34): a caller issuing many latency-tail solves reuses
    pool-owned output memory instead of allocating a fresh array per call.

    Use as a context manager or call :meth:`close`; the returned arrays are
    VIEWS into pool memory, valid until the next pool call / close."""

    def __init__(self, capacity: int = 0):
        self._lib = lib()
        self._ptr = self._lib.ptv_ws_new(int(capacity))

    def out_buffer(self, size: int):
        """A float64 view of ``size`` elements of the pool's memory."""
        if self._ptr is None:
            raise ValueError("the workspace is closed")
        ptr = self._lib.ptv_ws_double(self._ptr, int(size))
        return np.ctypeslib.as_array(ptr, shape=(int(size),))

    def close(self):
        if self._ptr is not None:
            self._lib.ptv_ws_free(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def tv1_host(y, lam: float, ws: HostWorkspace = None):
    """Scalar-weight 1D TV-L1 prox of one signal on the host, in float64.

    ``ws``: optional :class:`HostWorkspace` — the result is written into
    pool-owned memory (a view is returned) instead of a fresh array."""
    y = np.ascontiguousarray(y, dtype=np.float64).ravel()
    x = ws.out_buffer(y.size) if ws is not None else np.empty_like(y)
    lib().ptv_tv1_host(y.ctypes.data_as(_PD), y.size, float(lam),
                       x.ctypes.data_as(_PD))
    return x


def tv1w_host(y, lam):
    """Per-edge-weight 1D TV-L1 prox of one signal on the host (``lam`` of
    length len(y) - 1), in float64."""
    y = np.ascontiguousarray(y, dtype=np.float64).ravel()
    lam = np.ascontiguousarray(lam, dtype=np.float64).ravel()
    if lam.size != max(y.size - 1, 0):
        raise ValueError(f"tv1w_host takes len(y) - 1 = {y.size - 1} "
                         f"weights; got {lam.size}")
    x = np.empty_like(y)
    lib().ptv_tv1w_host(y.ctypes.data_as(_PD), y.size, lam.ctypes.data_as(_PD),
                        x.ctypes.data_as(_PD))
    return x


def tv1_batch_host(Y, lam: float, n_threads: int = 0):
    """Scalar-weight 1D TV-L1 prox of each row of ``Y`` (B, n) on the host,
    in float64.  The library is built without OpenMP (:data:`CXXFLAGS`), so
    the rows run one after another on one thread: ``n_threads`` is accepted
    for the JAX package's signature and unused."""
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    B, n = Y.shape
    X = np.empty_like(Y)
    lib().ptv_tv1_batch_host(Y.ctypes.data_as(_PD), B, n, float(lam),
                             X.ctypes.data_as(_PD), int(n_threads))
    return X
