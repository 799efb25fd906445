"""Build and load the port's CUDA kernels (``proxtv_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded through ``ctypes``.  The build runs
at first use, into ``build/proxtv_tpu_torch/`` beside the package, and is
reused while the sources are unchanged (the library's name carries a hash of
them).  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "proxtv_tpu_torch")
SOURCES = ("pcr.cu", "pn_fused.cu", "pdhg_fused.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
BUILD_LOG = {"seconds": None, "ptxas": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every one returns cudaGetLastError() after its launch.
_SIGNATURES = {
    # rhs, mask (u8 or NULL), shift (or NULL), out, B, n, stream
    "pcr_spd_solve": (_P, _P, _P, _P, _I, _I, _P),
    # y, lam_field (or NULL), lam_scalar, w0 (or NULL), x, w (or NULL), iters
    # (or NULL), B, n, max_iters, max_armijo, sigma, stop_rel, head_steps,
    # stream
    "pn_tv1_fused": (_P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                     _P),
    # sched, x, xb, u1, u2, y, wr, wc, xo, xbo, u1o, u2o, gap, obj, Mp, Np,
    # k_steps, n_valid, m_valid, stride, count, pad_top, grad_step, stream
    "pdhg_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "pdhg_cert_blocks": (_I, _I),
}


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def _digest():
    h = hashlib.sha256()
    for s in SOURCES:
        with open(os.path.join(CSRC, s), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> str:
    """Compile every source (in parallel) and link the library; returns its
    path.  A library built from the same sources is reused unless ``force``.
    Raises with the compiler's output when a step fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libproxtv_kernels_{_digest()}.so")
    if os.path.exists(lib_path) and not force:
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for s in SOURCES:
        obj = os.path.join(BUILD_DIR, s.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, s), "-o", obj]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, logs, failed = [], [], []
    for s, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {s}\n{out}")
        if p.returncode != 0:
            failed.append(s)
        objs.append(obj)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = "\n".join(logs)
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            handle.proxtv_error_string.argtypes = [ctypes.c_int]
            handle.proxtv_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def ptr(t):
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, name: str):
    """Raise when a C entry point reported a launch error."""
    if err != 0:
        msg = lib().proxtv_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: {msg} ({err})")
