"""Build and load the port's CUDA kernels (``proxtv_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded through ``ctypes``.  The build runs
at first use, into ``build/proxtv_tpu_torch/`` beside the package, and is
reused while the sources are unchanged (the library's name carries a hash of
them; the compiler's log is kept beside it).  Nothing here runs at import.
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
SOURCES = ("pcr.cu", "pn_fused.cu", "pdhg_fused.cu", "ms_fused.cu",
           "pdhg3d_fused.cu", "lp_fused.cu", "tautstring.cu", "dp.cu",
           "condat.cu", "classic_ts.cu", "labels.cu")
HEADERS = ("block.cuh", "fiber.cuh", "tridiag.cuh", "direct1d.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
BUILD_LOG = {"seconds": None, "ptxas": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_PF = ctypes.POINTER(ctypes.c_float)  # host arrays
_PI = ctypes.POINTER(ctypes.c_int)
# C entry points: every one returns cudaGetLastError() after its launch.
# An entry ending in _f64 is its kernel's float64 instantiation: the same
# arguments with double arrays and a double scalar weight.
_SIGNATURES = {
    # rhs, mask (u8 or NULL), shift (or NULL), out, B, n, stream
    "pcr_spd_solve": (_P, _P, _P, _P, _I, _I, _P),
    "pcr_spd_solve_f64": (_P, _P, _P, _P, _I, _I, _P),
    # the same, and the float64 layout's number
    "pcr_spd_solve_f64_layout": (_P, _P, _P, _P, _I, _I, _I, _P),
    # layout -> its longest n (0 past the last); n -> its layout's number
    "pcr_f64_layout_max_n": (_I,),
    "pcr_f64_layout_of": (_I,),
    # stream: an empty kernel's launch
    "pcr_empty_launch": (_P,),
    # y, lam_field (or NULL), lam_scalar, w0 (or NULL), x, w (or NULL), iters
    # (or NULL), B, n, max_iters, max_armijo, sigma, stop_rel, tol_eps,
    # head_steps, stream
    "pn_tv1_fused": (_P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                     _I, _P),
    # sched, x, xb, u1, u2, y, wr, wc, xo, xbo, u1o, u2o, gap, obj, Mp, Np,
    # k_steps, n_valid, m_valid, stride, count, pad_top, grad_step, stream
    "pdhg_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "pdhg_cert_blocks": (_I, _I),
    # weighted -> resident blocks per SM (or a negative CUDA error)
    "pdhg_blocks_per_sm": (_I,),
    # y, lam_rows (or NULL), lam_scalar, alpha_init (or NULL), x, alpha, gap,
    # iters, B, n, max_iters, stop_boundary, stream
    "ms_tv2_fused": (_P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # sched, x, xb, u1, u2, u3, y, xo, xbo, u1o, u2o, u3o, Lp, Mp, N, k_steps,
    # tl, tm, tn, n_valid, m_valid, l_valid, stride, count, pad_top, pad_m,
    # grad_step, stream
    "pdhg3d_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # k_steps, tm, tn -> resident blocks per SM (or a negative CUDA error)
    "pdhg3d_blocks_per_sm": (_I, _I, _I),
    # y, w0, lam, mu0, run_mask, w, mu, gap, iters, B, n, max_trips,
    # fw_cycles, stop_rel, newton_iters, q_ge2, exponents (host float[13]),
    # codes (host int[13]), stream
    "gpfw_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                   _I, _PF, _PI, _P),
    # y, lam (or NULL), lam row stride, lam column stride, lam_scalar, x, B,
    # n, stream
    "tautstring_tv1": (_P, _P, _I, _I, _F, _P, _I, _I, _P),
    "tautstring_tv1_f64": (_P, _P, _I, _I, _D, _P, _I, _I, _P),
    # the same with the lanes a signal (32 or 8)
    "tautstring_tv1_f64_group": (_P, _P, _I, _I, _D, _P, _I, _I, _I, _P),
    # y, lam (or NULL), lam row stride, lam column stride, lam_scalar, x,
    # plam, pslope, lohi (workspace), B, n, stream
    "dp_tv1": (_P, _P, _I, _I, _F, _P, _P, _P, _P, _I, _I, _P),
    # the same in float64, with the ring reruns' count (int32 on the card,
    # or NULL) before B; then with a layout (dp.LAYOUTS_F64)
    "dp_tv1_f64": (_P, _P, _I, _I, _D, _P, _P, _P, _P, _P, _I, _I, _P),
    "dp_tv1_f64_layout": (_P, _P, _I, _I, _D, _P, _P, _P, _P, _P, _I, _I,
                          _I, _P),
    # the longest n of D1's warp layout (one warp a signal); B, n -> the
    # lanes a signal of D1's float64 layout for that batch
    "tautstring_warp_max_n": (),
    "tautstring_warp_max_n_f64": (),
    "tautstring_group_f64": (_I, _I),
    "tautstring_group_lanes_f64": (),
    "tautstring_group_min_b_f64": (),
    # B, n, per_edge -> 1 on D2's warp layout, 0 on its thread layout
    "dp_warp_layout": (_I, _I, _I),
    "dp_warp_max_n": (),
    # B -> D2's float64 layout (1 warp, 2 lane); its ring's slots and the
    # largest batch of its warp layout
    "dp_layout_f64": (_I,),
    "dp_ring_slots_f64": (),
    "dp_warp_max_b_f64": (),
    # y, lam (one a signal, or NULL), lam row stride, lam_scalar, x, B, n,
    # stream
    "condat_tv1": (_P, _P, _I, _F, _P, _I, _I, _P),
    "condat_tv1_f64": (_P, _P, _I, _D, _P, _I, _I, _P),
    # y, lam (one a signal, or NULL), lam row stride, lam_scalar, x, ws
    # (the workspace past the warp layout, or NULL), B, n, stream
    "classic_ts_tv1": (_P, _P, _I, _F, _P, _P, _I, _I, _P),
    "classic_ts_tv1_f64": (_P, _P, _I, _D, _P, _P, _I, _I, _P),
    # the same with the most events a signal runs (a test of D4's cap)
    "classic_ts_tv1_capped": (_P, _P, _I, _F, _P, _P, _I, _I,
                              ctypes.c_longlong, _P),
    "classic_ts_tv1_f64_capped": (_P, _P, _I, _D, _P, _P, _I, _I,
                                  ctypes.c_longlong, _P),
    # the longest n of D3's and D4's warp layouts
    "condat_warp_max_n": (),
    "condat_warp_max_n_f64": (),
    "classic_ts_warp_max_n": (),
    "classic_ts_warp_max_n_f64": (),
    # the longest n of D4's float64 ring layout
    "classic_ts_ring_max_n_f64": (),
    # X, tol, labels (the output and the parent array), B, M, N, stream
    "component_labels": (_P, _P, _P, _I, _I, _I, _P),
    "component_labels_f64": (_P, _P, _P, _I, _I, _I, _P),
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
    for s in SOURCES + HEADERS:
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
    log_path = lib_path + ".log"
    if os.path.exists(lib_path) and not force:
        if not BUILD_LOG["ptxas"] and os.path.exists(log_path):
            with open(log_path) as f:
                BUILD_LOG["ptxas"] = f.read()
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
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = "\n".join(logs)
    with open(log_path, "w") as f:
        f.write(BUILD_LOG["ptxas"])
    os.replace(tmp, lib_path)
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
            for name in ("proxtv_error_string", "pcr_f64_layout_name"):
                getattr(handle, name).argtypes = [ctypes.c_int]
                getattr(handle, name).restype = ctypes.c_char_p
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
