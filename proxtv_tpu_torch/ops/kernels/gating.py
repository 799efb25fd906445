"""Shared gating rules and tile choices for the hand-written CUDA kernels.

Every kernel call site asks one question before it may launch (the CUDA
counterpart of ``proxtv_tpu.ops.kernels.gating``): does this tensor take the
kernel or the plain PyTorch composition?  The answer follows the device
alone:

*   a CPU tensor takes the plain composition;
*   a CUDA tensor takes the kernel, or the call raises with the limit it
    broke: the kernels are float32 by design, one fiber/line must fit the
    kernel's lane limits, and the fused-kernel switch (:func:`fused_ctx`)
    must be on.  Nothing on the card runs the plain composition instead,
    with one exception, a property of the kernel family: past the upper
    lane limit of a family whose JAX callers run an XLA composition there,
    the gate says "not this kernel" and the port's caller runs the same
    composition on the card.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

# A ``contextvars.ContextVar`` (not a module global) so two user threads — or
# a re-entrant combiner — cannot race on the flag.  Off, it makes every CUDA
# call site raise (the JAX package's switch picks the plain path instead; on
# the card the port has none).
_fused_flag = contextvars.ContextVar("proxtv_tpu_torch_fused_flag",
                                     default=True)


@contextlib.contextmanager
def fused_ctx(on: bool):
    """Scope the fused-kernel switch to the current thread/context; with it
    off, a CUDA input raises at its kernel's call site."""
    token = _fused_flag.set(bool(on))
    try:
        yield
    finally:
        _fused_flag.reset(token)


# Lane-length (last-axis) limits per kernel family: the JAX package's limits
# (gating.py:59-67) for the five kernels that hold a whole fiber or line, and
# the 3D chunk's, which the JAX driver also enforces (models/tvnd.py:548-552).
# The 2D chunk tiles its canvas in the cores of its windows with size_t
# offsets, so the TPU's 8192 is no limit of it; only the C interface's int bounds N.  The
# third entry says whether the family's callers run a composition past the
# upper limit, as the JAX package's do (tv1_pn and the XLA PCR past B1 and
# B2, the spectral secular iteration past B4, the GPFW composition past B5).
_KIND_LANE_LIMITS = {
    "pn": (2, 8192, True),        # projected Newton (csrc/pn_fused.cu)
    # the long-signal windows (ops/tv1d_long.py) on the same kernel
    "pn_window": (2, 8192, True),
    "ms": (2, 8192, True),        # More-Sorensen TV-L2 (csrc/ms_fused.cu)
    "lp": (2, 8192, True),        # GPFW TV-Lp dual loop (csrc/lp_fused.cu)
    "pcr": (2, 8192, True),       # PCR tridiagonal solve (csrc/pcr.cu)
    "pdhg2d": (1, 2 ** 31 - 1, False),  # 2D PDHG chunk (csrc/pdhg_fused.cu)
    "pdhg3d": (1, 2048, False),   # 3D PDHG chunk (csrc/pdhg3d_fused.cu)
    # The direct 1D engines (csrc/tautstring.cu, csrc/dp.cu, csrc/condat.cu,
    # csrc/classic_ts.cu): one warp, or past their warp layouts one thread,
    # runs a whole signal of any length.
    "tautstring": (2, 2 ** 31 - 1, False),
    "dp": (2, 2 ** 31 - 1, False),
    "condat": (2, 2 ** 31 - 1, False),
    "classic": (2, 2 ** 31 - 1, False),
}


def lane_limits(kind: str):
    return _KIND_LANE_LIMITS[kind][:2]


def gate(y: torch.Tensor, kind: str) -> bool:
    """Route for kernel family ``kind``: False for a CPU tensor (the plain
    composition runs), True for a CUDA tensor the kernel takes.  A CUDA
    tensor the kernel cannot take raises: the switch off, not float32, or
    last axis outside the family's lane limits, except that a float32
    tensor longer than the upper limit of a family whose callers compose
    there returns False (its caller runs the composition the JAX package
    runs there).  A torch tensor lives on one device, so there is no
    sharding test."""
    if not y.is_cuda:
        return False
    if not _fused_flag.get():
        raise RuntimeError(
            f"the {kind} kernel is switched off (fused_ctx(False)) and a CUDA "
            "tensor has no other path; move the input to the CPU")
    if y.dtype != torch.float32:
        raise ValueError(f"the {kind} kernel takes float32 on the card; got "
                         f"{y.dtype} (float64 solves run on the CPU)")
    lo, hi, composes = _KIND_LANE_LIMITS[kind]
    if composes and y.shape[-1] > hi:
        return False
    if not lo <= y.shape[-1] <= hi:
        raise ValueError(f"the {kind} kernel takes {lo} <= n <= {hi} along "
                         f"the last axis; got n = {y.shape[-1]}")
    return True


def pdhg2d_params():
    """(k_steps, tm) of the CUDA PDHG chunk.

    The TPU's VMEM budgets (``proxtv_tpu.ops.kernels.gating.pdhg2d_params``)
    do not carry over.  The CUDA kernel tiles the canvas in 2D: each block
    keeps a window of 64 rows by 128 columns in registers, a core and a halo
    of K + 1 cells on every side, so its core shrinks as K grows (110 x 46
    at K = 8, 1.62x the cells the core keeps).  Timed on the H100 at the
    1024^2 canvas (``tools/time_b3.py``, PERF.md, on a 64 x 64 window): the
    time per iteration is least near K = 8, 7% more at K = 4 and 25% more
    at K = 14.  K also sets the certificate cadence (one certificate and
    one host read per chunk); ``tm`` sets only the canvas's row padding and
    the plain version's certificate bands."""
    return 8, 32


def pdhg3d_params():
    """(k_steps, (tl, tm, tn)) of the CUDA 3D PDHG chunk.

    The TPU's VMEM budget (``proxtv_tpu.ops.kernels.pdhg3d_fused.
    best_params``) kept whole N-lines resident; a block's shared memory
    cannot.  The CUDA kernel marches along L instead: a block owns a
    (tm, tn) core of columns plus a halo of K cells in M and N, one thread
    per column of the window, and walks a segment of tl layers (plus K
    layers below and above it), with the K steps pipelined one layer behind
    each other, so the L neighbours stay in registers and only one layer of
    xbar, u1 and u2 sits in shared memory.  K = 2 with a 16 x 16 core and
    32-layer segments: a 20 x 20 window (400 threads, 4.8 KB), 1.56x the
    columns it keeps, two iterations per pass over device memory.  Timed on
    the H100 at the 32 x 256 x 256 canvas (``tools/time_b6.py``, PERF.md):
    K = 3 and 4 cost as much or more per iteration (their windows are
    larger and fit one block per SM), and other cores or 16-layer segments
    were slower.  K divides 24, so the driver's certificate every 24
    iterations stays on a chunk boundary."""
    return 2, (32, 16, 16)
