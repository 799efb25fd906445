"""Shared gating rules and tile choices for the hand-written CUDA kernels.

Every kernel call site asks one question before it may launch (the CUDA
counterpart of ``proxtv_tpu.ops.kernels.gating``): does this tensor take the
kernel or the plain PyTorch composition?  The answer follows the device
alone:

*   a CPU tensor takes the plain composition;
*   a CUDA tensor takes the kernel, or the call raises with the limit it
    broke: the kernels are float32 by design, one fiber/line must fit the
    kernel's lane limits, and the fused-kernel switch (:func:`fused_ctx`)
    must be on.  Nothing on the card runs the plain composition instead.
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


# Lane-length (last-axis) limits per kernel family, the JAX package's limits
# (gating.py:59-67) for the three kernels the port has.
_KIND_LANE_LIMITS = {
    "pn": (2, 8192),        # projected Newton (csrc/pn_fused.cu)
    "pcr": (2, 8192),       # PCR tridiagonal solve (csrc/pcr.cu)
    "pdhg2d": (1, 8192),    # 2D PDHG chunk (csrc/pdhg_fused.cu)
}


def lane_limits(kind: str):
    return _KIND_LANE_LIMITS[kind]


def gate(y: torch.Tensor, kind: str) -> bool:
    """Route for kernel family ``kind``: False for a CPU tensor (the plain
    composition runs), True for a CUDA tensor the kernel takes.  A CUDA
    tensor the kernel cannot take raises: not float32, last axis outside the
    family's lane limits, or the switch off.  A torch tensor lives on one
    device, so there is no sharding test."""
    if not y.is_cuda:
        return False
    if not _fused_flag.get():
        raise RuntimeError(
            f"the {kind} kernel is switched off (fused_ctx(False)) and a CUDA "
            "tensor has no other path; move the input to the CPU")
    if y.dtype != torch.float32:
        raise ValueError(f"the {kind} kernel takes float32 on the card; got "
                         f"{y.dtype} (float64 solves run on the CPU)")
    lo, hi = _KIND_LANE_LIMITS[kind]
    if not lo <= y.shape[-1] <= hi:
        raise ValueError(f"the {kind} kernel takes {lo} <= n <= {hi} along "
                         f"the last axis; got n = {y.shape[-1]}")
    return True


def pdhg2d_params():
    """(k_steps, tm) of the CUDA PDHG chunk.

    The TPU's VMEM budgets (``proxtv_tpu.ops.kernels.gating.pdhg2d_params``)
    do not carry over.  The CUDA kernel tiles the canvas in 2D: a 32x32 core
    plus a 2K halo on all four sides in shared memory, so the window is
    (32 + 4K)^2 cells per field.  K = 8 gives a 64^2 window: 5 fields x 16 KB
    = 80 KB unweighted (two blocks per SM), 7 fields = 112 KB weighted, both
    under the 227 KB a block may use.  K only moves the certificate cadence
    (one certificate and one host read per chunk); ``tm`` is the core height,
    which sets the canvas's row padding."""
    return 8, 32
