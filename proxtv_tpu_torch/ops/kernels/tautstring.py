"""Kernel D1: the batched weighted taut string (TV-L1 prox).

No TPU kernel: it replaces the JAX package's XLA lock-step scan
``proxtv_tpu/ops/tv1d_l1.py:tv1_tautstring``; the CUDA source is
``proxtv_tpu_torch/csrc/tautstring.cu``, which runs the same events as a
plain sequential loop per signal and writes each closed segment straight to
the output: up to n = :func:`warp_max_n` (16384 in float32, 8192 in
float64) on one warp a signal, out of shared memory, past it on one thread
a signal.  In float64 a large batch runs several signals a warp, a group of
lanes each, reading y from global memory (:func:`lanes`).  The kernel is built for float32 and for
float64 (the float64 route of ``tv1_batched``); :data:`LAUNCHES` counts the
float32 launches, :data:`LAUNCHES_F64` the float64 ones.

:func:`tautstring` launches the kernel for a CUDA tensor and runs
:func:`~proxtv_tpu_torch.ops.tv1d_l1.tv1_tautstring_plain` — the JAX scan's
arithmetic on tensors — for a CPU tensor; :func:`bind` makes its C call
once, for tools that time the kernel alone.
"""
from __future__ import annotations

import torch

from ...utils.debug import Counter
from .. import tv1d_l1
from . import build
from .direct1d import check_batch, entry, lam_args

LAUNCHES = Counter()
LAUNCHES_F64 = Counter()


def warp_max_n(dtype=torch.float32):
    """The longest signal of the warp layout in ``dtype``
    (``csrc/tautstring.cu`` kWarpMaxN)."""
    return getattr(build.lib(), entry("tautstring_warp_max_n", dtype))()


def lanes(B, n):
    """The lanes a signal that the float64 instantiation gives a (B, n)
    batch (``csrc/tautstring.cu`` group64): 32 (one warp a signal), fewer
    for a large batch (32 / lanes signals a warp), 1 past
    :func:`warp_max_n` (one thread a signal)."""
    return build.lib().tautstring_group_f64(B, n)


def group_limits():
    """The float64 layout for large batches (``csrc/tautstring.cu``
    kGroup64, kGroup64MinB): (lanes a signal, smallest batch); smaller
    batches run one warp a signal, and past :func:`warp_max_n` one thread
    runs a signal."""
    lib = build.lib()
    return lib.tautstring_group_lanes_f64(), lib.tautstring_group_min_b_f64()


def bind(y, lam, lanes=None):
    """The C entry point's call for a CUDA batch, its arguments made once.

    Checks the arguments as :func:`tautstring` does and allocates the
    output.  Returns ``(out, launch)``: each ``launch()`` runs the kernel
    into ``out`` and raises on a refused launch.  ``launch`` does not count
    in :data:`LAUNCHES`.  ``lanes`` (float64 only, n up to
    :func:`warp_max_n`): 32 or ``group_limits()[0]`` lanes a signal,
    whatever the batch (None: the kernel's rule, :func:`lanes`)."""
    y = check_batch(y, "tautstring")
    B, n = y.shape
    lamv, rs, cs, lam_s = lam_args(lam, B, n, y.device, y.dtype)
    out = torch.empty_like(y)
    args = (build.ptr(y), build.ptr(lamv), rs, cs, lam_s, build.ptr(out), B,
            n)
    name = entry("tautstring_tv1", y.dtype)
    if lanes is not None:
        if y.dtype != torch.float64:
            raise ValueError("lanes are chosen for a float64 batch only")
        name += "_group"
        args += (int(lanes),)
    args += (build.stream_ptr(y.device),)

    # keep: every tensor the pointers name, the output too.
    def launch(keep=(y, lamv, out)):
        build.check(getattr(build.lib(), name)(*args), name)

    return out, launch


def tautstring(y, lam):
    """Taut-string TV-L1 prox of a (B, n) batch.  A CUDA tensor must be
    float32 or float64 (the kernel's instantiation for it launches, or this
    raises); a CPU tensor runs the plain version."""
    if not y.is_cuda:
        return tv1d_l1.tv1_tautstring_plain(y, lam)
    if y.shape[-1] == 1:
        return y
    out, launch = bind(y, lam)
    if y.shape[0] > 0:
        launch()
        (LAUNCHES_F64 if y.dtype == torch.float64 else LAUNCHES).value += 1
    return out
