"""Kernel D3: the batched Condat direct TV-L1 prox (one lambda a signal).

No TPU kernel: it replaces the JAX package's XLA lock-step scan
``proxtv_tpu/ops/tv1d_l1.py:tv1_condat``; the CUDA source is
``proxtv_tpu_torch/csrc/condat.cu``, which runs the same events as a plain
sequential loop per signal: up to n = :func:`warp_max_n` (16384 in
float32, 8192 in float64) on one warp a signal, out of shared memory,
recording each closed run at its start and writing x after the chain by the
plain version's forward fill; past it on one thread a signal, writing each
run as it closes.  The kernel is built for float32 and for float64;
:data:`LAUNCHES` counts the float32 launches, :data:`LAUNCHES_F64` the
float64 ones.

:func:`condat` launches the kernel for a CUDA tensor and runs
:func:`~proxtv_tpu_torch.ops.tv1d_l1.tv1_condat_plain` for a CPU tensor;
:func:`bind` makes its C call once, for tools that time the kernel alone.
"""
from __future__ import annotations

import torch

from ...utils.debug import Counter
from .. import tv1d_l1
from . import build
from .direct1d import check_batch, entry, signal_lam_args

LAUNCHES = Counter()
LAUNCHES_F64 = Counter()
REF = "reference TV1D_denoise, src/condat_fast_tv.cpp:78,"


def warp_max_n(dtype=torch.float32):
    """The longest signal of the warp layout in ``dtype``
    (``csrc/condat.cu`` kWarpMaxN)."""
    return getattr(build.lib(), entry("condat_warp_max_n", dtype))()


def bind(y, lam):
    """The C entry point's call for a CUDA batch, its arguments made once.
    Returns ``(out, launch)`` as :func:`.tautstring.bind`; ``launch`` does
    not count in :data:`LAUNCHES`.  ``lam``: scalar or (B,) per signal
    (negative weights clamped to 0)."""
    y = check_batch(y, "condat")
    B, n = y.shape
    lamv, rs, lam_s = signal_lam_args(lam, B, n, y.device, "condat", REF,
                                      y.dtype)
    out = torch.empty_like(y)
    args = (build.ptr(y), build.ptr(lamv), rs, lam_s, build.ptr(out), B, n,
            build.stream_ptr(y.device))
    name = entry("condat_tv1", y.dtype)

    # keep: every tensor the pointers name, the output too.
    def launch(keep=(y, lamv, out)):
        build.check(getattr(build.lib(), name)(*args), name)

    return out, launch


def condat(y, lam):
    """Condat TV-L1 prox of a (B, n) batch.  A CUDA tensor must be float32
    or float64 (the kernel's instantiation for it launches, or this
    raises); a CPU tensor runs the plain version."""
    if not y.is_cuda:
        return tv1d_l1.tv1_condat_plain(y, lam)
    if y.shape[-1] == 1:
        return y
    out, launch = bind(y, lam)
    if y.shape[0] > 0:
        launch()
        (LAUNCHES_F64 if y.dtype == torch.float64 else LAUNCHES).value += 1
    return out
