"""Kernel D2: the batched message-passing DP (TV-L1 prox).

No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
``proxtv_tpu/ops/tv1d_l1.py:tv1_dp``; the CUDA source is
``proxtv_tpu_torch/csrc/dp.cu``, which runs the same deque operations one
after another per signal.  Up to n = 8192 in float32 (5808 in float64), and
for a batch that runs in at most four waves of the warps shared memory lets
reside, a warp runs a signal, its deque arena and clip bounds in shared
memory; otherwise one thread runs a signal, its arena and bounds in a
workspace that the wrapper allocates once per call (3 x 2n x B words).
:func:`warp_layout` says which.  The kernel is built for float32 and for
float64 (the float64 route of ``tv1_batched``'s DP names); :data:`LAUNCHES`
counts the float32 launches, :data:`LAUNCHES_F64` the float64 ones.

:func:`dp` launches the kernel for a CUDA tensor and runs
:func:`~proxtv_tpu_torch.ops.tv1d_l1.tv1_dp_plain` for a CPU tensor;
:func:`bind` makes its C call once, for tools that time the kernel alone.
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
    """The longest signal of the warp layout in ``dtype`` (``csrc/dp.cu``
    kWarpMaxN; a batch of more than four waves takes the thread layout at
    any n)."""
    return getattr(build.lib(), entry("dp_warp_max_n", dtype))()


def warp_layout(B, n, per_edge, dtype=torch.float32):
    """Whether the kernel's instantiation for ``dtype`` runs a (B, n) batch
    (``per_edge``: one weight an edge) on its warp layout, which needs no
    workspace (``csrc/dp.cu`` ``warp_layout``)."""
    name = entry("dp_warp_layout", dtype)
    r = getattr(build.lib(), name)(B, n, int(per_edge))
    if r < 0:
        build.check(-r, name)
    return bool(r)


def bind(y, lam):
    """The C entry point's call for a CUDA batch, its arguments and its
    workspace (the thread layout's, see :func:`warp_layout`) made once.
    Returns ``(out, launch)`` as :func:`.tautstring.bind`; ``launch`` does
    not count in :data:`LAUNCHES`."""
    y = check_batch(y, "dp")
    B, n = y.shape
    lamv, rs, cs, lam_s = lam_args(lam, B, n, y.device, y.dtype)
    out = torch.empty_like(y)
    plam = pslope = lohi = None
    if not warp_layout(B, n, lamv is not None and cs != 0, y.dtype):
        plam = torch.empty((2 * n, B), dtype=y.dtype, device=y.device)
        pslope = torch.empty((2 * n, B), dtype=torch.int32, device=y.device)
        lohi = torch.empty((2 * n, B), dtype=y.dtype, device=y.device)
    args = (build.ptr(y), build.ptr(lamv), rs, cs, lam_s, build.ptr(out),
            build.ptr(plam), build.ptr(pslope), build.ptr(lohi), B, n,
            build.stream_ptr(y.device))
    name = entry("dp_tv1", y.dtype)

    # keep: every tensor the pointers name, the output and workspace too.
    def launch(keep=(y, lamv, out, plam, pslope, lohi)):
        build.check(getattr(build.lib(), name)(*args), name)

    return out, launch


def dp(y, lam):
    """Message-passing TV-L1 prox of a (B, n) batch.  A CUDA tensor must be
    float32 or float64 (the kernel's instantiation for it launches, or this
    raises); a CPU tensor runs the plain version."""
    if not y.is_cuda:
        return tv1d_l1.tv1_dp_plain(y, lam)
    if y.shape[-1] == 1:
        return y
    out, launch = bind(y, lam)
    if y.shape[0] > 0:
        launch()
        (LAUNCHES_F64 if y.dtype == torch.float64 else LAUNCHES).value += 1
    return out
