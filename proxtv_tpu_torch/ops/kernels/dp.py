"""Kernel D2: the batched message-passing DP (TV-L1 prox).

No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
``proxtv_tpu/ops/tv1d_l1.py:tv1_dp``; the CUDA source is
``proxtv_tpu_torch/csrc/dp.cu``, which runs the same deque operations one
after another per signal.  In float32, up to n = 8192 and for a batch that
runs in at most four waves of the warps shared memory lets reside, a warp
runs a signal, its deque arena and clip bounds in shared memory; otherwise
one thread runs a signal, its arena and bounds in a workspace that the
wrapper allocates once per call (3 x 2n x B words).  :func:`warp_layout`
says which.  In float64 each signal's deque lives in a ring of
:func:`ring_slots` slots in shared memory, at any n: one warp a signal up
to a batch of :func:`warp_max_b` signals, one signal a lane above, as
many signals a warp as keep about twelve warps an SM (:func:`layout`); the clip bounds go to the workspace, which a float64
call always allocates, and a signal whose deque outgrows its ring runs
again from it, counted in :data:`RING_RERUNS`.  :data:`LAUNCHES` counts the
float32 launches, :data:`LAUNCHES_F64` the float64 ones.

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
# The float64 layouts by number (csrc/dp.cu run64).
LAYOUTS_F64 = {"warp": 1, "lane": 2, "lane16": 4, "lane8": 5, "lane4": 6}


class DeviceCounter:
    """A count the kernels add to on the card: one int32 a device, made at
    first use.  Reading :attr:`value` waits for the card; :meth:`reset`
    zeroes the cells without waiting."""

    def __init__(self):
        self._cells = {}

    def cell(self, device):
        """The int32 the kernels on ``device`` add to."""
        key = torch.device(device)
        if key not in self._cells:
            self._cells[key] = torch.zeros(1, dtype=torch.int32,
                                           device=device)
        return self._cells[key]

    @property
    def value(self):
        return sum(int(c.item()) for c in self._cells.values())

    def reset(self):
        for c in self._cells.values():
            c.zero_()


# The float64 signals whose deque outgrew its ring and ran again from the
# workspace (csrc/dp.cu; counted by the kernel).
RING_RERUNS = DeviceCounter()


def warp_max_n(dtype=torch.float32):
    """The longest signal of the float32 warp layout (``csrc/dp.cu``
    kWarpMaxN; a batch of more than four waves takes the thread layout at
    any n).  The float64 layouts take any n: None."""
    if dtype == torch.float64:
        return None
    return build.lib().dp_warp_max_n()


def ring_slots():
    """The slots of a float64 signal's ring (``csrc/dp.cu`` kRing64)."""
    return build.lib().dp_ring_slots_f64()


def warp_max_b():
    """The largest float64 batch that runs one warp a signal (``csrc/dp.cu``
    kWarp64MaxB); larger batches run one signal a lane."""
    return build.lib().dp_warp_max_b_f64()


def layout(B, n, per_edge, dtype=torch.float32):
    """The layout the kernel's instantiation for ``dtype`` runs a (B, n)
    batch on (``per_edge``: one weight an edge): "warp" or "thread" in
    float32; in float64 "warp" or, one signal a lane, "lane4", "lane8",
    "lane16" or "lane" (4, 8, 16 or 32 signals a warp)."""
    if dtype == torch.float64:
        code = build.lib().dp_layout_f64(B)
        if code < 0:
            build.check(-code, "dp_layout_f64")
        return next(k for k, v in LAYOUTS_F64.items() if v == code)
    r = build.lib().dp_warp_layout(B, n, int(per_edge))
    if r < 0:
        build.check(-r, "dp_warp_layout")
    return "warp" if r else "thread"


def warp_layout(B, n, per_edge, dtype=torch.float32):
    """Whether the kernel's instantiation for ``dtype`` runs a (B, n) batch
    on its warp layout (one warp a signal; see :func:`layout`)."""
    return layout(B, n, per_edge, dtype) == "warp"


def bind(y, lam, layout=None):
    """The C entry point's call for a CUDA batch, its arguments and its
    workspace (float32's thread layout's, and every float64 call's) made
    once.  Returns ``(out, launch)`` as :func:`.tautstring.bind`;
    ``launch`` does not count in :data:`LAUNCHES`.  ``layout`` (float64
    only): a name of :data:`LAYOUTS_F64` runs that layout whatever the
    batch (None: the kernel's rule)."""
    y = check_batch(y, "dp")
    B, n = y.shape
    lamv, rs, cs, lam_s = lam_args(lam, B, n, y.device, y.dtype)
    out = torch.empty_like(y)
    f64 = y.dtype == torch.float64
    if layout is not None and not f64:
        raise ValueError("a layout is chosen for a float64 batch only")
    plam = pslope = lohi = reruns = None
    if f64 or not warp_layout(B, n, lamv is not None and cs != 0):
        plam = torch.empty((2 * n, B), dtype=y.dtype, device=y.device)
        pslope = torch.empty((2 * n, B), dtype=torch.int32, device=y.device)
        lohi = torch.empty((2 * n, B), dtype=y.dtype, device=y.device)
    args = (build.ptr(y), build.ptr(lamv), rs, cs, lam_s, build.ptr(out),
            build.ptr(plam), build.ptr(pslope), build.ptr(lohi))
    if f64:
        reruns = RING_RERUNS.cell(y.device)
        args += (build.ptr(reruns),)
    args += (B, n)
    name = entry("dp_tv1", y.dtype)
    if layout is not None:
        name += "_layout"
        args += (LAYOUTS_F64[layout],)
    args += (build.stream_ptr(y.device),)

    # keep: every tensor the pointers name, the output and workspace too.
    def launch(keep=(y, lamv, out, plam, pslope, lohi, reruns)):
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
