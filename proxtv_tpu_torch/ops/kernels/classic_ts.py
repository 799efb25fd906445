"""Kernel D4: the batched classic taut-string TV-L1 prox (one lambda a
signal).

No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
``proxtv_tpu/ops/tv1d_l1.py:tv1_classic_ts``; the CUDA source is
``proxtv_tpu_torch/csrc/classic_ts.cu``, which runs the same hull events as
one sequential pass a sample per signal.  Up to n = :func:`warp_max_n`
(6280 in float32, 3182 in float64) a warp runs a signal, its two deques, y
and the runs' marks in shared memory, and writes x after the chain by the
plain version's forward fill; past it one thread runs a signal, its deques
in a workspace that the wrapper allocates once per call (2 x (n + 2) x B
slots of 16 bytes in float32, 32 in float64, interleaved by signal).  The
kernel is built for float32 and for float64 (whose tube is built from
float64 prefix sums); :data:`LAUNCHES` counts the float32 launches,
:data:`LAUNCHES_F64` the float64 ones.

:func:`classic_ts` launches the kernel for a CUDA tensor and runs
:func:`~proxtv_tpu_torch.ops.tv1d_l1.tv1_classic_ts_plain` for a CPU
tensor; :func:`bind` makes its C call once, for tools that time the kernel
alone.
"""
from __future__ import annotations

import torch

from ...utils.debug import Counter
from .. import tv1d_l1
from . import build
from .direct1d import check_batch, entry, signal_lam_args

LAUNCHES = Counter()
LAUNCHES_F64 = Counter()
REF = "reference classicTautString_TV1, src/TVL1opt_tautstring.cpp:256,"


def warp_max_n(dtype=torch.float32):
    """The longest signal of the warp layout in ``dtype``, which needs no
    workspace (``csrc/classic_ts.cu`` kWarpMaxN)."""
    return getattr(build.lib(), entry("classic_ts_warp_max_n", dtype))()


def bind(y, lam, cap=None):
    """The C entry point's call for a CUDA batch, its arguments and its
    workspace (the thread layout's, past :func:`warp_max_n`) made once.
    Returns ``(out, launch)`` as :func:`.tautstring.bind`; ``launch`` does
    not count in :data:`LAUNCHES`.  Raises when the workspace does not fit
    on the card.  ``cap``: the most events a signal runs, for a test of
    the cap's output rule (None: the plain version's 8n + 64, which no
    signal reaches)."""
    y = check_batch(y, "classic")
    B, n = y.shape
    lamv, rs, lam_s = signal_lam_args(lam, B, n, y.device, "classic_ts", REF,
                                      y.dtype)
    out = torch.empty_like(y)
    ws = None
    wmax = warp_max_n(y.dtype)
    if n > wmax:
        try:  # two deques of (n + 2) x B slots (ix, iy, slope, ix as y's)
            ws = torch.empty((2, n + 2, B, 4), dtype=y.dtype,
                             device=y.device)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(
                f"the classic taut-string kernel needs a workspace of "
                f"{8 * y.element_size() * (n + 2) * B} bytes for a ({B}, "
                f"{n}) {y.dtype} batch past its warp layout (n > {wmax}); "
                "it does not fit on the card: split the batch") from e
    args = (build.ptr(y), build.ptr(lamv), rs, lam_s, build.ptr(out),
            build.ptr(ws), B, n)
    stream = build.stream_ptr(y.device)
    name = entry("classic_ts_tv1", y.dtype)
    if cap is not None:
        name += "_capped"

    # keep: every tensor the pointers name, the output and workspace too.
    def launch(keep=(y, lamv, out, ws)):
        extra = () if cap is None else (int(cap),)
        build.check(getattr(build.lib(), name)(*args, *extra, stream), name)

    return out, launch


def classic_ts(y, lam):
    """Classic taut-string TV-L1 prox of a (B, n) batch.  A CUDA tensor must
    be float32 or float64 (the kernel's instantiation for it launches, or
    this raises); a CPU tensor runs the plain version."""
    if not y.is_cuda:
        return tv1d_l1.tv1_classic_ts_plain(y, lam)
    if y.shape[-1] == 1:
        return y
    out, launch = bind(y, lam)
    if y.shape[0] > 0:
        launch()
        (LAUNCHES_F64 if y.dtype == torch.float64 else LAUNCHES).value += 1
    return out
