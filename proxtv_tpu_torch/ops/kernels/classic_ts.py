"""Kernel D4: the batched classic taut-string TV-L1 prox (one lambda a
signal).

No TPU kernel: it replaces the JAX package's XLA lock-step deque machine
``proxtv_tpu/ops/tv1d_l1.py:tv1_classic_ts``; the CUDA source is
``proxtv_tpu_torch/csrc/classic_ts.cu``, which runs the same hull events as
one sequential pass a sample per signal.  Up to n = :func:`warp_max_n`
(6280 in float32, 4741 in float64) a warp runs a signal, its two deques, y
and the runs' marks in shared memory, and writes x after the chain by the
plain version's forward fill.  In float64, up to n = :func:`ring_max_n`
(23549) a warp still runs a signal, each deque in a ring of 512 slots in
shared memory (a signal whose deque outgrows its ring runs again with its
deques in a workspace).  Past those one thread runs a signal, its deques
in the workspace.  The wrapper allocates the workspace
once per call past :func:`warp_max_n`: 2 x (n + 2) x B slots of 16 bytes
in float32, interleaved by signal, and of 20 bytes in float64 (a slot's
rise and slope as two doubles, then its length as an int32, in two
arrays).  The kernel is built for float32 and for float64 (whose tube is
built from float64 prefix sums); :data:`LAUNCHES` counts the float32
launches, :data:`LAUNCHES_F64` the float64 ones.

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
    workspace (``csrc/classic_ts.cu`` kWarpMaxN, kWarpMaxN64)."""
    return getattr(build.lib(), entry("classic_ts_warp_max_n", dtype))()


def ring_max_n():
    """The longest float64 signal that a warp still runs, its deques in
    rings in shared memory (the ring layout; ``csrc/classic_ts.cu``
    kRingMaxN64).  Past it one thread runs a signal."""
    return build.lib().classic_ts_ring_max_n_f64()


def workspace_bytes(B, n, dtype):
    """The bytes of the workspace that a (B, n) batch of ``dtype`` takes
    past :func:`warp_max_n`: two deques of (n + 2) x B slots."""
    return 2 * (n + 2) * B * (16 if dtype == torch.float32 else 20)


def bind(y, lam, cap=None):
    """The C entry point's call for a CUDA batch, its arguments and its
    workspace (past :func:`warp_max_n`) made once.
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
        nbytes = workspace_bytes(B, n, y.dtype)
        try:
            ws = torch.empty(nbytes, dtype=torch.uint8, device=y.device)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(
                f"the classic taut-string kernel needs a workspace of "
                f"{nbytes} bytes for a ({B}, {n}) {y.dtype} batch past its "
                f"warp layout (n > {wmax}); it does not fit on the card: "
                "split the batch") from e
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
