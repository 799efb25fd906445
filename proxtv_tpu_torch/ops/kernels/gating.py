"""Shared gating rules and tile choices for the hand-written CUDA kernels.

Every kernel call site asks one question before it may launch (the CUDA
counterpart of ``proxtv_tpu.ops.kernels.gating``): does this tensor take the
kernel or the plain PyTorch composition?  The answer follows the device
alone:

*   a CPU tensor takes the plain composition;
*   a CUDA float32 tensor takes the kernel, or the call raises with the
    limit it broke: one fiber/line must fit the kernel's lane limits, and
    the fused-kernel switch (:func:`fused_ctx`) must be on.  Nothing on the
    card runs a kernel's plain version instead, with one exception, a
    property of the kernel family: past the upper lane limit of a family
    whose JAX callers run an XLA composition there, the gate says "not
    this kernel" and the port's caller runs the same composition on the
    card;
*   a CUDA float64 tensor takes the JAX package's float64 route, whose
    gate says no to every kernel ("f32 by design (f64 runs use the XLA
    compositions)", ``proxtv_tpu/ops/kernels/gating.py:8``): the families
    whose callers compose (``pn``: ``tv1_pn``; ``pn_window``: the long
    route's windows by ``tv1_pn``; ``pdhg2d``: the unfused primal-dual
    iteration; ``ms``: the More-Sorensen composition; ``lp``: the TV-Lp
    compositions) say "not this kernel" at any length, and so does
    ``pdhg3d``, whose ND caller then raises the JAX package's own error
    (it has no float64 primal-dual ND route); the families that the
    compositions run on (B2's ``pcr``) or that the float64 route names
    (D1's ``tautstring``, D2's ``dp``, D3's ``condat``, D4's ``classic``)
    take the kernel's float64 instantiation.
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


# Each family's kernel, named in the gate's refusals.
_KIND_KERNEL = {
    "pn": "B1 (csrc/pn_fused.cu)", "pn_window": "B1 (csrc/pn_fused.cu)",
    "ms": "B4 (csrc/ms_fused.cu)", "lp": "B5 (csrc/lp_fused.cu)",
    "pcr": "B2 (csrc/pcr.cu)", "pdhg2d": "B3 (csrc/pdhg_fused.cu)",
    "pdhg3d": "B6 (csrc/pdhg3d_fused.cu)",
    "tautstring": "D1 (csrc/tautstring.cu)", "dp": "D2 (csrc/dp.cu)",
    "condat": "D3 (csrc/condat.cu)", "classic": "D4 (csrc/classic_ts.cu)",
}
# The float64 route (module docstring): the families built in double, and
# those whose callers run the JAX package's float64 composition instead.
# Every family not built in double says "not this kernel" for float64;
# pdhg3d, in neither set, has a caller that then raises as the JAX
# package's does.
F64_KERNELS = frozenset({"pcr", "tautstring", "dp", "condat", "classic"})
F64_COMPOSES = frozenset({"pn", "pn_window", "pdhg2d", "ms", "lp"})


# Where the JAX package's banded drivers meet a float64 array: the
# kernel's float32 output against the float64 fori_loop carry.
_BANDED_F32_OUT = {
    "pdhg2d": "proxtv_tpu/ops/kernels/pdhg_fused.py:335 against the carry "
              "of proxtv_tpu/models/tv2d.py:939",
    "pdhg3d": "proxtv_tpu/ops/kernels/pdhg3d_fused.py:278 against the "
              "carry of proxtv_tpu/models/tvnd.py:473",
}


def refuse_banded_f64(driver: str, kind: str, device, dtype):
    """The banded drivers (``parallel.sharded.tv1_2d_banded``,
    ``tv1_3d_banded``) run kernel ``kind`` on each rank's band and take
    float32 only on the card, as the JAX package's do: its kernels declare
    float32 outputs, so a float64 array raises a ``TypeError`` in its
    ``fori_loop``.  A float64 tensor bound for a CUDA device raises here,
    before any exchange, naming the kernel.  The CPU runs it (the port's
    plain versions take float64)."""
    if torch.device(device).type == "cuda" and dtype == torch.float64:
        raise ValueError(
            f"{driver} runs kernel {_KIND_KERNEL[kind]} on the card in "
            "float32 only: the JAX package's banded driver takes float32 "
            f"only, because its kernel writes float32 "
            f"({_BANDED_F32_OUT[kind]}); run float64 on the CPU")


def lane_limits(kind: str):
    return _KIND_LANE_LIMITS[kind][:2]


def decide(kind: str, is_cuda: bool, dtype, n: int) -> bool:
    """:func:`gate`'s answer for a tensor on a CUDA card (``is_cuda``) or
    the CPU, of ``dtype``, with ``n`` along its last axis: the route a
    batch takes, which a test can ask without a card.  False: the caller
    runs its composition (the plain composition on the CPU; on the card,
    the composition the JAX package runs there); True: the kernel launches
    (its float64 instantiation for a float64 tensor).  Raises where the
    card has no path: the switch off, a dtype the family does not take on
    the card, or n outside the family's lane limits."""
    if not is_cuda:
        return False
    if not _fused_flag.get():
        raise RuntimeError(
            f"the {kind} kernel is switched off (fused_ctx(False)) and a CUDA "
            "tensor has no other path; move the input to the CPU")
    if dtype == torch.float64:
        if kind not in F64_KERNELS:
            return False
    elif dtype != torch.float32:
        raise ValueError(f"the {kind} kernel {_KIND_KERNEL[kind]} takes "
                         f"float32 (or, where built, float64) on the card; "
                         f"got {dtype}")
    lo, hi, composes = _KIND_LANE_LIMITS[kind]
    if composes and n > hi:
        return False
    if not lo <= n <= hi:
        raise ValueError(f"the {kind} kernel takes {lo} <= n <= {hi} along "
                         f"the last axis; got n = {n}")
    return True


def gate(y: torch.Tensor, kind: str) -> bool:
    """Route for kernel family ``kind`` (:func:`decide` on ``y``'s device,
    dtype and last axis): False for a CPU tensor (the plain composition
    runs), True for a CUDA tensor the kernel takes.  A CUDA tensor the
    kernel cannot take raises: the switch off, a dtype it does not take,
    or last axis outside the family's lane limits, except that a tensor
    longer than the upper limit of a family whose callers compose there,
    or a float64 tensor of a family not built in double, returns False
    (its caller runs the composition the JAX package runs there, or
    raises as the JAX package does).
    A torch tensor lives on one device, so there is no sharding test."""
    return decide(kind, y.is_cuda, y.dtype, y.shape[-1])


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
