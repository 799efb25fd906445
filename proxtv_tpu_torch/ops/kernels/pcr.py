"""Kernel B2: batched masked SPD second-difference tridiagonal solve.

Solves ``(DD' [+ shift I]) x = rhs`` per batch row — the Newton systems of
the TV dual solvers.  Replaces the TPU kernel
``proxtv_tpu/ops/kernels/pcr.py:pcr_spd_solve_pallas``, which runs parallel
cyclic reduction; the CUDA source is ``proxtv_tpu_torch/csrc/pcr.cu``, which
solves each row exactly in O(n) (each lane's chunk in registers, the lanes'
and warps' interface rows by PCR over shuffles, one step of iterative
refinement), so it rounds differently from the plain version and lands
closer to the float64 solution.  The kernel is built for float32 and for
float64 (the Newton systems of ``tv1_pn`` on a float64 batch), which has
layouts of its own (:func:`layouts_f64`: short rows one thread a row);
:data:`LAUNCHES` counts the float32 launches, :data:`LAUNCHES_F64` the
float64 ones.

:func:`pcr_spd_solve` launches the kernel for a CUDA tensor and runs
:func:`pcr_spd_solve_plain` — the TPU kernel's arithmetic on tensors — for a
CPU tensor; :func:`bind` makes its C call once, for tools that time the
kernel alone.  Masking semantics match
``tridiag.spd_second_difference_solve``: masked-out rows become identity
rows with zero RHS, and an off-diagonal survives only if both endpoints are
unmasked.
"""
from __future__ import annotations

import math

import torch

from ...utils.debug import Counter
from . import build
from .common import shift_left as _shift_left
from .common import shift_right as _shift_right
from .gating import lane_limits

LAUNCHES = Counter()
LAUNCHES_F64 = Counter()


def _pcr_body(a, b, c, d, n):
    steps = max(1, math.ceil(math.log2(n)))
    for k in range(steps):
        stride = 1 << k
        if stride >= n:
            break
        am = _shift_right(a, stride, 1.0)
        ap = _shift_left(a, stride, 1.0)
        bm = _shift_right(b, stride, 0.0)
        bp = _shift_left(b, stride, 0.0)
        cm = _shift_right(c, stride, 0.0)
        cp = _shift_left(c, stride, 0.0)
        dm = _shift_right(d, stride, 0.0)
        dp = _shift_left(d, stride, 0.0)
        alpha = -b / am
        beta = -c / ap
        a = a + alpha * cm + beta * bp
        d = d + alpha * dm + beta * dp
        b = alpha * bm
        c = beta * cp
    return d / a


def pcr_spd_solve_plain(rhs, mask=None, diag_shift=None):
    """The TPU kernel's arithmetic (``pcr.py:38-92``) on tensors: the masked
    form builds its coefficients by float 0/1 algebra."""
    n = rhs.shape[-1]
    if mask is not None:
        m = mask.to(rhs.dtype)
        b = -(m * _shift_right(m, 1, 0.0))
        a = 1.0 + m
        c = _shift_left(b, 1, 0.0)
        return _pcr_body(a, b, c, m * rhs, n)
    one = torch.ones_like(rhs)
    a = 2.0 * one
    if diag_shift is not None:
        a = a + diag_shift.to(rhs.dtype).reshape(-1, 1)
    b = torch.cat([torch.zeros_like(one[..., :1]), -one[..., 1:]], dim=-1)
    c = torch.cat([-one[..., :-1], torch.zeros_like(one[..., :1])], dim=-1)
    return _pcr_body(a, b, c, rhs, n)


def layouts_f64():
    """The float64 instantiation's layouts: ``{name: longest n}`` in the
    kernel's order (``csrc/pcr.cu`` kLayouts64)."""
    lib, out, i = build.lib(), {}, 0
    while lib.pcr_f64_layout_name(i) is not None:
        out[lib.pcr_f64_layout_name(i).decode()] = lib.pcr_f64_layout_max_n(i)
        i += 1
    return out


def layout_f64(n):
    """The name of the float64 layout that a system of n takes."""
    lib = build.lib()
    return lib.pcr_f64_layout_name(lib.pcr_f64_layout_of(n)).decode()


def bind(rhs, mask=None, diag_shift=None, layout=None):
    """The C entry point's call for a CUDA batch, its arguments made once.

    Checks the arguments as :func:`pcr_spd_solve` does and allocates the
    output.  Returns ``(out, launch)``: each ``launch()`` runs the kernel
    into ``out`` and raises on a refused launch.  ``launch`` does not count
    in :data:`LAUNCHES`; timing tools call it to time the kernel without the
    wrapper's host work.  ``layout``: a float64 batch in the named layout
    of :func:`layouts_f64` instead of its own (for tools and tests that
    compare the layouts)."""
    if mask is not None and diag_shift is not None:
        raise ValueError("pcr_spd_solve takes a mask or a shift, not both")
    if not rhs.is_cuda:
        raise ValueError("bind takes a CUDA batch: the kernel has no CPU "
                         "mode")
    B, n = rhs.shape
    lo, hi = lane_limits("pcr")
    if rhs.dtype not in (torch.float32, torch.float64) or not lo <= n <= hi:
        raise ValueError(f"PCR kernel takes float32 or float64 with {lo} <= "
                         f"n <= {hi}; got {rhs.dtype}, n = {n}")
    rhs = rhs.contiguous()
    m8 = None
    if mask is not None:
        if mask.shape != rhs.shape or mask.device != rhs.device:
            raise ValueError("mask must match rhs in shape and device")
        m8 = mask.to(torch.uint8).contiguous()
    sh = None
    if diag_shift is not None:
        sh = diag_shift.to(device=rhs.device, dtype=rhs.dtype)
        sh = sh.reshape(-1).contiguous()
        if sh.shape[0] != B:
            raise ValueError("diag_shift must be (B,)")
    out = torch.empty_like(rhs)
    args = (build.ptr(rhs), build.ptr(m8), build.ptr(sh), build.ptr(out), B,
            n, build.stream_ptr(rhs.device))
    name = ("pcr_spd_solve_f64" if rhs.dtype == torch.float64
            else "pcr_spd_solve")
    if layout is not None:
        names = list(layouts_f64())
        if rhs.dtype != torch.float64 or layout not in names:
            raise ValueError(f"layout {layout!r} names none of the float64 "
                             f"layouts {names}")
        name += "_layout"
        args = args[:-1] + (names.index(layout), args[-1])

    # keep: every tensor the pointers name, the output too: a caller may
    # drop it and launch again.
    def launch(keep=(rhs, m8, sh, out)):
        build.check(getattr(build.lib(), name)(*args), name)

    return out, launch


def pcr_spd_solve(rhs, mask=None, diag_shift=None):
    """Solve (DD' [+ shift I]) x = rhs on a (B, n) batch.

    ``mask``: optional (B, n) bool active-row mask. ``diag_shift``: optional
    (B,) per-row diagonal shift (at most one of the two).  A CUDA tensor must
    be float32 or float64 with 2 <= n <= 8192; the kernel's instantiation
    for it launches or this raises.
    """
    if mask is not None and diag_shift is not None:
        raise ValueError("pcr_spd_solve takes a mask or a shift, not both")
    if not rhs.is_cuda:
        return pcr_spd_solve_plain(rhs, mask, diag_shift)
    out, launch = bind(rhs, mask, diag_shift)
    if rhs.shape[0] > 0:
        launch()
        (LAUNCHES_F64 if rhs.dtype == torch.float64 else LAUNCHES).value += 1
    return out
