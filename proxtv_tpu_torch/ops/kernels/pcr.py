"""Kernel B2: batched masked SPD second-difference tridiagonal solve (PCR).

Solves ``(DD' [+ shift I]) x = rhs`` per batch row — the Newton systems of
the TV dual solvers — by parallel cyclic reduction.  Replaces the TPU kernel
``proxtv_tpu/ops/kernels/pcr.py:pcr_spd_solve_pallas``; the CUDA source is
``proxtv_tpu_torch/csrc/pcr.cu``.

:func:`pcr_spd_solve` launches the kernel for a CUDA tensor and runs
:func:`pcr_spd_solve_plain` — the TPU kernel's arithmetic on tensors — for a
CPU tensor.  Masking semantics match ``tridiag.spd_second_difference_solve``:
masked-out rows become identity rows with zero RHS, and an off-diagonal
survives only if both endpoints are unmasked.
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


def pcr_spd_solve(rhs, mask=None, diag_shift=None):
    """PCR solve of (DD' [+ shift I]) x = rhs on a (B, n) batch.

    ``mask``: optional (B, n) bool active-row mask. ``diag_shift``: optional
    (B,) per-row diagonal shift (at most one of the two).  A CUDA tensor must
    be float32 with 2 <= n <= 8192; the kernel launches or this raises.
    """
    if mask is not None and diag_shift is not None:
        raise ValueError("pcr_spd_solve takes a mask or a shift, not both")
    if not rhs.is_cuda:
        return pcr_spd_solve_plain(rhs, mask, diag_shift)
    B, n = rhs.shape
    lo, hi = lane_limits("pcr")
    if rhs.dtype != torch.float32 or not lo <= n <= hi:
        raise ValueError(f"PCR kernel takes float32 with {lo} <= n <= {hi}; "
                         f"got {rhs.dtype}, n = {n}")
    rhs = rhs.contiguous()
    m8 = None
    if mask is not None:
        if mask.shape != rhs.shape or mask.device != rhs.device:
            raise ValueError("mask must match rhs in shape and device")
        m8 = mask.to(torch.uint8).contiguous()
    sh = None
    if diag_shift is not None:
        sh = diag_shift.to(device=rhs.device, dtype=torch.float32)
        sh = sh.reshape(-1).contiguous()
        if sh.shape[0] != B:
            raise ValueError("diag_shift must be (B,)")
    out = torch.empty_like(rhs)
    if B == 0:
        return out
    lib = build.lib()
    err = lib.pcr_spd_solve(build.ptr(rhs), build.ptr(m8), build.ptr(sh),
                            build.ptr(out), B, n,
                            build.stream_ptr(rhs.device))
    build.check(err, "pcr_spd_solve")
    LAUNCHES.value += 1
    return out
