"""Batched tridiagonal solvers — the replacement for LAPACK dpttrf/dpttrs
(reference ``src/general.h:23-25``), ported from ``proxtv_tpu.ops.tridiag``.

*   :func:`pcr_solve` — parallel cyclic reduction, O(log n) depth, vectorized
    over the batch axes and the system size.
*   :func:`thomas_solve` — classic Thomas elimination, sequential in n,
    vectorized across the batch; a cross-check.

Both operate on the last axis and solve the general system

    b[i] * x[i-1] + a[i] * x[i] + c[i] * x[i+1] = d[i]

with the convention ``b[0] == 0`` and ``c[n-1] == 0`` (arrays all length n).
"""
from __future__ import annotations

import math

import torch

from .kernels.common import shift_left as _shift_left
from .kernels.common import shift_right as _shift_right


def pcr_solve(a, b, c, d):
    """Solve batched tridiagonal systems by parallel cyclic reduction.

    Args:
        a: (..., n) main diagonal.
        b: (..., n) sub-diagonal; ``b[..., 0]`` must be 0.
        c: (..., n) super-diagonal; ``c[..., n-1]`` must be 0.
        d: (..., n) right-hand side.
    """
    n = a.shape[-1]
    if n == 1:
        return d / a
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


def thomas_solve(a, b, c, d):
    """Solve batched tridiagonal systems with the Thomas algorithm (a Python
    loop over n, vectorized across the leading batch axes)."""
    n = a.shape[-1]
    cps, dps = [], []
    cp_prev = torch.zeros_like(a[..., 0])
    dp_prev = torch.zeros_like(a[..., 0])
    for i in range(n):
        denom = a[..., i] - b[..., i] * cp_prev
        cp_prev = c[..., i] / denom
        dp_prev = (d[..., i] - b[..., i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [None] * n
    x_next = torch.zeros_like(a[..., 0])
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def spd_second_difference_solve(rhs, diag_shift=0.0, mask=None, method="pcr"):
    """Solve ``(DD' + shift I) x = rhs`` where DD' is the (2,-1) second-difference
    matrix of size n = rhs.shape[-1] — the Hessian of the TV dual problems
    (reference ``src/TVL1opt.cpp:110-117``).

    Args:
        rhs: (..., n) right-hand side.
        diag_shift: optional scalar (or broadcastable) added to the diagonal.
        mask: optional (..., n) boolean; True rows participate, False rows are
            identity rows with zero RHS; an off-diagonal entry is kept only
            when both endpoints are True (reference ``src/TVL1opt.cpp:177-181``).
        method: 'pcr' or 'thomas'.

    A CUDA tensor runs the PCR kernel (:mod:`.kernels.pcr`) or raises: the
    kernel takes float32, 2 <= n <= 8192, and a mask or a shift that is
    constant along the system axis, not both (the JAX package's routing,
    ``tridiag.py:145-164``, where the rest falls to the plain composition).
    """
    n = rhs.shape[-1]
    dtype = rhs.dtype
    from .kernels import gating

    if gating.gate(rhs, "pcr"):
        return _spd_solve_kernel(rhs, diag_shift, mask, method)

    a = torch.full(rhs.shape, 2.0, dtype=dtype, device=rhs.device) \
        + torch.as_tensor(diag_shift, dtype=dtype, device=rhs.device)
    zero = torch.zeros(rhs.shape[:-1] + (1,), dtype=dtype, device=rhs.device)
    minus = torch.full(rhs.shape[:-1] + (n - 1,), -1.0, dtype=dtype,
                       device=rhs.device)
    b = torch.cat([zero, minus], dim=-1)
    c = torch.cat([minus, zero], dim=-1)
    d = rhs
    if mask is not None:
        mask = mask.to(torch.bool)
        both = mask[..., :-1] & mask[..., 1:]
        f = torch.zeros_like(mask[..., :1])
        both_lo = torch.cat([f, both], dim=-1)
        both_hi = torch.cat([both, f], dim=-1)
        a = torch.where(mask, a, torch.ones_like(a))
        b = torch.where(both_lo, b, torch.zeros_like(b))
        c = torch.where(both_hi, c, torch.zeros_like(c))
        d = torch.where(mask, d, torch.zeros_like(d))
    solver = pcr_solve if method == "pcr" else thomas_solve
    return solver(a, b, c, d)


def _spd_solve_kernel(rhs, diag_shift, mask, method):
    """The CUDA branch of :func:`spd_second_difference_solve`: kernel B2 on
    the (batch, n) view, or a ``ValueError`` naming the limit."""
    from .kernels import pcr as pcr_kernels

    n = rhs.shape[-1]
    if method != "pcr":
        raise ValueError(f"method={method!r} runs on the CPU only; a CUDA "
                         "tensor takes the PCR kernel (method='pcr')")
    shift_arr = torch.as_tensor(diag_shift)
    if shift_arr.ndim >= 1 and shift_arr.shape[-1] == n and n > 1:
        raise ValueError("the PCR kernel takes a shift constant along the "
                         "system axis; got one that varies along it")
    shift = None
    if not (shift_arr.ndim == 0 and float(shift_arr) == 0.0):
        shift = torch.broadcast_to(
            torch.as_tensor(diag_shift, dtype=rhs.dtype, device=rhs.device),
            rhs.shape)[..., 0].reshape(-1)
    if mask is not None and shift is not None:
        raise ValueError("the PCR kernel takes a mask or a diagonal shift, "
                         "not both")
    m2 = None if mask is None else mask.reshape(-1, n)
    out = pcr_kernels.pcr_spd_solve(rhs.reshape(-1, n), mask=m2,
                                    diag_shift=shift)
    return out.reshape(rhs.shape)


def spd_shifted_solve_normalized(rhs, diag_shift=0.0):
    """Solve ``(DD' + shift I) x = rhs`` by NORMALIZED parallel cyclic
    reduction: the diagonal is rescaled to 1 each level, so only (b, c, d)
    flow through the reduction.  Diagonal dominance (2 + shift) keeps the
    normalized off-diagonals <= 1/2 — stable in f32.

    Args:
        rhs: (..., n) right-hand side.
        diag_shift: scalar or (..., 1) nonnegative diagonal shift.
    """
    n = rhs.shape[-1]
    dtype = rhs.dtype
    r0 = 1.0 / (2.0 + torch.as_tensor(diag_shift, dtype=dtype,
                                      device=rhs.device))
    if n == 1:
        return rhs * r0
    mr0 = torch.broadcast_to(-r0, rhs.shape).to(dtype)
    zero = torch.zeros(rhs.shape[:-1] + (1,), dtype=dtype, device=rhs.device)
    b = torch.cat([zero, mr0[..., 1:]], dim=-1)
    c = torch.cat([mr0[..., :-1], zero], dim=-1)
    d = rhs * r0
    steps = max(1, math.ceil(math.log2(n)))
    for k in range(steps):
        stride = 1 << k
        if stride >= n:
            break
        bm = _shift_right(b, stride, 0.0)
        bp = _shift_left(b, stride, 0.0)
        cm = _shift_right(c, stride, 0.0)
        cp = _shift_left(c, stride, 0.0)
        dm = _shift_right(d, stride, 0.0)
        dp = _shift_left(d, stride, 0.0)
        r = 1.0 / (1.0 - b * cm - c * bp)
        d = (d - b * dm - c * dp) * r
        if stride * 2 < n:  # b, c dead after the final step
            b = (-b * bm) * r
            c = (-c * cp) * r
    return d
