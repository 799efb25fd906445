"""Argument helpers shared by the direct 1D kernels D1 (taut string), D2
(message-passing DP), D3 (Condat) and D4 (classic taut string), the Python
side of ``csrc/direct1d.cuh``.  All four are built in float32 and in
float64 (their C entries' ``_f64`` forms, :func:`entry`)."""
from __future__ import annotations

import torch

from .. import tv1d_l1
from . import gating


def entry(name, dtype):
    """The C entry point of kernel ``name``'s instantiation for ``dtype``:
    ``name`` in float32, ``name + "_f64"`` in float64."""
    return name + "_f64" if dtype == torch.float64 else name


def _weights(lam):
    """The weights as a tensor: a tensor as it is, anything else (a Python
    number, a list, a numpy array) in float64, so that a float64 batch's
    weights are not rounded to float32 on their way (a float32 batch's are
    rounded once, to its dtype)."""
    if torch.is_tensor(lam):
        return lam
    return torch.as_tensor(lam, dtype=torch.float64)


def lam_args(lam, B, n, device, dtype=torch.float32):
    """A weight argument as the C entry points of D1 and D2 take it:
    ``(field or None, row stride, column stride, scalar)``, in the batch's
    ``dtype``.  A scalar rides as the scalar; anything else is broadcast to
    (B, n-1) as ``tv1d_l1._edge_weights`` does and passed with its element
    strides (0 along a broadcast axis)."""
    lam_t = _weights(lam)
    if lam_t.ndim == 0:
        return None, 0, 0, float(lam_t)
    lamv = tv1d_l1._edge_weights(lam_t.to(device=device, dtype=dtype),
                                 B, n, dtype, device)
    rs, cs = lamv.stride()
    return lamv, rs, cs, 0.0


def signal_lam_args(lam, B, n, device, name, ref, dtype=torch.float32):
    """One weight a signal as the C entry points of D3 and D4 take it:
    ``(vector or None, row stride, scalar)``, in the batch's ``dtype``.
    Refuses a per-edge field and clamps negative weights to 0 as the plain
    versions do (``tv1d_l1._unweighted_lam``); a scalar rides as the
    scalar (rounded to ``dtype``), a (B,) vector through :func:`lam_args`
    (column stride 0)."""
    lam_t = _weights(lam)
    if lam_t.ndim == 0:
        return None, 0, max(float(lam_t.to(dtype)), 0.0)
    lamv = tv1d_l1._unweighted_lam(lam_t, B, n, dtype, device, name, ref)
    field, rs, _, _ = lam_args(lamv, B, n, device, dtype)
    return field, rs, 0.0


def check_batch(y, kind):
    """The checks the direct kernels' binds make: a CUDA (B, n) batch with n >= 2
    that the gate of ``kind`` lets through.  Returns it contiguous."""
    if not y.is_cuda:
        raise ValueError("bind takes a CUDA batch: the kernel has no CPU "
                         "mode")
    if y.ndim != 2 or y.shape[1] < 2:
        raise ValueError(f"the {kind} kernel takes a (B, n) batch with "
                         f"n >= 2; got {tuple(y.shape)}")
    gating.gate(y, kind)  # raises on what the kernel cannot take
    return y.contiguous()
