"""Stabilized Lp-norm primitives (reference ``src/LPopt.cpp:43-76`` semantics),
the port's copy of ``proxtv_tpu.utils.lpnorms``.

The reference clamps the norm degree: values of p below ``LPPROJ_PSMALL = 1.002``
are treated as L1 and values above ``LPPROJ_PLARGE = 100`` as Linf
(``src/LPopt.h:33-36``), and the general case is computed in max-normalized form
``norm(x, p) = norm(x, inf) * (sum_i |x_i / norm(x, inf)|^p)^(1/p)`` for stability.
"""
from __future__ import annotations

import torch

P_SMALL = 1.002
P_LARGE = 100.0


def dual_exponent(p):
    """Holder conjugate q = 1 / (1 - 1/p)."""
    return 1.0 / (1.0 - 1.0 / p)


def lp_norm(x, p: float, dim: int = -1):
    """Stabilized Lp norm along ``dim`` for a Python-float ``p``, with the
    reference's clamping rules: p <= 1.002 -> L1, p >= 100 -> Linf."""
    l1 = torch.sum(torch.abs(x), dim=dim)
    c = torch.amax(torch.abs(x), dim=dim)
    if p <= P_SMALL:
        return l1
    if p >= P_LARGE:
        return c
    safe_c = torch.where(c == 0, torch.ones_like(c), c)
    s = torch.sum(torch.abs(x / safe_c.unsqueeze(dim)) ** p, dim=dim)
    return torch.where(c == 0, torch.zeros_like(c), c * s ** (1.0 / p))
