"""Difference-operator helpers: the equivalents of reference ``src/TVmacros.h``.

Conventions follow the reference exactly (``src/TVmacros.h:10-28``):

*   The difference operator ``D : R^n -> R^{n-1}`` used by the dual solvers is
    ``(Dx)[i] = x[i] - x[i+1]`` (``PRIMAL2GRAD``).
*   Its adjoint is ``(D'w)[i] = w[i] - w[i-1]`` with ``w[-1] = w[n-1] = 0``
    (``DUAL2PRIMAL``: ``x = y + D'w``).
*   ``dy`` as used in solver precomputations is ``y[i+1] - y[i]`` = ``-(Dy)``.

All functions operate on the last axis and support arbitrary leading batch axes.
"""
from __future__ import annotations

import torch


def forward_diff(y):
    """``y[i+1] - y[i]`` along the last axis (length n-1)."""
    return y[..., 1:] - y[..., :-1]


def primal2grad(x):
    """Reference ``PRIMAL2GRAD``: ``g[i] = x[i] - x[i+1]`` (length n-1)."""
    return x[..., :-1] - x[..., 1:]


def adjoint_diff(w):
    """Reference adjoint: ``(D'w)[i] = w[i] - w[i-1]`` (length n), zero-padded ends."""
    zero = torch.zeros_like(w[..., :1])
    return torch.cat([w, zero], dim=-1) - torch.cat([zero, w], dim=-1)


def dual2primal(w, y):
    """Reference ``DUAL2PRIMAL``: ``x = y + D'w``."""
    return y + adjoint_diff(w)


def dual_objective(w, y):
    """Reference ``DUALVAL``: ``sum_i (D'w)_i (0.5 (D'w)_i - y_i)``
    = ``0.5 ||D'w||^2 - w' D y`` (src/TVmacros.h:24-28)."""
    dtw = adjoint_diff(w)
    return torch.sum(dtw * (0.5 * dtw - y), dim=-1)


def tv1_objective(x, y, lam):
    """Primal objective ``0.5 ||x - y||^2 + lam * sum |x_{i+1} - x_i|``."""
    fid = 0.5 * torch.sum((x - y) ** 2, dim=-1)
    tv = torch.sum(torch.abs(forward_diff(x)), dim=-1)
    return fid + lam * tv


def tv1w_objective(x, y, w):
    """Weighted primal objective ``0.5 ||x - y||^2 + sum_i w_i |x_{i+1} - x_i|``."""
    fid = 0.5 * torch.sum((x - y) ** 2, dim=-1)
    tv = torch.sum(w * torch.abs(forward_diff(x)), dim=-1)
    return fid + tv


def tvp_objective(x, y, lam, p):
    """Lp primal objective ``0.5 ||x - y||^2 + lam * ||Dx||_p``."""
    from .lpnorms import lp_norm

    fid = 0.5 * torch.sum((x - y) ** 2, dim=-1)
    return fid + lam * lp_norm(forward_diff(x), p)
