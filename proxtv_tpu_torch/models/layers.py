"""Differentiable TV-prox layers (``torch.nn.Module``), the port's
counterpart of ``proxtv_tpu.models.layers`` (flax modules there).

Proxes as *layers* inside gradient-trained models: plug-and-play denoisers,
unrolled optimization, a learned regularization strength.  Built on the
exact generalized-Jacobian VJPs of :mod:`proxtv_tpu_torch.ops.diffprox`.

Example::

    layer = TVDenoise1D(device="cuda")     # lam is a learnable parameter
    x = layer(y)                           # denoised signal, differentiable

The one weight, ``raw_lam``, is made at construction on ``device`` in
``dtype`` (flax makes it lazily, in the input's dtype): by default on the
card in the dtype the API solves in there (``api._dtype``: float32, or
float64 where torch's default dtype is float64); ``device="cpu"`` gives
float64, as the tests run.  ``utils.interop.layer_state`` /
``layer_params`` carry it to and from the flax layers'
``{"params": {"raw_lam": ...}}``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import diffprox


def _softplus_inv(v: float) -> float:
    return math.log(math.expm1(max(v, 1e-6)))


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``);
    ``torch.nn.functional.softplus`` turns into the identity past its
    threshold instead."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _raw_lam(init_lam, device, dtype):
    from ..api import _device

    dev, dt = _device(device)
    return nn.Parameter(torch.tensor(_softplus_inv(init_lam),
                                     dtype=dtype or dt, device=dev))


class TVDenoise1D(nn.Module):
    """1D TV-L1 prox layer with a learnable penalty.

    Input (B, n); the penalty is ``softplus(raw_lam)`` to stay positive.
    Gradients flow to both the input and the penalty (exact generalized
    Jacobians — segment averaging / jump-sign sensitivity).
    """

    def __init__(self, init_lam: float = 0.1, method: str = "pn",
                 device=None, dtype=None):
        super().__init__()
        self.init_lam = init_lam
        self.method = method
        self.raw_lam = _raw_lam(init_lam, device, dtype)

    def forward(self, y):
        return diffprox.tv1_prox(y, _softplus(self.raw_lam), self.method)


class TVDenoise2D(nn.Module):
    """2D anisotropic TV-L1 prox layer with a learnable penalty.

    Input (B, M, N).  The penalty gets a zero gradient through the 2D VJP
    (see ``diffprox.tv2d_prox``): tune it by outer finite differences, or
    treat it as fixed.  Input gradients are exact (flat-component
    averaging).
    """

    def __init__(self, init_lam: float = 0.1, method: str = "dr",
                 max_iters: int = 0, device=None, dtype=None):
        super().__init__()
        self.init_lam = init_lam
        self.method = method
        self.max_iters = max_iters
        self.raw_lam = _raw_lam(init_lam, device, dtype)

    def forward(self, y):
        return diffprox.tv2d_prox(y, _softplus(self.raw_lam), self.method,
                                  self.max_iters)
