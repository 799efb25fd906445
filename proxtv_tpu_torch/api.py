"""User-facing API with the reference's function names, signatures and defaults
(the port's counterpart of ``proxtv_tpu.api``; reference ``prox_tv/__init__.py``).

Inputs are numpy-like arrays; outputs are numpy arrays.  The entry points run
on the card (``device="cuda"``, float32, the JAX package's accelerator
precision) unless the caller passes ``device="cpu"`` (float64, as the tests
run).  With no card and no ``device="cpu"`` they raise.  For batched,
device-resident use call :mod:`proxtv_tpu_torch.ops` /
:mod:`proxtv_tpu_torch.models` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import tv1d_l1
from .utils.config import TV1Config

_TV1_METHODS = {"classictautstring", "linearizedtautstring", "hybridtautstring",
                "pn", "condat", "dp", "condattautstring", "kolmogorov"}


def _device(device):
    """The solve's device and dtype: CUDA float32 by default, float64 on an
    explicit CPU request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "proxtv_tpu_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to solve on the CPU")
        return dev, torch.float32
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev, torch.float64


def _ret(x2d, info, return_info):
    x = x2d[0].detach().cpu().numpy()
    if return_info:
        return x, info
    return x


def tv1_1d(x, w, method="auto", sigma=0.05, maxbacktracks=None,
           return_info=False, device=None):
    """1D TV-L1 prox: min_y 0.5||x-y||^2 + w * sum |y_{i+1} - y_i|.

    Reference: prox_tv/__init__.py:124-216.  Method strings as the reference
    (auto, classictautstring, linearizedtautstring, hybridtautstring, pn,
    condat, dp, condattautstring, kolmogorov); this slice runs ``pn`` and
    ``auto``, and ``auto`` goes to projected Newton (:func:`tv1d_l1.tv1_pn`,
    whose Newton systems run kernel B2 on the card): the native host engine
    and the direct scan engines the JAX package's auto picks arrive with
    ROADMAP A4 / A8.  An explicit direct method raises
    ``NotImplementedError``.  ``maxbacktracks`` is accepted for
    compatibility (projected Newton never backtracks a scan).
    """
    assert method == "auto" or method in _TV1_METHODS, f"unknown method {method}"
    assert w >= 0
    if method not in ("auto", "pn"):
        raise NotImplementedError(
            f"method={method!r}: the direct 1D engines are not ported yet "
            "(ROADMAP A8); use method='pn' or 'auto'")
    dev, dt = _device(device)
    y = torch.as_tensor(np.asarray(x, dtype=float).reshape(1, -1),
                        dtype=dt).to(dev)
    cfg = TV1Config(sigma=float(sigma))
    out, info = tv1d_l1.tv1_pn(y, float(w), cfg=cfg)
    return _ret(out, info, return_info)


def tv1_2d(x, w, n_threads=1, max_iters=0, method="auto", return_info=False,
           device=None):
    """2D anisotropic TV-L1 prox (reference prox_tv/__init__.py:355-443).

    Methods: auto (default — the fused accelerated primal-dual, kernel B3,
    on CUDA float32, Douglas-Rachford elsewhere, mirroring the JAX package's
    auto on its accelerator), dr (the reference default; its fiber passes
    run kernel B1 on the card), pd, yang, condat, chambolle-pock,
    chambolle-pock-acc, kolmogorov.  ``n_threads`` is accepted for API
    compatibility.
    """
    from .models import tv2d

    dev, dt = _device(device)
    y = torch.as_tensor(np.asarray(x, dtype=float)[None, ...],
                        dtype=dt).to(dev)
    if method == "auto":
        method = ("chambolle-pock-acc"
                  if y.is_cuda and y.dtype == torch.float32 else "dr")
    out, info = tv2d.tv1_2d_batched(y, float(w), method=method,
                                    max_iters=int(max_iters))
    return _ret(out, info, return_info)
