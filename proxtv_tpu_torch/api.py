"""User-facing API with the reference's function names, signatures and defaults
(the port's counterpart of ``proxtv_tpu.api``; reference ``prox_tv/__init__.py``).

Ported so far: ``tv1_1d`` (projected Newton), ``tv2_1d``, ``tvp_1d``,
``tv1_2d``, ``tvp_2d``, ``tvgen``, ``tvgen_nd``, ``tv`` (scalar-lam
branches) and ``tv_value``.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP item.

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


def _tensor(x, dev, dt):
    """numpy-like input -> tensor of the solve's dtype on its device."""
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=dt).to(dev)


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
    whose Newton systems run kernel B2 on the card up to n - 1 = 8192 and
    the PCR composition past it): the native host engine
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
    y = _tensor(x, dev, dt).reshape(1, -1)
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
    y = _tensor(x, dev, dt)[None]
    if method == "auto":
        method = ("chambolle-pock-acc"
                  if y.is_cuda and y.dtype == torch.float32 else "dr")
    out, info = tv2d.tv1_2d_batched(y, float(w), method=method,
                                    max_iters=int(max_iters))
    return _ret(out, info, return_info)


def tv2_1d(x, w, method="mspg", return_info=False, device=None):
    """1D TV-L2 (grouped-norm) prox: min_y 0.5||x-y||^2 + w ||Dy||_2.

    Reference: prox_tv/__init__.py:257-309.  Methods: ms, pg, mspg
    (default).  On the card ms and mspg run kernel B4 (n <= 8192; longer
    signals take the spectral secular path on ``torch.fft``).
    """
    assert w >= 0
    from .ops import tv1d_l2

    dev, dt = _device(device)
    y = _tensor(x, dev, dt).reshape(1, -1)
    out, info = tv1d_l2.tv2_batched(y, float(w), method=method)
    return _ret(out, info, return_info)


def tvp_1d(x, w, p, method="gpfw", max_iters=0, return_info=False,
           device=None):
    """1D TV-Lp prox: min_y 0.5||x-y||^2 + w ||Dy||_p.

    Reference: prox_tv/__init__.py:311-352.  Methods: gp, fw, gpfw
    (default), plus ogp and fista.  ``max_iters`` is honoured.  On the card
    gpfw runs kernel B5 for q = p/(p-1) in [1.12, 3.1] and n <= 8192 (its
    setup solve on B2), p = 2 kernel B4 and p <= 1.002 kernel B1; the other
    cases run the TV-Lp torch composition, as the JAX package does.
    """
    assert w >= 0 and p >= 1
    from .ops import tv1d_lp

    dev, dt = _device(device)
    y = _tensor(x, dev, dt).reshape(1, -1)
    out, info = tv1d_lp.tvp_batched(y, float(w), float(p), method=method,
                                    max_iters=int(max_iters))
    return _ret(out, info, return_info)


def tvp_2d(x, w_col, w_row, p_col, p_row, n_threads=1, max_iters=0,
           return_info=False, device=None):
    """2D general-norm TV prox via Douglas-Rachford (reference :484-530),
    for any p_col, p_row >= 1: on the card the fiber passes run kernel B1
    (p = 1), B4 (p = 2) or B5 (TV-Lp inside its gate)."""
    from .models import tv2d

    assert w_col >= 0 and w_row >= 0 and p_col >= 1 and p_row >= 1
    dev, dt = _device(device)
    y = _tensor(x, dev, dt)[None]
    out, info = tv2d.tvp_2d_batched(y, float(w_col), float(w_row),
                                    float(p_col), float(p_row),
                                    max_iters=int(max_iters))
    return _ret(out, info, return_info)


def tvgen(x, ws, ds, ps, n_threads=1, max_iters=0, return_info=False,
          device=None):
    """Generalized multidimensional TV prox (reference :533-600), with the
    intended (MATLAB) dispatch: a 2D signal penalized on both dims goes to
    Douglas-Rachford, two terms to Proximal Dykstra, more to Parallel
    Proximal Dykstra.  Any p >= 1 per term."""
    from .models import tvnd

    ws = [float(v) for v in ws]
    ds = [int(v) for v in ds]
    ps = [float(v) for v in ps]
    assert len(ws) == len(ds) == len(ps)
    dev, dt = _device(device)
    out, info = tvnd.tvgen_dispatch(_tensor(x, dev, dt), ws, ds, ps,
                                    max_iters=int(max_iters))
    return _ret(out[None], info, return_info)


def tvgen_nd(x, ws, ds, ps, max_iters=0, method="pd", return_info=False,
             device=None):
    """ND combiner with explicit method choice: 'pd' (Parallel Proximal
    Dykstra), 'pd2', 'pdr' (Parallel Douglas-Rachford, reference
    src/TVNDopt.cpp:280), 'yang', and for a 3D volume penalized on all dims
    with p = 1 on the card, 'condat' / 'chambolle-pock' /
    'chambolle-pock-acc' (kernel B6)."""
    from .models import tvnd

    dev, dt = _device(device)
    out, info = tvnd.tv_nd_batched(_tensor(x, dev, dt)[None],
                                   tuple(float(v) for v in ws),
                                   tuple(int(v) for v in ds),
                                   tuple(float(v) for v in ps),
                                   max_iters=int(max_iters), method=method)
    return _ret(out, info, return_info)


def tv(y, lam, p=1.0, threads=1, max_iters=0, return_info=False,
       device=None):
    """Polymorphic TV prox front end, dispatching on the type of ``lam``
    (reference ``matlab/TV.m:22-84``).  The scalar-lam branches are ported:
    a 1D ``y`` with p = 1 goes to :func:`tv1_1d`, p = 2 to :func:`tv2_1d`,
    any other p to :func:`tvp_1d`; an ND ``y`` goes to :func:`tvgen` with
    ``lam`` and ``p`` replicated over every dimension (TV.m:79-80).  A pair
    of weight matrices (weighted 2D, ROADMAP A6w) and a weight vector
    (weighted 1D, ROADMAP A8) raise ``NotImplementedError``."""
    if isinstance(lam, (list, tuple)):
        raise NotImplementedError("weighted 2D TV (a pair of weight "
                                  "matrices) is not ported yet: ROADMAP A6w")
    lam_arr = np.asarray(lam, dtype=float)
    if lam_arr.size > 1:
        raise NotImplementedError("vector-weighted 1D TV is not ported yet: "
                                  "ROADMAP A8")
    w = float(lam_arr)
    yv = np.asarray(y)
    if yv.ndim == 1:
        if p == 1:
            return tv1_1d(yv, w, return_info=return_info, device=device)
        if p == 2:
            return tv2_1d(yv, w, return_info=return_info, device=device)
        return tvp_1d(yv, w, float(p), max_iters=max_iters,
                      return_info=return_info, device=device)
    nd = yv.ndim
    return tvgen(yv, [w] * nd, list(range(1, nd + 1)), [float(p)] * nd,
                 n_threads=threads, max_iters=max_iters,
                 return_info=return_info, device=device)


def tv_value(x, ws, ds, ps, device=None):
    """Value of the generalized TV penalty (reference TVval,
    src/TVNDopt.cpp:524)."""
    from .models import tvnd

    dev, dt = _device(device)
    return float(tvnd.tv_value(_tensor(x, dev, dt), [float(v) for v in ws],
                               [int(v) for v in ds], [float(v) for v in ps]))
