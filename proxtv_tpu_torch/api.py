"""User-facing API with the reference's function names, signatures and defaults
(the port's counterpart of ``proxtv_tpu.api``; reference ``prox_tv/__init__.py``).

Ported: ``tv1_1d``, ``tv1w_1d``, ``tv2_1d``, ``tvp_1d``, ``tv1_2d``,
``tv1w_2d``, ``tvp_2d``, ``tvgen``, ``tvgen_nd``, ``tv`` and ``tv_value``.
``tv1_1d`` / ``tv1w_1d`` auto past n = 16384 run the long-signal route
(:func:`proxtv_tpu_torch.ops.tv1d_long.tv1_long`: overlapped windows on
kernel B1, dual glue, certificate), as the JAX package does.

Inputs are numpy-like arrays; outputs are numpy arrays.  The entry points run
on the card (``device="cuda"``) unless the caller passes ``device="cpu"``
(float64, as the tests run).  With no card and no ``device="cpu"`` they
raise.  On the card they solve in float32, the JAX package's accelerator
precision, unless torch's default dtype is float64
(``torch.set_default_dtype(torch.float64)``, the counterpart of the JAX
package's ``jax_enable_x64``, under which its API computes in float64):
then they solve in float64 on the JAX package's float64 route (the
kernels' double instantiations, ``LAUNCHES_F64``) and return float64.
:func:`_dtype` decides it for every entry point.  ``tv1_1d`` and
``tv1w_1d`` run a taut-string solve on the native host engine
(``runtime.native``) only when the caller asks for the host: with
``device="cpu"`` (where the JAX package's host policy applies) or with
``backend="host"``; the result has the dtype the device route would give.
For batched, device-resident use
call :mod:`proxtv_tpu_torch.ops` / :mod:`proxtv_tpu_torch.models` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import tv1d_l1
from .utils import debug
from .utils.config import TV1Config
from .utils.info import SolverInfo

_TV1_METHODS = {"classictautstring", "linearizedtautstring", "hybridtautstring",
                "pn", "condat", "dp", "condattautstring", "kolmogorov"}

# Methods served by the native host taut string with backend="auto" (the
# JAX package's set): 'condat' and 'classictautstring' name engines of
# their own, and the host library runs the linearized scan.
_TAUTSTRING_METHODS = {"linearizedtautstring", "hybridtautstring",
                       "condattautstring"}
_BACKENDS = ("auto", "cuda", "host")
# Longest signal auto sends to the host engine (the JAX package's bound).
_HOST_MAX_N = 16384


def _dtype(dev):
    """The dtype a solve on ``dev`` takes: float64 on the CPU; on the card
    float64 where torch's default dtype is float64 (the JAX package's
    ``jax_enable_x64``), float32 otherwise."""
    if dev.type == "cpu" or torch.get_default_dtype() == torch.float64:
        return torch.float64
    return torch.float32


def _device(device):
    """The solve's device (CUDA unless ``device`` says otherwise) and its
    dtype (:func:`_dtype`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "proxtv_tpu_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to solve on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev, _dtype(dev)


def _tensor(x, dev, dt):
    """numpy-like input -> tensor of the solve's dtype on its device."""
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=dt).to(dev)


def _ret(x2d, info, return_info):
    x = x2d[0].detach().cpu().numpy()
    if return_info:
        return x, info
    return x


def _host_route(backend, device, method, family, return_info, auto, n):
    """Whether a 1D TV-L1 call runs on the native host engine, and the
    dtype its result takes (the device route's, :func:`_dtype`).

    ``backend="host"`` asks for it: a taut-string method without
    ``return_info``, and a compiler to build the engine, or this raises.
    ``backend="auto"`` takes it where the JAX package's policy does, but
    only for a CPU solve (``device="cpu"``): a taut-string method without
    ``return_info``, auto only up to n = 16384.  ``backend="cuda"`` never
    does.  Returns ``(take, dtype)``."""
    from .runtime import native

    dev = torch.device("cuda" if device is None else device)
    cpu = dev.type == "cpu"
    dt = np.float64 if _dtype(dev) == torch.float64 else np.float32
    if backend == "host":
        if method not in family or return_info:
            raise ValueError(
                f"backend='host' runs the taut string ({sorted(family)}) "
                f"without return_info; got method={method!r}, "
                f"return_info={return_info}")
        if not native.available():
            raise RuntimeError("backend='host' needs a C++ compiler to build "
                               "the native host engine and none was found")
        return True, dt
    take = (backend == "auto" and cpu and method in family
            and not return_info and (not auto or n <= _HOST_MAX_N)
            and native.available())
    return take, dt


def tv1_1d(x, w, method="auto", sigma=0.05, maxbacktracks=None,
           return_info=False, backend="auto", device=None):
    """1D TV-L1 prox: min_y 0.5||x-y||^2 + w * sum |y_{i+1} - y_i|.

    Reference: prox_tv/__init__.py:124-216.  Methods: auto (default),
    classictautstring, linearizedtautstring, hybridtautstring (the
    reference's default), pn, condat, dp, condattautstring, kolmogorov.

    **Auto policy** on the card: ``tv1_batched(..., strict=False)``,
    kernel B1 up to n = 8192 and the taut string past it (kernel D1); in
    float64 (:func:`_dtype`) the taut string at every n (D1 in double), as
    the JAX package's float64 route runs it.  Past
    n = 16384 auto runs the long-signal route on both devices
    (:func:`tv1d_long.tv1_long`: its windows in one launch of kernel B1 on
    the card, then the dual glue and its certificate, whose
    :class:`SolverInfo` is returned; ``proxtv_tpu/api.py:124-131``).  With
    ``device="cpu"`` auto follows the JAX package
    (``proxtv_tpu/api.py:70-141``): the native host taut string for a
    single signal of n <= 16384 without ``return_info``, the taut string
    otherwise, the long-signal route past 16384.  With ``maxbacktracks``
    set, auto up to n = 16384 runs the message-passing DP (worst case O(n),
    no backtracks), as the reference's hybrid bound intends; past it auto
    runs the long-signal route all the same, as in the JAX package.

    An **explicit** method runs the named engine on every device: on the
    card the taut string is kernel D1, the DP kernel D2, ``pn`` projected
    Newton (its Newton systems on kernel B2), Condat kernel D3 and the
    classic taut string kernel D4.  With ``device="cpu"``, an explicit taut-string
    method without ``return_info`` runs on the host engine at any size, as
    in the JAX package.  ``backend="host"`` asks for the host engine on any
    device (a taut-string method, no ``return_info``); ``backend="cuda"``
    (the JAX package's ``"tpu"``) forces the device route.  ``return_info``
    of a direct engine is ``SolverInfo.single(0, 0.0)``.
    """
    auto = method == "auto"
    if auto:
        method = "hybridtautstring"
    assert method in _TV1_METHODS, f"unknown method {method}"
    assert w >= 0
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}; got "
                         f"{backend!r}")
    if auto and maxbacktracks is not None and method in _TAUTSTRING_METHODS:
        method = "dp"
    n = int(np.asarray(x).size)
    host, host_dt = _host_route(backend, device, method, _TAUTSTRING_METHODS,
                                return_info, auto, n)
    if host:
        from .runtime import native

        debug.HOST_ROUTE.value += 1
        return np.asarray(native.tv1_host(x, float(w)), dtype=host_dt)
    dev, dt = _device(device)
    y = _tensor(x, dev, dt).reshape(1, -1)
    if auto and n > _HOST_MAX_N:  # auto is 'hybridtautstring' or 'dp' here
        from .ops import tv1d_long

        out, info = tv1d_long.tv1_long(y[0], float(w))
        return _ret(out[None], info, return_info)
    if method == "pn":
        cfg = TV1Config(sigma=float(sigma))
        out, info = tv1d_l1.tv1_pn(y, float(w), cfg=cfg)
        return _ret(out, info, return_info)
    out = tv1d_l1.tv1_batched(y, float(w), method=method, strict=not auto)
    info = (SolverInfo.single(0, 0.0, dtype=out.dtype, device=out.device)
            if return_info else None)
    return _ret(out, info, return_info)


def tv1w_1d(x, w, method="auto", sigma=0.05, return_info=False,
            backend="auto", device=None):
    """Weighted 1D TV-L1 prox: min_y 0.5||x-y||^2 + sum_i w_i |y_{i+1} - y_i|.

    Reference: prox_tv/__init__.py:218-254.  Methods: auto (default),
    tautstring (the reference's default), pn, and dp (message passing).
    ``w`` holds len(x) - 1 nonnegative weights.

    Auto means the taut string: kernel D1 on the card
    (:func:`tv1d_l1.tv1_tautstring`) up to n = 16384, and past it the
    long-signal route with the weight vector (:func:`tv1d_long.tv1_long`,
    kernel B1 on the card; ``proxtv_tpu/api.py:175-181``), whose
    :class:`SolverInfo` is returned.  ``dp`` is kernel D2; ``pn`` is
    :func:`tv1d_l1.tv1_pn` with per-edge weights (its Newton systems on
    kernel B2).  The native host engine runs the taut string with
    ``device="cpu"`` as in the JAX package (auto up to n = 16384, an
    explicit ``tautstring`` at any size, no ``return_info``), and on any
    device with ``backend="host"``; ``backend="cuda"`` forces the device
    route.
    """
    auto = method == "auto"
    if auto:
        method = "tautstring"
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}; got "
                         f"{backend!r}")
    xv = np.asarray(x, dtype=float).ravel()
    wv = np.asarray(w, dtype=float).ravel()
    assert wv.size == xv.size - 1, "w must hold len(x) - 1 weights"
    assert (wv >= 0).all()
    host, host_dt = _host_route(backend, device, method, {"tautstring"},
                                return_info, auto, xv.size)
    if host:
        from .runtime import native

        debug.HOST_ROUTE.value += 1
        return np.asarray(native.tv1w_host(xv, wv), dtype=host_dt)
    dev, dt = _device(device)
    y = _tensor(xv, dev, dt).reshape(1, -1)
    lam = _tensor(wv, dev, dt).reshape(1, -1)
    if auto and xv.size > _HOST_MAX_N:
        from .ops import tv1d_long

        out, info = tv1d_long.tv1_long(y[0], lam[0])
        return _ret(out[None], info, return_info)
    if method in ("tautstring", "dp"):
        engine = (tv1d_l1.tv1_tautstring if method == "tautstring"
                  else tv1d_l1.tv1_dp)
        out = engine(y, lam)
        info = (SolverInfo.single(0, 0.0, dtype=out.dtype, device=out.device)
                if return_info else None)
        return _ret(out, info, return_info)
    if method == "pn":
        cfg = TV1Config(sigma=float(sigma))
        out, info = tv1d_l1.tv1_pn(y, lam, cfg=cfg)
        return _ret(out, info, return_info)
    raise ValueError(f"unknown method {method}")


def _tv1_2d_auto(is_cuda, dtype):
    """``tv1_2d``'s auto method: the fused accelerated primal-dual on the
    card in float32 (``proxtv_tpu/api.py:241-244`` picks it only for
    float32 on its accelerator), Douglas-Rachford otherwise."""
    return ("chambolle-pock-acc" if is_cuda and dtype == torch.float32
            else "dr")


def tv1_2d(x, w, n_threads=1, max_iters=0, method="auto", return_info=False,
           device=None):
    """2D anisotropic TV-L1 prox (reference prox_tv/__init__.py:355-443).

    Methods: auto (default — the fused accelerated primal-dual, kernel B3,
    on CUDA float32, Douglas-Rachford elsewhere, float64 on the card
    among them, mirroring the JAX package's auto on its accelerator), dr
    (the reference default; its fiber passes run kernel B1 on the card),
    pd, yang, condat, chambolle-pock, chambolle-pock-acc, kolmogorov.
    ``n_threads`` is accepted for API compatibility.
    """
    from .models import tv2d

    dev, dt = _device(device)
    y = _tensor(x, dev, dt)[None]
    if method == "auto":
        method = _tv1_2d_auto(y.is_cuda, y.dtype)
    out, info = tv2d.tv1_2d_batched(y, float(w), method=method,
                                    max_iters=int(max_iters))
    return _ret(out, info, return_info)


def tv1w_2d(x, w_col, w_row, max_iters=0, n_threads=1, return_info=False,
            device=None):
    """Weighted 2D TV-L1 prox via Douglas-Rachford (reference :445-481):
    ``w_col`` (M-1, N) weights the column edges, ``w_row`` (M, N-1) the row
    edges.  On the card its fiber passes run kernel B1 with per-edge
    weights."""
    from .models import tv2d

    X = np.asarray(x, dtype=float)
    M, N = X.shape
    w_col = np.asarray(w_col, dtype=float)
    w_row = np.asarray(w_row, dtype=float)
    assert w_col.shape == (M - 1, N)
    assert w_row.shape == (M, N - 1)
    assert (w_col >= 0).all() and (w_row >= 0).all()
    dev, dt = _device(device)
    out, info = tv2d.tv1w_2d_batched(_tensor(X, dev, dt)[None],
                                     _tensor(w_col, dev, dt)[None],
                                     _tensor(w_row, dev, dt)[None],
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
    (reference ``matlab/TV.m:22-84``):

    *   a pair (list/tuple) of weight matrices: weighted 2D TV via
        :func:`tv1w_2d` (``lam[0]`` the column edges (M-1, N), ``lam[1]``
        the row edges (M, N-1)); 2D ``y`` and p = 1 only;
    *   a weight vector of length len(y) - 1: weighted 1D TV via
        :func:`tv1w_1d`; 1D ``y`` and p = 1 only;
    *   a scalar and 1D ``y``: p = 1 → :func:`tv1_1d`, p = 2 →
        :func:`tv2_1d`, any other p → :func:`tvp_1d`;
    *   a scalar and ND ``y``: :func:`tvgen` with ``lam`` and ``p``
        replicated over every dimension (TV.m:79-80).
    """
    if isinstance(lam, (list, tuple)):
        if np.asarray(y).ndim != len(lam):
            raise ValueError(
                "for an N-dimensional signal the weights must be provided "
                "as a sequence of length N (reference TV.m:33)")
        if len(lam) != 2:
            raise ValueError("only 1D and 2D weighted filtering is supported "
                             "(reference TV.m:37)")
        if p != 1:
            raise ValueError("only the L1 norm is accepted for weighted TV "
                             "(reference TV.m:41)")
        return tv1w_2d(y, lam[0], lam[1], max_iters=max_iters,
                       n_threads=threads, return_info=return_info,
                       device=device)
    lam_arr = np.asarray(lam, dtype=float)
    if lam_arr.size > 1:
        yv = np.asarray(y)
        if yv.ndim != 1:
            raise ValueError("only 1-dimensional signals are accepted for "
                             "vector-weighted TV (reference TV.m:58)")
        if lam_arr.size != yv.size - 1:
            raise ValueError(
                "lam should be a scalar or a weight vector with "
                "len(lam) == len(y) - 1 (reference TV.m:54)")
        if p != 1:
            raise ValueError("only the L1 norm is accepted for weighted TV "
                             "(reference TV.m:62)")
        return tv1w_1d(y, lam_arr, return_info=return_info, device=device)
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
