"""Solver state across packages: numpy arrays / dicts <-> the port's tensors.

What crosses between the JAX package and the port is solver state —
projected-Newton dual warm starts ``(K, n-1)``, PDHG dual pairs
``u0 = (u_row (B, M, N-1), u_col (B, M-1, N))``, TV-Lp ``(w, mu)`` pairs,
the ``SolverInfo`` fields and the config dataclasses — and the one weight of
the TV layers, ``raw_lam``.  Both sides speak numpy at the boundary, so each
helper takes or returns numpy arrays / plain dicts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .info import SolverInfo


def tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    """numpy-like array -> contiguous tensor on ``device`` (dtype kept unless
    given)."""
    arr = np.ascontiguousarray(np.asarray(a))
    t = torch.from_numpy(arr.copy())
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def numpy(t) -> np.ndarray:
    """Tensor (any device) -> numpy array."""
    return t.detach().cpu().numpy()


def pn_dual(w, device="cpu", dtype=None) -> torch.Tensor:
    """A ``(K, n-1)`` projected-Newton dual (``tv1_pn(..., return_dual=True)``)
    as a warm start for the port's ``tv1_pn(w_init=...)``."""
    t = tensor(w, device, dtype)
    if t.ndim != 2:
        raise ValueError(f"PN dual must be (K, n-1), got {tuple(t.shape)}")
    return t


def ms_alpha(a, device="cpu", dtype=None) -> torch.Tensor:
    """A ``(B,)`` More-Sorensen secular multiplier
    (``tv2_ms(..., return_alpha=True)``) as a warm start for the port's
    ``tv2_ms(alpha_init=...)``."""
    t = tensor(a, device, dtype)
    if t.ndim != 1:
        raise ValueError(f"MS alpha must be (B,), got {tuple(t.shape)}")
    return t


def lp_state(w, mu, device="cpu", dtype=None):
    """A TV-Lp warm start ``(w (K, n-1), mu (K,))``
    (``tvp_gpfw(..., return_state=True)``) as the port's
    ``tvp_gpfw(w_init=, mu_init=)`` pair."""
    tw, tm = tensor(w, device, dtype), tensor(mu, device, dtype)
    if tw.ndim != 2 or tm.ndim != 1 or tm.shape[0] != tw.shape[0]:
        raise ValueError(f"TV-Lp state must be (w (K, n-1), mu (K,)), got "
                         f"{tuple(tw.shape)} and {tuple(tm.shape)}")
    return tw, tm


def pdhg_duals(u0, device="cpu", dtype=None):
    """A PDHG dual pair ``(u_row, u_col)`` as the port's ``u0``."""
    u_row, u_col = u0
    return tensor(u_row, device, dtype), tensor(u_col, device, dtype)


def info_from(d, device="cpu") -> SolverInfo:
    """``SolverInfo`` from a dict or any object with iters/gap/rc fields."""
    get = d.__getitem__ if isinstance(d, dict) else lambda k: getattr(d, k)
    return SolverInfo(iters=tensor(get("iters"), device).to(torch.int32),
                      gap=tensor(get("gap"), device),
                      rc=tensor(get("rc"), device).to(torch.int32))


def info_to_dict(info: SolverInfo) -> dict:
    return {"iters": numpy(info.iters), "gap": numpy(info.gap),
            "rc": numpy(info.rc)}


def config_from(cls, d):
    """A config dataclass of the port (``cls``) from a dict or from the JAX
    package's dataclass of the same name (field by field)."""
    if not isinstance(d, dict):
        d = dataclasses.asdict(d)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def layer_state(flax_params, device="cpu", dtype=None) -> dict:
    """A flax TV layer's variables (``{"params": {"raw_lam": array}}``, or
    the inner ``{"raw_lam": array}``) as the ``state_dict`` of the port's
    ``models.layers.TVDenoise1D`` / ``TVDenoise2D``."""
    params = flax_params.get("params", flax_params)
    return {"raw_lam": tensor(params["raw_lam"], device, dtype)}


def layer_params(module) -> dict:
    """The port's TV layer's weight as flax variables:
    ``{"params": {"raw_lam": numpy array}}``."""
    return {"params": {"raw_lam": numpy(module.raw_lam)}}
