"""Solver state across packages: numpy arrays / dicts <-> the port's tensors.

The system has no learned weights; what crosses between the JAX package and
the port is solver state — projected-Newton dual warm starts ``(K, n-1)``,
PDHG dual pairs ``u0 = (u_row (B, M, N-1), u_col (B, M-1, N))``, the
``SolverInfo`` fields and the config dataclasses.  Both sides speak numpy at
the boundary, so each helper takes or returns numpy arrays / plain dicts.
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
