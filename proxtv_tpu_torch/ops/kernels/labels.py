"""Kernel L1: the flat 4-connected components of a batch of 2D solutions
(the backward of ``diffprox.tv2d_prox``).

No TPU kernel: it replaces the JAX package's XLA ``while_loop``
``proxtv_tpu/ops/diffprox.py:_component_labels``; the CUDA source is
``proxtv_tpu_torch/csrc/labels.cu``, block-based union-find in three
launches with no host read, built for float32 and float64 X (the labels
int32 in both; :data:`LAUNCHES` counts the float32 launches,
:data:`LAUNCHES_F64` the float64 ones).  Each pixel's label is the minimum
linear index (within its image) of its component, where an edge is flat
when ``|X[next] - X[here]| <= tol[b]``.

:func:`component_labels` launches the kernel for a CUDA tensor and runs
:func:`component_labels_plain` (min-label propagation, one host read a
trip, counted in :data:`LABEL_TRIPS`) for a CPU tensor; :func:`bind` makes
its C call once, for tools that time the kernel alone.
"""
from __future__ import annotations

import torch

from ...utils import debug
from . import build

LAUNCHES = debug.Counter()
LAUNCHES_F64 = debug.Counter()
# Trips of the plain version's label propagation (two hops each).
LABEL_TRIPS = debug.Counter()


def flat_edges(X, tol):
    """The edges of ``X`` (B, M, N) within ``tol`` (B,) of flat:
    (flat_r (B, M, N-1), flat_c (B, M-1, N))."""
    t = tol[:, None, None]
    return ((X[:, :, 1:] - X[:, :, :-1]).abs() <= t,
            (X[:, 1:, :] - X[:, :-1, :]).abs() <= t)


def _component_labels(flat_r, flat_c, shape):
    """Min-label propagation over 4-connected flat edges.

    flat_r (B, M, N-1) / flat_c (B, M-1, N): True where the solution is flat
    across the edge.  Returns (B, M, N) int32 component labels (minimum linear
    index in each component).  Two hops a trip; the loop stops when a trip
    changes nothing, read on the host once a trip."""
    B, M, N = shape
    dev = flat_r.device
    lab = (torch.arange(M * N, device=dev, dtype=torch.int32)
           .reshape(1, M, N).expand(B, M, N).contiguous())
    big = torch.tensor(M * N, dtype=torch.int32, device=dev)

    def nbr_min(lab):
        out = lab.clone()
        # right and left neighbours across flat row edges
        r = torch.where(flat_r, lab[:, :, 1:], big)
        out[:, :, :-1] = torch.minimum(out[:, :, :-1], r)
        lft = torch.where(flat_r, lab[:, :, :-1], big)
        out[:, :, 1:] = torch.minimum(out[:, :, 1:], lft)
        # down and up neighbours across flat column edges
        d = torch.where(flat_c, lab[:, 1:, :], big)
        out[:, :-1, :] = torch.minimum(out[:, :-1, :], d)
        u = torch.where(flat_c, lab[:, :-1, :], big)
        out[:, 1:, :] = torch.minimum(out[:, 1:, :], u)
        return out

    while True:
        # Two hops per trip: O(diameter / 2) trips, one host read each.
        lab2 = nbr_min(nbr_min(lab))
        LABEL_TRIPS.value += 1
        changed = debug.host(torch.any(lab2 != lab))
        lab = lab2
        if not changed:
            return lab


def component_labels_plain(X, tol):
    """The plain version: (B, M, N) int32 labels of ``X``'s flat components
    (tolerance ``tol`` (B,)) by min-label propagation."""
    return _component_labels(*flat_edges(X, tol), X.shape)


def _check(X, tol):
    if (X.dtype not in (torch.float32, torch.float64)
            or tol.dtype != X.dtype):
        raise TypeError(f"component_labels on the card takes float32 or "
                        f"float64, X and tol alike (X {X.dtype}, tol "
                        f"{tol.dtype}): kernel L1 has no other type, and the "
                        "card runs no plain version")
    if X.ndim != 3 or tuple(tol.shape) != (X.shape[0],):
        raise ValueError(f"component_labels takes X (B, M, N) and tol (B,), "
                         f"got {tuple(X.shape)} and {tuple(tol.shape)}")
    if not (X.is_contiguous() and tol.is_contiguous()):
        raise ValueError("component_labels on the card takes contiguous X and "
                         "tol")
    if tol.device != X.device:
        raise ValueError(f"X on {X.device}, tol on {tol.device}")
    if X.shape[1] * X.shape[2] >= 2 ** 31:
        raise ValueError(f"component_labels: M N = {X.shape[1] * X.shape[2]} "
                         "overflows the int32 labels")


def bind(X, tol):
    """The C entry point's call for a CUDA batch, its arguments made once.
    Returns ``(labels, launch)``: ``launch()`` writes ``labels`` (B, M, N)
    int32 and keeps every tensor its pointers name alive; it does not count
    in :data:`LAUNCHES`."""
    _check(X, tol)
    B, M, N = X.shape
    labels = torch.empty(X.shape, dtype=torch.int32, device=X.device)
    args = (build.ptr(X), build.ptr(tol), build.ptr(labels), B, M, N,
            build.stream_ptr(X.device))
    name = ("component_labels_f64" if X.dtype == torch.float64
            else "component_labels")

    # keep: every tensor the pointers name, the output too.
    def launch(keep=(X, tol, labels)):
        build.check(getattr(build.lib(), name)(*args), name)

    return labels, launch


def component_labels(X, tol):
    """(B, M, N) int32 labels of the flat components of ``X`` (B, M, N),
    an edge flat within ``tol`` (B,).  A CUDA tensor must be float32 or
    float64 and contiguous (kernel L1's instantiation for it launches or
    this raises); a CPU tensor runs the plain version."""
    if not X.is_cuda:
        return component_labels_plain(X, tol)
    labels, launch = bind(X, tol)
    if labels.numel() > 0:
        launch()
        (LAUNCHES_F64 if X.dtype == torch.float64 else LAUNCHES).value += 1
    return labels
