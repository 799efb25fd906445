"""Segmented scans over a 1D-banded signal (port of
``proxtv_tpu.parallel.segscan``).

The long-signal escalation (plateau snap, pinned-edge stitch: see
``ops/tv1d_long_banded.py``) needs per-element segment statistics (mean,
min) where a segment may span rank boundaries.  Within a rank they are the
log-shift scans of ``ops.tv1d_long._segment_mean_scan``, in the JAX shift
order; across ranks, one all-gather of each rank's (open-boundary value,
has-boundary flag) summary and a chain of carries over the mesh.

Segment conventions: ``seg_start`` marks the FIRST element of each segment
(element 0 of the global signal is always a start); values accumulate
inclusively from the segment head (forward) or tail (reverse).
"""
from __future__ import annotations

import torch

from ..ops.kernels.common import shift_left, shift_right
from . import comm


def _local_scan(v, s, op, fill, reverse):
    """Inclusive segmented scan within the rank's block: ``v[..., i]``
    becomes op over [head_i, i] (forward) or [i, tail_i] (reverse), head or
    tail the nearest set flag or the block's end; ``s`` becomes the
    any-flag-seen indicator."""
    n = v.shape[-1]
    shift = shift_left if reverse else shift_right
    k = 1
    while k < n:
        vs = shift(v, k, fill)
        ss = shift(s, k, 0.0)
        v = op(v, torch.where(s > 0, fill, vs))
        s = torch.maximum(s, ss)
        k <<= 1
    return v, s


def dist_seg_scan(v, flags, op, fill, mesh, reverse: bool = False):
    """Inclusive segmented scan of ``v`` (rows (..., n_local)) with shared
    per-position ``flags`` ((n_local,) float 0/1: forward = segment starts,
    reverse = segment ends), composed across the mesh's band."""
    v, s = _local_scan(v, torch.broadcast_to(flags, v.shape), op, fill,
                       reverse)
    if mesh.size == 1:
        return v
    edge = 0 if reverse else -1
    summ = comm.all_gather(mesh, torch.stack([v[..., edge], s[..., edge]])[None])
    v_b, s_b = summ[:, 0], summ[:, 1]                 # (D, ...)
    carry = torch.full_like(v_b[0], fill)
    # The carry entering rank d comes from ranks d+1.. (reverse) or ..d-1.
    ranks = (range(mesh.size - 2, mesh.rank - 1, -1) if reverse
             else range(1, mesh.rank + 1))
    for d in ranks:
        src = d + 1 if reverse else d - 1
        carry = op(v_b[src], torch.where(s_b[src] > 0, fill, carry))
    return op(v, torch.where(s > 0, fill, carry[..., None]))


def segment_mean(x, seg_start, mesh, seg_end):
    """Per-element mean of the (possibly cross-rank) segment holding each
    element.  ``seg_end``: segment-end flags (``seg_start`` shifted left by
    one with the right neighbour's first flag; the caller knows the band's
    topology)."""
    f = seg_start.to(x.dtype)
    fe = seg_end.to(x.dtype)
    stacked = torch.stack([x, torch.ones_like(x)])
    fwd = dist_seg_scan(stacked, f, torch.add, 0.0, mesh)
    rev = dist_seg_scan(stacked, fe, torch.add, 0.0, mesh, reverse=True)
    tot = fwd[0] + rev[0] - x
    cnt = fwd[1] + rev[1] - 1.0
    return tot / cnt


def segment_min(v, seg_start, mesh, seg_end):
    """Per-element minimum over the (possibly cross-rank) segment."""
    big = float(torch.finfo(v.dtype).max)
    f = seg_start.to(v.dtype)
    fe = seg_end.to(v.dtype)
    fwd = dist_seg_scan(v, f, torch.minimum, big, mesh)
    rev = dist_seg_scan(v, fe, torch.minimum, big, mesh, reverse=True)
    return torch.minimum(fwd, rev)
