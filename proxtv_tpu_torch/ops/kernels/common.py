"""Shared lane-shift / row-padding helpers of the kernels' plain versions
(the port's copy of ``proxtv_tpu.ops.kernels.common``)."""
from __future__ import annotations

import torch


def shift_right(x, s, fill):
    """result[..., i] = x[..., i - s]; vacated lanes take ``fill``."""
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def shift_left(x, s, fill):
    """result[..., i] = x[..., i + s]; vacated lanes take ``fill``."""
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def pad_rows(x, tb):
    """Zero-pad the leading (row) axis up to a multiple of the tile height."""
    B = x.shape[0]
    Bp = -(-B // tb) * tb
    if Bp == B:
        return x
    return torch.cat([x, x.new_zeros((Bp - B,) + tuple(x.shape[1:]))], dim=0)
