"""Kernel B6: one K-iteration chunk of 3D anisotropic TV-L1 PDHG.

The primal-dual (Chambolle-Pock / Condat) iteration for

    min_X 0.5||X - Y||^2 + lam_L ||D_L X||_1 + lam_M ||D_M X||_1
                         + lam_N ||D_N X||_1

is a radius-1 stencil over three dual fields:

    u_a <- clip(u_a + sigma * D_a(xbar), +-lam_a)        a in {N, M, L}
    x'  <- (x - tau * sum_a D_a' u_a + tau * Y) / (1 + tau)
    xbar <- x' + theta (x' - x)

(``||D||^2 <= 12``, so tau = 0.9 / (12 sigma)).  Replaces the TPU kernel
``proxtv_tpu/ops/kernels/pdhg3d_fused.py:pdhg3d_chunk``; the CUDA source is
``proxtv_tpu_torch/csrc/pdhg3d_fused.cu``.  State lives on (Lp, Mp, N)
canvases holding ``count`` volumes stacked along L with period ``stride``;
cells outside a volume (gap layers, padding, the last edge of each axis)
carry lam = 0, which pins their duals to 0 and exactly decouples them.  The
valid M rows start at ``pad_m``, the first volume at layer ``pad_top``.

:func:`pdhg3d_chunk` launches the kernel for CUDA tensors and runs
:func:`pdhg3d_chunk_plain` (the TPU kernel's arithmetic on the whole canvas)
for CPU tensors.  Neither has a certificate inside: the driver computes it
between chunks.  :func:`sched_chunk3` and :func:`make_schedule3` are host
code in ``numpy.float32``, step for step with the JAX package's float32
arithmetic (the 2D schedule with three penalty columns).
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.debug import Counter
from . import build
from .gating import lane_limits, pdhg3d_params
from .pdhg_fused import sched_chunk

LAUNCHES = Counter()


def sched_chunk3(carry, k_steps, lams, sigma0, cap_mult, variant):
    """Next ``k_steps`` rows of the (sigma, tau, theta, lam_N, lam_M, lam_L)
    schedule from a carried (sigma, tau) pair (``pdhg3d_fused.py:208-230``),
    in float32 on the host.  Returns ((k_steps, 6) float32 array, carry)."""
    rows, carry = sched_chunk(carry, k_steps, 0.0, sigma0, cap_mult, variant)
    lam_cols = np.broadcast_to(np.asarray(lams, np.float32), (k_steps, 3))
    return np.concatenate([rows[:, :3], lam_cols], axis=1), carry


def make_schedule3(max_iters, lams, sigma0, tau0, variant, cap_mult=2.0):
    """(max_iters, 6) [sigma, tau, theta, lam_N, lam_M, lam_L] float32
    schedule (``pdhg3d_fused.py:233-255``)."""
    rows, _ = sched_chunk3((sigma0, tau0), max_iters, lams, sigma0, cap_mult,
                           variant)
    return rows


# Same-size zero-filled shifts on the canvas (kernel convention): the next
# cell along an axis, and the previous one.
def _next(X, dim):
    z = torch.zeros_like(X.narrow(dim, 0, 1))
    return torch.cat([X.narrow(dim, 1, X.shape[dim] - 1), z], dim=dim)


def _prev(X, dim):
    z = torch.zeros_like(X.narrow(dim, 0, 1))
    return torch.cat([z, X.narrow(dim, 0, X.shape[dim] - 1)], dim=dim)


def masks3(shape, n_valid, m_valid, l_valid, stride, count, pad_top=0,
           pad_m=0, device=None):
    """Validity of the three dual fields on an (Lp, Mp, N) canvas
    (``pdhg3d_fused.py:115-125``): (v1, v2, v3) bool for the N, M and L
    edges."""
    Lp, Mp, N = shape
    col = torch.arange(N, device=device)[None, None, :]
    rm = torch.arange(Mp, device=device)[None, :, None] - pad_m
    r = torch.arange(Lp, device=device)[:, None, None] - pad_top
    q = r - torch.div(r, stride, rounding_mode="floor") * stride
    in_img = ((r >= 0) & (r < count * stride) & (q <= l_valid - 1)
              & (rm >= 0) & (rm < m_valid) & (col < n_valid))
    return (in_img & (col < n_valid - 1), in_img & (rm < m_valid - 1),
            in_img & (q <= l_valid - 2))


def pdhg3d_chunk_plain(sched, x, xb, u1, u2, u3, y, k_steps: int,
                       n_valid: int, m_valid: int, l_valid: int, stride: int,
                       count: int, pad_top: int = 0, pad_m: int = 0,
                       grad_step: bool = False):
    """The TPU kernel's arithmetic (``pdhg3d_fused.py:108-155``) on the whole
    canvas.  A brick with a wide enough halo computes its core exactly, so
    the whole-canvas result equals the bricked one there.  Like the TPU
    kernel it does not sanitize x / xbar: garbage outside the volumes stays
    there (the duals next to it are pinned to 0)."""
    dt = x.dtype
    v1, v2, v3 = masks3(x.shape, n_valid, m_valid, l_valid, stride, count,
                        int(pad_top), int(pad_m), x.device)
    v1f, v2f, v3f = v1.to(dt), v2.to(dt), v3.to(dt)
    zero = torch.zeros((), dtype=dt, device=x.device)
    sched = sched.to(dt)
    for k in range(k_steps):
        sigma, tau, theta = sched[k, 0], sched[k, 1], sched[k, 2]
        lam1 = sched[k, 3] * v1f   # N-axis penalty
        lam2 = sched[k, 4] * v2f   # M-axis penalty
        lam3 = sched[k, 5] * v3f   # L-axis penalty
        # where(), not clip-to-0: cells outside the volumes may hold NaN.
        u1 = torch.where(v1, torch.clamp(u1 + sigma * (xb - _next(xb, 2)),
                                         -lam1, lam1), zero)
        u2 = torch.where(v2, torch.clamp(u2 + sigma * (xb - _next(xb, 1)),
                                         -lam2, lam2), zero)
        u3 = torch.where(v3, torch.clamp(u3 + sigma * (xb - _next(xb, 0)),
                                         -lam3, lam3), zero)
        div = ((u1 - _prev(u1, 2)) + (u2 - _prev(u2, 1))
               + (u3 - _prev(u3, 0)))
        if grad_step:  # Condat: explicit gradient step
            xn = x - tau * ((x - y) + div)
        else:          # CP: resolvent step
            xn = (x - tau * div + tau * y) / (1.0 + tau)
        xb = xn + theta * (xn - x)
        x = xn
    return x, xb, u1, u2, u3


def window_columns(k_steps: int, tile) -> int:
    """Threads of one CUDA block: the (tm + 2K) x (tn + 2K) window of
    columns around the block's (tm, tn) core."""
    _, tm, tn = tile
    return (tm + 2 * k_steps) * (tn + 2 * k_steps)


def smem_bytes(k_steps: int, tile) -> int:
    """Shared memory of one CUDA block: xbar, u1 and u2 of one layer of the
    window (the in-layer neighbours' values, reused by every step), and the
    schedule with 1 / (1 + tau) per step."""
    return 3 * 4 * window_columns(k_steps, tile) + 4 * 7 * k_steps


def pdhg3d_chunk(sched, x, xb, u1, u2, u3, y, k_steps: int, n_valid: int,
                 m_valid: int, l_valid: int, stride: int, count: int,
                 pad_top: int = 0, pad_m: int = 0, grad_step: bool = False,
                 tile=None):
    """Run one K-iteration chunk over a whole (Lp, Mp, N) canvas.

    ``sched`` is the (k_steps, 6) schedule slice (a tensor on the canvas's
    device).  ``tile`` is the CUDA kernel's block: a (tm, tn) core of
    columns that marches along a segment of tl layers (default
    :func:`gating.pdhg3d_params`).  The C entry point takes ``k_steps`` in
    1, 2, 3, 4, 6, 8 and a window of (tm + 2K)(tn + 2K) columns within its
    thread cap for that K (``csrc/pdhg3d_fused.cu:max_threads``), and
    reports anything else as an invalid argument, which raises here.
    Returns fresh (x, xbar, u1, u2, u3); outputs never alias inputs.
    """
    if not x.is_cuda:
        return pdhg3d_chunk_plain(sched, x, xb, u1, u2, u3, y, k_steps,
                                  n_valid, m_valid, l_valid, stride, count,
                                  pad_top, pad_m, grad_step)
    Lp, Mp, N = x.shape
    tile = tuple(tile or pdhg3d_params()[1])
    lo, hi = lane_limits("pdhg3d")
    for f in (x, xb, u1, u2, u3, y):
        if (f.dtype != torch.float32 or tuple(f.shape) != (Lp, Mp, N)
                or f.device != x.device or not f.is_contiguous()):
            raise ValueError("3D PDHG kernel takes contiguous float32 "
                             "(Lp, Mp, N) fields on one device")
    if not lo <= n_valid <= hi or n_valid > N:
        raise ValueError(f"3D PDHG kernel takes {lo} <= N <= {hi}; got "
                         f"{n_valid}")
    if len(tile) != 3 or min(tile) < 1:
        raise ValueError(f"tile={tile}: the kernel takes (tl, tm, tn) >= 1")
    if (tuple(sched.shape) != (k_steps, 6) or sched.dtype != torch.float32
            or sched.device != x.device):
        raise ValueError("sched must be a (k_steps, 6) float32 tensor on the "
                         "canvas's device")
    sched = sched.contiguous()
    # One allocation for the five outputs: the kernel takes ~47 us on an
    # H100 at the main path's 32 x 256 x 256 canvas, and each allocation
    # costs the host a few.
    outs = torch.empty((5, Lp, Mp, N), dtype=x.dtype,
                       device=x.device).unbind(0)
    lib = build.lib()
    err = lib.pdhg3d_chunk(
        build.ptr(sched), *(build.ptr(f) for f in (x, xb, u1, u2, u3, y)),
        *(build.ptr(o) for o in outs), Lp, Mp, N, int(k_steps), *tile,
        int(n_valid), int(m_valid), int(l_valid), int(stride), int(count),
        int(pad_top), int(pad_m), int(grad_step), build.stream_ptr(x.device))
    build.check(err, "pdhg3d_chunk")
    LAUNCHES.value += 1
    return outs
