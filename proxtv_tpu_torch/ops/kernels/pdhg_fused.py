"""Kernel B3: one K-iteration chunk of 2D anisotropic TV-L1 PDHG.

The primal-dual (Chambolle-Pock / Condat) iteration for

    min_X 0.5||X - Y||^2 + lam ||D_row X||_1 + lam ||D_col X||_1

is a radius-1 stencil:

    u1 <- clip(u1 + sigma * D_row(xbar), +-lam)
    u2 <- clip(u2 + sigma * D_col(xbar), +-lam)
    x' <- (x - tau * (D_row' u1 + D_col' u2) + tau * Y) / (1 + tau)
    xbar <- x' + theta (x' - x)

Replaces the TPU kernel ``proxtv_tpu/ops/kernels/pdhg_fused.py:pdhg_chunk``;
the CUDA source is ``proxtv_tpu_torch/csrc/pdhg_fused.cu``.  All state lives
on a row-padded (Mp, Np) canvas holding ``count`` images stacked with period
``stride``; gap and pad rows (and the invalid last dual column) carry
lam = 0, which pins their duals to 0 and exactly decouples them.

:func:`pdhg_chunk` launches the kernel for CUDA tensors and runs
:func:`pdhg_chunk_plain` (the TPU kernel's arithmetic on the whole canvas)
for CPU tensors.  The schedule helpers :func:`sched_chunk` and
:func:`make_schedule` are host code in ``numpy.float32``, step for step with
the JAX package's float32 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.debug import Counter
from . import build
from .gating import lane_limits

LAUNCHES = Counter()
MAX_STEPS = 16  # largest k_steps of the CUDA kernel (csrc/pdhg_fused.cu)
# The CUDA kernel's window, (rows, columns) = (kWH, kW) of the source; its
# core is the window less window_halo(K) on every side.
WINDOW = (64, 128)


def _halo(k_steps):
    """The TPU kernel's halo, 2K rows: its bands, and so the plain version's
    certificate partials, start that far down the canvas."""
    return 2 * k_steps


def window_halo(k_steps):
    """Halo of the CUDA kernel's windows, K + 1 cells on every side: K keeps
    the four fields exact on the core after K steps, and the certificate
    reads xhat one cell further (tests/test_torch_pdhg.py proves both)."""
    return k_steps + 1


# Same-size difference stencils on the canvas (kernel convention).
def _drow(X):
    return X - torch.cat([X[..., 1:], torch.zeros_like(X[..., :1])], dim=-1)


def _drow_t(U):
    return U - torch.cat([torch.zeros_like(U[..., :1]), U[..., :-1]], dim=-1)


def _dcol(X):
    return X - torch.cat([X[1:, :], torch.zeros_like(X[:1, :])], dim=0)


def _dcol_t(U):
    return U - torch.cat([torch.zeros_like(U[:1, :]), U[:-1, :]], dim=0)


def _f32(v):
    return np.float32(v)


def sched_chunk(carry, k_steps, lam, sigma0, cap_mult, variant):
    """Next ``k_steps`` rows of the (sigma, tau, theta, lam) schedule from a
    carried (sigma, tau) pair (``pdhg_fused.py:248-272``), in float32 on the
    host.  Returns ((k_steps, 4) float32 array, new carry)."""
    sig, tau = _f32(carry[0]), _f32(carry[1])
    lam, sigma0, cap_mult = _f32(lam), _f32(sigma0), _f32(cap_mult)
    acc = variant == "cp-acc"
    one, two = _f32(1.0), _f32(2.0)
    rows = np.empty((k_steps, 4), np.float32)
    for k in range(k_steps):
        if acc:
            theta = (one / np.sqrt(one + two * tau)
                     if sig < cap_mult * sigma0 else one)
        else:
            theta = one
        rows[k] = (sig, tau, theta, lam)
        if acc:
            sig, tau = _f32(sig / theta), _f32(tau * theta)
    return rows, (sig, tau)


def make_schedule(max_iters, lam, sigma0, tau0, variant, cap_mult=2.0):
    """(max_iters, 4) [sigma, tau, theta, lam] float32 schedule
    (``pdhg_fused.py:275-301``): constant steps for cp / condat, capped
    Chambolle-Pock Alg.-2 updates for cp-acc."""
    rows, _ = sched_chunk((sigma0, tau0), max_iters, lam, sigma0, cap_mult,
                          variant)
    return rows


def _masks(Mp, Np, n_valid, m_valid, stride, count, pad_top, dtype, device):
    rowg = torch.arange(Mp, device=device)[:, None]
    col = torch.arange(Np, device=device)[None, :]
    r = rowg - pad_top
    q = r - torch.div(r, stride, rounding_mode="floor") * stride
    in_img = (r >= 0) & (r < count * stride)
    vr = (col < n_valid - 1) & in_img & (q <= m_valid - 1)
    vc = (q <= m_valid - 2) & in_img & (col < n_valid)
    return (in_img.expand(Mp, Np), vr, vc)


def pdhg_chunk_plain(sched, x, xb, u1, u2, y, k_steps: int, tm: int,
                     n_valid: int, m_valid: int, stride: int, count: int,
                     pad_top=0, grad_step: bool = False, wr=None, wc=None,
                     cert: bool = False):
    """The TPU kernel's arithmetic (``pdhg_fused.py:68-245``) on the whole
    canvas.  A band with a 2K halo computes its core rows exactly, so the
    whole-canvas result equals the banded one there; ``cert`` partials are
    summed per band of ``tm`` core rows, as the TPU kernel does."""
    Mp, Np = x.shape
    dt = x.dtype
    in_img, vr_b, vc_b = _masks(Mp, Np, n_valid, m_valid, stride, count,
                                int(pad_top), dt, x.device)
    zero = torch.zeros((), dtype=dt, device=x.device)
    # Sanitize once per chunk: padding rows may hold garbage (NaN).
    x = torch.where(in_img, x, zero)
    xb = torch.where(in_img, xb, zero)
    u1 = torch.where(vr_b, u1, zero)
    u2 = torch.where(vc_b, u2, zero)
    vr = vr_b.to(dt)
    vc = vc_b.to(dt)
    sched = sched.to(dt)
    if wr is not None:
        lamr = wr * vr
        lamc = wc * vc
    else:
        lamr = sched[0, 3] * vr
        lamc = sched[0, 3] * vc
    vrow = in_img.to(dt)
    for k in range(k_steps):
        sigma, tau, theta = sched[k, 0], sched[k, 1], sched[k, 2]
        u1 = torch.minimum(torch.maximum(u1 + sigma * _drow(xb), -lamr), lamr)
        u2 = torch.minimum(torch.maximum(u2 + sigma * _dcol(xb), -lamc), lamc)
        div = _drow_t(u1) + _dcol_t(u2)
        if grad_step:  # Condat: explicit gradient step on the smooth term
            xn = x - tau * ((x - y) + div)
        else:          # CP: resolvent step
            xn = (x - tau * div + tau * y) / (1.0 + tau)
        xb = xn + theta * (xn - x)
        x = xn
    if not cert:
        return x, xb, u1, u2
    xhat = y - (_drow_t(u1) + _dcol_t(u2))
    gr = _drow(xhat) * vr
    gc = _dcol(xhat) * vc
    e_gap = (lamr * torch.abs(gr) - u1 * gr + lamc * torch.abs(gc) - u2 * gc)
    e_obj = (0.5 * (xhat - y) * (xhat - y) * vrow
             + lamr * torch.abs(gr) + lamc * torch.abs(gc))
    h = _halo(k_steps)
    tiles = (Mp - 2 * h) // tm
    gap = e_gap[h:h + tiles * tm].reshape(tiles, tm * Np).sum(dim=1)
    obj = e_obj[h:h + tiles * tm].reshape(tiles, tm * Np).sum(dim=1)
    return x, xb, u1, u2, gap.reshape(tiles, 1), obj.reshape(tiles, 1)


def bind(sched, x, xb, u1, u2, y, k_steps: int, n_valid: int, m_valid: int,
         stride: int, count: int, pad_top=0, grad_step: bool = False,
         wr=None, wc=None, cert: bool = False):
    """The C entry point's call for CUDA fields, its arguments made once.

    Checks the arguments as :func:`pdhg_chunk` does and allocates the
    outputs.  Returns ``(outs, launch)``: ``outs`` are the four fields and,
    with ``cert``, the (pdhg_cert_blocks, 1) gap and objective partials;
    each ``launch()`` runs the kernel into them and raises on a refused
    launch.  ``launch`` does not count in :data:`LAUNCHES`; timing tools call
    it to time the kernel without the wrapper's host work."""
    Mp, Np = x.shape
    lo, hi = lane_limits("pdhg2d")
    fields = [x, xb, u1, u2, y] + ([wr, wc] if wr is not None else [])
    for f in fields:
        if (f.dtype != torch.float32 or f.shape != (Mp, Np)
                or f.device != x.device or not f.is_contiguous()):
            raise ValueError("PDHG kernel takes contiguous float32 (Mp, Np) "
                             "fields on one device")
    if not lo <= n_valid <= hi or n_valid > Np:
        raise ValueError(f"PDHG kernel takes {lo} <= N <= {hi}; got {n_valid}")
    if not 1 <= k_steps <= MAX_STEPS:
        raise ValueError(f"PDHG kernel takes 1 <= k_steps <= {MAX_STEPS}; "
                         f"got {k_steps}")
    if (sched.shape != (k_steps, 4) or sched.dtype != torch.float32
            or sched.device != x.device):
        raise ValueError("sched must be a (k_steps, 4) float32 tensor on the "
                         "canvas's device")
    sched = sched.contiguous()
    lib = build.lib()
    outs = [torch.empty_like(x) for _ in range(4)]
    if cert:
        nblk = lib.pdhg_cert_blocks(Mp, Np)
        outs += [torch.empty((nblk, 1), dtype=torch.float32, device=x.device)
                 for _ in range(2)]
    gap, obj = outs[4:] if cert else (None, None)
    args = (build.ptr(sched), *(build.ptr(f) for f in (x, xb, u1, u2, y)),
            build.ptr(wr), build.ptr(wc), *(build.ptr(o) for o in outs[:4]),
            build.ptr(gap), build.ptr(obj), Mp, Np, int(k_steps),
            int(n_valid), int(m_valid), int(stride), int(count),
            int(pad_top), int(grad_step), build.stream_ptr(x.device))

    # keep: every tensor the pointers name, outputs too: a caller may drop
    # the outputs and launch again.
    def launch(keep=(sched, *fields, *outs)):
        build.check(lib.pdhg_chunk(*args), "pdhg_chunk")

    return tuple(outs), launch


def pdhg_chunk(sched, x, xb, u1, u2, y, k_steps: int, tm: int,
               n_valid: int, m_valid: int, stride: int, count: int,
               pad_top=0, grad_step: bool = False, wr=None, wc=None,
               cert: bool = False):
    """Run one K-iteration chunk over the whole (Mp, Np) canvas.

    ``sched`` is the (k_steps, 4) schedule slice (a tensor on the canvas's
    device); ``wr``/``wc`` optional (Mp, Np) per-edge weight fields.
    ``cert=True`` appends two (tiles, 1) tensors of per-tile partial duality
    gap and objective of the post-chunk state (their sums are the canvas
    totals; ``tm`` sets the tiles only on the CPU, the CUDA kernel reports
    one partial per block, ``pdhg_cert_blocks`` of them).  Outputs never
    alias inputs.
    """
    if not x.is_cuda:
        return pdhg_chunk_plain(sched, x, xb, u1, u2, y, k_steps, tm,
                                n_valid, m_valid, stride, count, pad_top,
                                grad_step, wr, wc, cert)
    outs, launch = bind(sched, x, xb, u1, u2, y, k_steps, n_valid, m_valid,
                        stride, count, pad_top, grad_step, wr, wc, cert)
    launch()
    LAUNCHES.value += 1
    return outs
