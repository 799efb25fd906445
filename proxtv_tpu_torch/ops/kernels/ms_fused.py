"""Kernel B4: the whole More-Sorensen TV-L2 prox per fiber.

Solves, for each row y of a (B, n) batch,

    min_x 0.5 ||x - y||^2 + lam ||D x||_2

on the dual ball ``||w|| <= lam``: a bootstrap Newton step of the secular
equation ``phi(alpha) = 1/lam - 1/||w(alpha)|| = 0`` (two shifted solves
``(DD' + alpha I) w = dy`` and ``(DD' + alpha I) q = w``), then the
safeguarded secant iteration (one shifted solve per step) until
``| ||w|| - lam | <= stop_boundary * lam``, the interior case (x = mean) and
zero-penalty rows (x = y), and the duality-gap certificate.

Replaces the TPU kernel ``proxtv_tpu/ops/kernels/ms_fused.py:ms_tv2_fused``;
the CUDA source is ``proxtv_tpu_torch/csrc/ms_fused.cu``.  Device traffic is
one read of (y [, lam_rows, alpha_init]) and one write of (x, alpha, gap,
iters).

:func:`ms_tv2_fused` launches the kernel for a CUDA tensor and runs
:func:`ms_tv2_fused_plain` for a CPU tensor; :func:`bind` makes its C call
once, for tools that time the kernel alone.  The kernel runs a fiber on one
warp for n <= 256 (four fibers a block) and on a block of up to 16 warps
above, each lane holding a contiguous chunk of E = 4, 8 or 16 elements in
registers.  It solves each shifted system exactly in O(n): every lane
eliminates its chunk serially, the lanes' interface rows are solved by PCR
over warp shuffles, and the warps' boundary rows (two a warp) by one more
PCR after one barrier; every pivot is a sum of nonnegative terms (the row
excess carried through the elimination), so the float32 solve stays
accurate as alpha -> 0.

The plain version repeats the TPU kernel's arithmetic on tensors (the
shifted solves by normalized parallel cyclic reduction) and takes its
``tb``: the TPU kernel's loop runs while any row of its tile runs and the
tile's largest iteration count is under the cap.  Updates are masked per
row, so the result is the per-fiber one for every ``tb``; ``tb = 1`` is the
CUDA kernel's loop, and the TPU's ``tb`` reproduces its tiles.  The two
solvers round differently: the card test and ``chip_smoke.py`` hold the
kernel to x within 1e-4, alpha within 1e-4 relative and iteration counts at
most one apart.
"""
from __future__ import annotations

import math

import torch

from ...utils.debug import Counter
from . import build
from .common import pad_rows
from .common import shift_left as _shift_left
from .common import shift_right as _shift_right
from .gating import lane_limits

LAUNCHES = Counter()
_EPS = 1e-10


def _rowsum(x):
    return torch.sum(x, dim=-1, keepdim=True)


def _tile_max(a, tb):
    """(Bp, 1) per-row values -> per-tile max, broadcast back to (Bp, 1)."""
    t = a.reshape(-1, tb).amax(dim=1, keepdim=True)
    return t.expand(-1, tb).reshape(-1, 1)


def _pcr_shifted(rhs, alpha, v, n):
    """Solve ``(DD' + alpha I) w = rhs`` on the v-masked rows (identity rows
    elsewhere) by normalized parallel cyclic reduction
    (``ms_fused.py:45-76``).  ``alpha`` is a (B, 1) nonnegative shift.  Steps
    at a stride of at least n are exact no-ops, so the width is the true n,
    not the TPU's lane-padded width."""
    b = -(v * _shift_right(v, 1, 0.0))
    c = _shift_left(b, 1, 0.0)
    r = 1.0 / (1.0 + v * (1.0 + alpha))
    b = b * r
    c = c * r
    d = (v * rhs) * r
    steps = max(1, math.ceil(math.log2(n)))
    for k in range(steps):
        stride = 1 << k
        if stride >= n:
            break
        bm = _shift_right(b, stride, 0.0)
        bp = _shift_left(b, stride, 0.0)
        cm = _shift_right(c, stride, 0.0)
        cp = _shift_left(c, stride, 0.0)
        dm = _shift_right(d, stride, 0.0)
        dp = _shift_left(d, stride, 0.0)
        r = 1.0 / (1.0 - b * cm - c * bp)
        d = (d - b * dm - c * dp) * r
        if stride * 2 < n:  # b, c dead after the final step
            b = (-b * bm) * r
            c = (-c * cp) * r
    return d


def ms_tv2_fused_plain(y, lam=None, lam_rows=None, alpha_init=None,
                       max_iters: int = 100, stop_boundary: float = 1e-5,
                       tb: int = 1):
    """The TPU kernel's arithmetic (``ms_fused.py:79-179``) on tensors, with
    its loop condition taken per tile of ``tb`` rows.

    Returns (x, alpha, gap, iters) as :func:`ms_tv2_fused`."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    yp = pad_rows(y, tb)
    Bp = yp.shape[0]
    v = (torch.arange(n, device=dev) < n - 1).to(dtype).expand(Bp, n)
    ybar = _rowsum(yp) / float(n)
    yc = yp - ybar
    if lam_rows is None:
        lam = torch.as_tensor(lam, dtype=dtype, device=dev).reshape(1, 1)
        lam = lam.expand(Bp, 1)
    else:
        lam = pad_rows(lam_rows.to(dtype).reshape(-1, 1), tb)
    dy = (_shift_left(yc, 1, 0.0) - yc) * v

    zero_pen = lam <= 0
    safe_lam = torch.where(lam > 0, lam, torch.ones_like(lam))
    tolb = stop_boundary * safe_lam

    # Bootstrap: one Cholesky-form Newton step of the secular equation
    # (reference more_TV2, src/TVL2opt.cpp:106-128); phi is convex
    # decreasing, so the secant steps after it converge from below.
    if alpha_init is not None:
        a_start = torch.clamp(
            pad_rows(alpha_init.to(dtype).reshape(-1, 1), tb), min=0.0)
    else:
        a_start = torch.zeros_like(lam)
    w_s = _pcr_shifted(dy, a_start, v, n)
    q_s = _pcr_shifted(w_s, a_start, v, n)
    nrm2_s = _rowsum(w_s * w_s)
    nrm_s = torch.sqrt(nrm2_s)
    wq_s = _rowsum(w_s * q_s)
    delta0 = ((nrm2_s / torch.clamp(wq_s, min=_EPS))
              * (nrm_s - safe_lam) / safe_lam)
    alpha = torch.clamp(a_start + delta0, min=0.0)
    phiprev = 1.0 / safe_lam - 1.0 / torch.clamp(nrm_s, min=_EPS)
    aprev = a_start
    # Interior case: ||w(0)|| <= lam, x is exactly the mean.
    interior = (a_start <= 0) & (nrm_s <= safe_lam)
    conv0 = (torch.abs(nrm_s - safe_lam) <= tolb) | interior
    running = ~conv0 & ~zero_pen
    w = w_s
    itv = torch.zeros((Bp, 1), dtype=torch.int32, device=dev)
    while True:
        go = (_tile_max(running, tb)
              & (_tile_max(itv, tb) < max_iters))
        if not bool(go.any()):
            break
        act = running & go
        w_new = _pcr_shifted(dy, alpha, v, n)
        nrm = torch.sqrt(_rowsum(w_new * w_new))
        phi = 1.0 / safe_lam - 1.0 / torch.clamp(nrm, min=_EPS)
        denom = phi - phiprev
        secant = alpha - phi * (alpha - aprev) / denom
        alpha_new = torch.clamp(
            torch.where(torch.abs(denom) > _EPS, secant, alpha), min=0.0)
        inter = (alpha <= 0) & (nrm <= safe_lam)
        conv = (torch.abs(nrm - safe_lam) <= tolb) | inter
        w = torch.where(act, w_new, w)
        interior = torch.where(act, inter, interior)
        aprev = torch.where(act, alpha, aprev)
        phiprev = torch.where(act, phi, phiprev)
        alpha = torch.where(act & ~conv, alpha_new, alpha)
        itv = itv + act.to(torch.int32)
        running = running & ~(act & conv)

    x = yc + (w - _shift_right(w, 1, 0.0))
    x = torch.where(interior, torch.zeros_like(x), x)
    x = torch.where(zero_pen, yc, x)
    g = (x - _shift_left(x, 1, 0.0)) * v
    gap = torch.abs(lam * torch.sqrt(_rowsum(g * g)) + _rowsum(w * g))
    gap = torch.where(interior | zero_pen, torch.zeros_like(gap), gap)
    return ((x + ybar)[:B], alpha[:B, 0], gap[:B, 0], itv[:B, 0])


def bind(y, lam=None, lam_rows=None, alpha_init=None, max_iters: int = 100,
         stop_boundary: float = 1e-5):
    """The C entry point's call for a CUDA batch, its arguments made once.

    Checks the arguments as :func:`ms_tv2_fused` does and allocates the
    outputs.  Returns ``((x, alpha, gap, iters), launch)``: each
    ``launch()`` runs the kernel into those outputs and raises on a refused
    launch.  ``launch`` does not count in :data:`LAUNCHES`; timing tools call
    it to time the kernel without the wrapper's host work."""
    if (lam is None) == (lam_rows is None):
        raise ValueError("pass exactly one of lam and lam_rows")
    B, n = y.shape
    lo, hi = lane_limits("ms")
    if y.dtype != torch.float32 or not lo <= n <= hi:
        raise ValueError(f"MS kernel takes float32 with {lo} <= n <= {hi}; "
                         f"got {y.dtype}, n = {n}")

    def rows(a, name):
        if a is None:
            return None
        a = torch.as_tensor(a, dtype=torch.float32,
                            device=y.device).reshape(-1)
        if a.shape[0] != B:
            raise ValueError(f"{name} must be (B,)")
        return a.contiguous()

    y = y.contiguous()
    lam_t = rows(lam_rows, "lam_rows")
    a0 = rows(alpha_init, "alpha_init")
    outs = (torch.empty_like(y),
            torch.empty((B,), dtype=torch.float32, device=y.device),
            torch.empty((B,), dtype=torch.float32, device=y.device),
            torch.empty((B,), dtype=torch.int32, device=y.device))
    args = (build.ptr(y), build.ptr(lam_t),
            float(lam) if lam_rows is None else 0.0, build.ptr(a0),
            *(build.ptr(o) for o in outs), B, n, int(max_iters),
            float(stop_boundary), build.stream_ptr(y.device))

    # keep: every tensor the pointers name, outputs too: a caller may drop
    # the outputs and launch again.
    def launch(keep=(y, lam_t, a0, *outs)):
        build.check(build.lib().ms_tv2_fused(*args), "ms_tv2_fused")

    return outs, launch


def ms_tv2_fused(y, lam=None, lam_rows=None, alpha_init=None,
                 max_iters: int = 100, stop_boundary: float = 1e-5):
    """Fused batched TV-L2 More-Sorensen prox.

    Args:
        y: (B, n) signals.  CUDA tensors must be float32 with 2 <= n <= 8192.
        lam: a scalar penalty, or
        lam_rows: (B,) per-row penalties.
        alpha_init: optional (B,) secular-multiplier warm start.

    Returns:
        (x, alpha, gap, iters): solution, final multiplier (for warm
        restarts), duality-gap certificate and (B,) int32 iteration counts.
    """
    if (lam is None) == (lam_rows is None):
        raise ValueError("pass exactly one of lam and lam_rows")
    if not y.is_cuda:
        return ms_tv2_fused_plain(y, lam, lam_rows, alpha_init, max_iters,
                                  stop_boundary, tb=1)
    outs, launch = bind(y, lam, lam_rows, alpha_init, max_iters,
                        stop_boundary)
    if y.shape[0] > 0:
        launch()
        LAUNCHES.value += 1
    return outs
