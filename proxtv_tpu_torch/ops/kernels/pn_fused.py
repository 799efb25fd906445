"""Kernel B1: the whole weighted TV-L1 projected-Newton prox per fiber.

Replaces the TPU kernel ``proxtv_tpu/ops/kernels/pn_fused.py:pn_tv1_fused``;
the CUDA source is ``proxtv_tpu_torch/csrc/pn_fused.cu``.  One launch is the
entire solve: centering, the closed-form double-prefix-sum dual init (or a
warm start), the inactive-set Newton loop with normalized masked PCR (a
4-step head plus a full-depth tail in exact mode), the halving projected line
search with the cancellation-free improvement, the relative duality-gap stop
and the degenerate guards.  Device traffic is one read of (y, lam, w_init)
and one write of (x, w).

:func:`pn_tv1_fused` launches the kernel for a CUDA tensor (one warp per
fiber for n <= 256, one block per fiber above; either way every decision is
per fiber, see the design note in ``csrc/pn_fused.cu``) and runs
:func:`pn_tv1_fused_plain` for a CPU tensor.  The plain version repeats the
TPU kernel's arithmetic on tensors and takes its ``tb``: the TPU kernel makes
the PCR-tail, line-search and deep-search decisions once per tile of ``tb``
fibers; the plain version makes them per tile too, so ``tb=1`` is the CUDA
kernel's per-fiber semantics and the TPU's ``tb`` is the TPU kernel's.
:func:`bind` makes the C call once, for tools that time the kernel alone.
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


def _tile_any(flag, tb):
    """(Bp, 1) 0/1 flag -> per-tile max, broadcast back to (Bp, 1)."""
    t = flag.reshape(-1, tb).amax(dim=1, keepdim=True)
    return t.expand(-1, tb).reshape(-1, 1)


def _tile_all(flag, tb):
    t = flag.reshape(-1, tb).amin(dim=1, keepdim=True)
    return t.expand(-1, tb).reshape(-1, 1)


def _pcr_step(stride, b, c, d):
    bm = _shift_right(b, stride, 0.0)
    bp = _shift_left(b, stride, 0.0)
    cm = _shift_right(c, stride, 0.0)
    cp = _shift_left(c, stride, 0.0)
    dm = _shift_right(d, stride, 0.0)
    dp = _shift_left(d, stride, 0.0)
    r = 1.0 / (1.0 - b * cm - c * bp)
    return (-b * bm) * r, (-c * cp) * r, (d - b * dm - c * dp) * r


def _pcr_masked(m, d, n, head_steps, tail_rows):
    """Normalized masked PCR (``pn_fused.py:40-101``): identity on masked-out
    rows; ``head_steps`` unconditional steps, then the full-depth tail for
    the rows flagged in ``tail_rows`` ((Bp, 1) bool).  Steps at a stride of
    at least n are exact no-ops (every coupling is an exact zero), so the
    width here is the true n, not the TPU's lane-padded width."""
    b = -(m * _shift_right(m, 1, 0.0))
    c = _shift_left(b, 1, 0.0)
    r = 1.0 / (1.0 + m)
    b = b * r
    c = c * r
    d = (m * d) * r
    steps = max(1, math.ceil(math.log2(n)))
    head = min(head_steps, steps)
    for k in range(head):
        stride = 1 << k
        if stride >= n:
            return d
        b, c, d = _pcr_step(stride, b, c, d)
    if (1 << head) < n and bool(tail_rows.any()):
        bt, ct, dt = b, c, d
        for k in range(head, steps):
            stride = 1 << k
            if stride >= n:
                break
            bt, ct, dt = _pcr_step(stride, bt, ct, dt)
        d = torch.where(tail_rows, dt, d)
    return d


def _prefix_sum(x, n):
    """Inclusive prefix sum along lanes (log-shift form)."""
    k = 1
    while k < n:
        x = x + _shift_right(x, k, 0.0)
        k <<= 1
    return x


def _poisson_solve(v, b, n):
    """Closed-form solve of the unconstrained dual system (DD') w = b
    (``pn_fused.py:119-134``): w_j = S_m (j+1)/n - S_{j-1} with
    S = prefix(prefix(b))."""
    T = _prefix_sum(b, n) * v
    S = _prefix_sum(T, n)
    Sm = _rowsum(T)
    idx = torch.arange(1, b.shape[-1] + 1, device=b.device).to(b.dtype)
    return (Sm * idx * (1.0 / float(n)) - _shift_right(S, 1, 0.0)) * v


def pn_tv1_fused_plain(y, lam_full=None, w_init=None, max_iters: int = 100,
                       max_armijo: int = 12, sigma: float = 0.05,
                       stop_rel: float = 1e-6, tb: int = 1,
                       head_steps: int = 4, lam_scalar=None,
                       return_dual: bool = True, tol_eps: float = 10.0):
    """The TPU kernel's arithmetic (``pn_fused.py:137-319``) on tensors, with
    its tile-wide decisions taken per tile of ``tb`` rows.  ``tol_eps`` as
    in :func:`pn_tv1_fused`.

    Returns (x, w, iters): w is None without ``return_dual``; iters is the
    (B,) int32 count of Newton iterations each fiber ran."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    feps = torch.finfo(dtype).eps
    yp = pad_rows(y, tb)
    Bp = yp.shape[0]
    v = (torch.arange(n, device=dev) < n - 1).to(dtype).expand(Bp, n)
    ybar = _rowsum(yp) / float(n)
    yc = yp - ybar
    if lam_scalar is not None:
        lam = torch.as_tensor(lam_scalar, dtype=dtype, device=dev) * v
    else:
        lam = pad_rows(lam_full.to(dtype), tb) * v
    dy = (_shift_left(yc, 1, 0.0) - yc) * v
    if w_init is not None:
        w = torch.clamp(pad_rows(w_init.to(dtype), tb) * v, -lam, lam)
    else:
        w = torch.clamp(_poisson_solve(v, dy, n), -lam, lam)

    def primal(w):
        return yc + (w - _shift_right(w, 1, 0.0))

    def grad(x):
        return (x - _shift_left(x, 1, 0.0)) * v

    x = primal(w)
    g = grad(x)
    fval = _rowsum(x * x) * 0.5
    scale = torch.clamp(_rowsum(yc * yc) * 0.5, min=1.0)
    tol = torch.clamp((tol_eps * feps) * scale, min=stop_rel)
    eps_f = torch.clamp((10.0 * feps) * scale, min=_EPS)
    eps_gap = torch.clamp((50.0 * feps) * scale, min=_EPS)

    def gap_of(w, g):
        return torch.abs(_rowsum(torch.abs(g) * lam + w * g))

    gap = gap_of(w, g)
    gap_prev = torch.full_like(gap, -math.inf)
    running = (gap > tol).to(dtype)
    mode = torch.zeros_like(gap)
    exact_any = torch.zeros_like(gap, dtype=torch.bool)
    iters = torch.zeros((Bp,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters and bool((running > 0).any()):
        mI = ((lam > 0)
              & (((w > -lam) & (w < lam))
                 | ((w == -lam) & (g < -_EPS))
                 | ((w == lam) & (g > _EPS))))
        m = mI.to(dtype) * v
        any_inact = (_rowsum(m) > 0).to(dtype)
        d = _pcr_masked(m, g * m, n, head_steps, exact_any) * m
        gRd = _rowsum(g * d * m)

        def trial(delta):
            aux = torch.where(m > 0, torch.clamp(w - delta * d, -lam, lam), w)
            dw = aux - w
            dx = dw - _shift_right(dw, 1, 0.0)
            xn = x + dx
            improve = -_rowsum(x * dx + 0.5 * dx * dx)
            return aux, xn, fval - improve, improve

        aux1, x1, f1, imp1 = trial(1.0)
        ok1 = ((imp1 >= sigma * gRd) | (imp1 <= eps_f)).to(dtype)
        best_w = torch.where(ok1 > 0, aux1, w)
        best_x = torch.where(ok1 > 0, x1, x)
        best_f = torch.where(ok1 > 0, f1, fval)
        found = ok1

        def ls_trials(best_w, best_x, best_f, found, delta, ntrials, sel):
            for _ in range(ntrials):
                aux, xn, fn, improve = trial(delta)
                ok = ((improve >= (sigma * delta) * gRd)
                      | (improve <= eps_f)).to(dtype)
                newly = (ok * (1.0 - found) > 0) & sel
                best_w = torch.where(newly, aux, best_w)
                best_x = torch.where(newly, xn, best_x)
                best_f = torch.where(newly, fn, best_f)
                found = torch.where(sel, torch.maximum(found, ok), found)
                delta *= 0.5
            return best_w, best_x, best_f, found

        need_ls = _tile_all(ok1, tb) < 1.0
        if bool(need_ls.any()):
            best_w, best_x, best_f, found = ls_trials(
                best_w, best_x, best_f, found, 0.5, 3, need_ls)
            deep = need_ls & (_tile_all(found, tb) < 1.0)
            if bool(deep.any()):
                best_w, best_x, best_f, found = ls_trials(
                    best_w, best_x, best_f, found, 0.5 ** 4, max_armijo - 4,
                    deep)

        g_new = grad(best_x)
        gap_new = gap_of(best_w, g_new)
        act = running * any_inact
        iters += (running[:, 0] > 0).to(torch.int32)
        w = torch.where(act > 0, best_w, w)
        x = torch.where(act > 0, best_x, x)
        g = torch.where(act > 0, g_new, g)
        fval = torch.where(act > 0, best_f, fval)
        gap_prev = torch.where(act > 0, gap, gap_prev)
        gap = torch.where(act > 0, gap_new, gap)
        it += 1
        # Stalled lanes promote their tile to exact-direction mode; a lane
        # that stalls while already exact stops (RC_STUCK).
        stuck = ((gap > tol)
                 & (torch.abs(gap - gap_prev) <= eps_gap)).to(dtype)
        running = (running * any_inact * (gap > tol).to(dtype)
                   * (1.0 - stuck * mode))
        mode = torch.maximum(mode, stuck * running)
        # A tile whose lanes all stopped stays frozen (act = 0), so one loop
        # over every tile equals the TPU kernel's loop per tile.
        exact_any = _tile_any(mode, tb) > 0

    # Degenerate guards: zero penalty -> identity; enormous penalty -> mean.
    inf = torch.tensor(math.inf, dtype=dtype, device=dev)
    lam_min = torch.amin(torch.where(v > 0, lam, inf), dim=-1, keepdim=True)
    dy_max = torch.amax(torch.abs(dy), dim=-1, keepdim=True)
    allz = _rowsum(lam) <= 0
    huge = lam_min >= (float(n) * float(n)) * dy_max
    x = torch.where(huge, torch.zeros_like(x), x)
    x = torch.where(allz, yc, x)
    x = (x + ybar)[:B]
    w = (w * v)[:B] if return_dual else None
    return x, w, iters[:B]


def pn_tv1_fused(y, lam_full=None, w_init=None, max_iters: int = 100,
                 max_armijo: int = 12, sigma: float = 0.05,
                 stop_rel: float = 1e-6, head_steps: int = 4,
                 lam_scalar=None, return_dual: bool = True,
                 return_iters: bool = False, tol_eps: float = 10.0):
    """Fused batched TV-L1 projected-Newton prox.

    Args:
        y: (B, n) signals.  CUDA tensors must be float32 with 2 <= n <= 8192.
        lam_full: (B, n) per-edge weights padded with a zero final column
            (column j weights edge (j, j+1); column n-1 is ignored).
        w_init: optional (B, n) dual warm start (same padding).
        lam_scalar: a Python float for a uniform penalty, instead of
            ``lam_full`` (no (B, n) penalty field is read).
        return_dual: with False the dual is not written.
        return_iters: also return the (B,) int32 Newton iteration counts.
        tol_eps: the gap stop is ``max(stop_rel, tol_eps * eps * 0.5 ||y -
            mean(y)||^2)`` per fiber, eps the dtype's; 10 is the TPU
            kernel's floor.  The long-signal windows pass 0: a stop that
            the gap reaches or the stall test ends (at 10 float32 windows
            of a walk stop early: ``ops/tv1d_long._solve_windows``).

    Returns:
        (x, w) or (x, w, iters); ``w`` is None without ``return_dual``.
    """
    if (lam_full is None) == (lam_scalar is None):
        raise ValueError("pass exactly one of lam_full and lam_scalar")
    if not y.is_cuda:
        x, w, iters = pn_tv1_fused_plain(
            y, lam_full, w_init, max_iters, max_armijo, sigma, stop_rel,
            tb=1, head_steps=head_steps, lam_scalar=lam_scalar,
            return_dual=return_dual, tol_eps=tol_eps)
        return (x, w, iters) if return_iters else (x, w)
    out, launch = bind(y, lam_full, w_init, max_iters, max_armijo, sigma,
                       stop_rel, head_steps, lam_scalar, return_dual,
                       return_iters, tol_eps)
    if y.shape[0] > 0:
        launch()
        LAUNCHES.value += 1
    return out


def bind(y, lam_full=None, w_init=None, max_iters: int = 100,
         max_armijo: int = 12, sigma: float = 0.05, stop_rel: float = 1e-6,
         head_steps: int = 4, lam_scalar=None, return_dual: bool = True,
         return_iters: bool = False, tol_eps: float = 10.0):
    """The C entry point's call for a CUDA batch, its arguments made once,
    for tools that time the kernel alone.  Takes what
    :func:`pn_tv1_fused` takes, checks it as that does and allocates the
    outputs.  Returns ``(out, launch)``: ``out`` is what
    :func:`pn_tv1_fused` returns, and each ``launch()`` runs the kernel
    into it and raises on a refused launch.  ``launch`` does not count in
    :data:`LAUNCHES`."""
    if (lam_full is None) == (lam_scalar is None):
        raise ValueError("pass exactly one of lam_full and lam_scalar")
    if not y.is_cuda:
        raise ValueError("bind takes a CUDA batch: the kernel has no CPU "
                         "mode")
    B, n = y.shape
    lo, hi = lane_limits("pn")
    if y.dtype != torch.float32 or not lo <= n <= hi:
        raise ValueError(f"PN kernel takes float32 with {lo} <= n <= {hi}; "
                         f"got {y.dtype}, n = {n}")
    if max_armijo < 4:
        raise ValueError("max_armijo must be at least 4")

    def field(a, name):
        if a is None:
            return None
        if a.shape != y.shape or a.device != y.device:
            raise ValueError(f"{name} must match y in shape and device")
        return a.to(torch.float32).contiguous()

    y = y.contiguous()
    lam_t = field(lam_full, "lam_full")
    w0 = field(w_init, "w_init")
    x = torch.empty_like(y)
    w = torch.empty_like(y) if return_dual else None
    iters = (torch.empty((B,), dtype=torch.int32, device=y.device)
             if return_iters else None)
    args = (build.ptr(y), build.ptr(lam_t),
            float(lam_scalar) if lam_scalar is not None else 0.0,
            build.ptr(w0), build.ptr(x), build.ptr(w), build.ptr(iters),
            B, n, int(max_iters), int(max_armijo), float(sigma),
            float(stop_rel), float(tol_eps), int(head_steps),
            build.stream_ptr(y.device))

    # keep: every tensor the pointers name, the outputs too.
    def launch(keep=(y, lam_t, w0, x, w, iters)):
        build.check(build.lib().pn_tv1_fused(*args), "pn_tv1_fused")

    return ((x, w, iters) if return_iters else (x, w)), launch
