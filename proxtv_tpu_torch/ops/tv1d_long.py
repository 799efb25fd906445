"""Single very long 1D TV-L1 signals: overlapped windows, dual glue and a
certificate (port of ``proxtv_tpu.ops.tv1d_long``).

The reference's long 1D case is one signal of n ~ 10^6 solved by a
sequential O(n) scan (``src/condat_fast_tv.cpp:78-131``).  The JAX package
cuts it into windows instead, and so does the port:

1.  **Overlapped window solve (parallel).**  The signal is cut into K
    windows of ``win = chunk + 2*overlap`` samples and all windows are
    solved at once: one launch of kernel B1 (:mod:`.kernels.pn_fused`) on a
    CUDA float32 batch, :func:`tv1d_l1.tv1_pn` on the CPU.  TV is a local
    operator, so each window's interior chunk is near-exact.  The windows
    are built by pads and reshapes (no gather); cells outside the signal are
    zeros, cut off exactly by zero edge weights, which also gives the
    boundary windows the free boundary condition.
2.  **Dual glue.**  Each edge is owned by the window whose interior holds
    it, so the global dual is a slice and a reshape of the window duals.
3.  **Certificate.**  The duality gap at the glued dual, against the
    tolerance projected Newton stops on.  Where it fails, an escalation runs
    (warm resumes of the windows, a half-chunk shifted grid stitched at
    pinned edges, a dozen projected-gradient steps, plateau snaps) and, if
    that still does not certify, a warm global :func:`tv1d_l1.tv1_pn`
    polish whose info is the certificate.

A batch of long signals may be passed as (S, n): all S*K windows run in one
launch.  Each ``jax.lax.cond`` of the JAX function is one host read here
(``debug.HOST_SYNCS``): one for the pass-1 certificate, one more inside the
escalation.  A CUDA float32 tensor launches B1 or raises (the fused-kernel
switch off), as every kernel call site of the port does; a float64 one
takes the JAX package's float64 route, its windows by
:func:`tv1d_l1.tv1_pn` (their Newton systems on kernel B2 in float64), as
does a window longer than B1's 8192 lanes, where kind ``"pn_window"``
composes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import debug, diffs
from ..utils.config import DEFAULT_TV1, TV1Config
from ..utils.info import RC_OK, make_info
from . import tv1d_l1
from .kernels.common import shift_left, shift_right


def _segment_mean_scan(x, seg_start):
    """Per-element mean of the segment each element belongs to, gather-free
    (``tv1d_long.py:56``): two segmented inclusive log-shift scans (forward
    from segment heads, reverse from segment tails) give the sum and count
    from head..i and i..tail; ``total = fwd + rev - x``.  The shift order is
    the JAX function's, so the sums, on which the plateau snap decides
    equality, round as they do there."""
    n = x.shape[1]
    ones = torch.ones_like(x)
    seg_end = torch.cat([seg_start[:, 1:],
                         torch.ones_like(seg_start[:, :1])], dim=1)

    def seg_scan(v, c, s, shift):
        k = 1
        while k < n:
            vs, cs, ss = shift(v, k, 0.0), shift(c, k, 0.0), shift(s, k, 0.0)
            keep = 1.0 - s
            v = v + keep * vs
            c = c + keep * cs
            s = torch.maximum(s, ss)
            k <<= 1
        return v, c

    fwd_v, fwd_c = seg_scan(x, ones, seg_start.to(x.dtype), shift_right)
    rev_v, rev_c = seg_scan(x, ones, seg_end.to(x.dtype), shift_left)
    tot = fwd_v + rev_v - x
    cnt = fwd_c + rev_c - 1.0
    return tot / cnt


def _segment_min_scan(v, seg_start):
    """Per-element minimum over the segment each element belongs to
    (``tv1d_long.py:100``): the same log-shift scans with min for sum;
    blocked shifts contribute the dtype's largest value."""
    n = v.shape[1]
    big = float(torch.finfo(v.dtype).max)
    seg_end = torch.cat([seg_start[:, 1:],
                         torch.ones_like(seg_start[:, :1])], dim=1)

    def seg_scan(v, s, shift):
        k = 1
        while k < n:
            vs, ss = shift(v, k, big), shift(s, k, big)
            v = torch.minimum(v, torch.where(s > 0, big, vs))
            s = torch.maximum(s, ss)
            k <<= 1
        return v

    fwd = seg_scan(v, seg_start.to(v.dtype), shift_right)
    rev = seg_scan(v, seg_end.to(v.dtype), shift_left)
    return torch.minimum(fwd, rev)


def _plateau_snap(x, Y, lam_b, return_delta: bool = False):
    """Replace ulp-flat runs of ``x`` by their exact segment mean where that
    strictly lowers the objective (``tv1d_long.py:130``).

    The primal is rebuilt as ``x_i = y_i + w_i - w_{i-1}``, so a plateau of
    the solution comes back with ~1-ulp ripple whose TV term costs an
    O(1e-4) relative objective excess at n ~ 10^6.  The objective change of
    the snap is computed per signal without cancellation (fidelity through
    the deviations, TV through its nonnegative sums) and the snap is kept
    only where it is negative.  With ``return_delta`` the per-signal change
    (<= 0, 0 where rejected) is returned too: it moves a certified gap from
    ``x`` to the snapped point."""
    B = x.shape[0]
    eps = torch.finfo(x.dtype).eps
    scale_x = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                          min=1e-30)
    d = diffs.forward_diff(x)
    # 256 eps: wide enough for the few-ulp wiggles of the PGD refinement
    # and the resumed window solves (the JAX package's measured choice).
    flat = torch.abs(d) <= 256.0 * eps * scale_x
    seg_start = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                      device=x.device), ~flat], dim=1)
    m = _segment_mean_scan(x, seg_start)
    # fid: sum e (x - y) + 0.5 sum e^2 with e = m - x; tv: sum lam (|Dm| -
    # |Dx|).
    e = m - x
    d_fid = torch.sum(e * (x - Y), dim=-1) + 0.5 * torch.sum(e * e, dim=-1)
    dm = diffs.forward_diff(m)
    d_tv = torch.sum(lam_b * (torch.abs(dm) - torch.abs(d)), dim=-1)
    dobj = d_fid + d_tv
    keep = dobj < 0.0
    xs = torch.where(keep[:, None], m, x)
    if return_delta:
        return xs, torch.where(keep, dobj, torch.zeros_like(dobj))
    return xs


def _windows(a, K: int, chunk: int, overlap: int):
    """(..., K, chunk + 2*overlap) overlapped windows of the last axis of
    ``a``, zero outside [0, a.shape[-1]), from pads and reshapes only
    (``tv1d_long.py:180``): window k covers global positions
    [k*chunk - overlap, (k+1)*chunk + overlap)."""
    total = K * chunk
    lead = a.shape[:-1]
    ap = F.pad(a, (0, max(0, total + chunk - a.shape[-1])))
    body = ap[..., :total].reshape(*lead, K, chunk)
    left = F.pad(ap, (overlap, 0))[..., :total].reshape(
        *lead, K, chunk)[..., :overlap]
    suffix = ap[..., chunk:total + chunk].reshape(*lead, K, chunk)[
        ..., :overlap]
    return torch.cat([left, body, suffix], dim=-1)


def _solve_windows(Yw, lam_w, w_init=None):
    """Exact TV-L1 solve of all (K, win) windows, returning (x, dual)
    (``tv1d_long.py:207``): one B1 launch on a CUDA float32 batch (the dual
    (K, win) wide, its last column zero), :func:`tv1d_l1.tv1_pn` on the
    CPU, for a float64 batch and past B1's lanes (the dual (K, win - 1)
    wide).  ``w_init`` is a
    previous call's dual, passed back to resume a solve (each resume
    re-arms the stall detector and the line-search budget).

    B1 runs with ``tol_eps=0``: its gap stop without the TPU kernel's
    floor of 10 eps 0.5||y - mean||^2 a window, so a window runs until its
    gap reaches ``stop_rel`` or stalls.  With the floor, float32 windows of
    a walk stop early and the glued solution lands 2.8e-2 from float64 on
    the bench's 10^6 walk (4.5e-2 on ROADMAP C2's walk), though the glue
    certifies; without it, about two Newton iterations more a window (6.2
    -> 8.1 on average; 7.3 -> 8.8) land it 7.5e-6 (7.4e-6) away, as
    ``tv1_pn`` windows do (``tools/window_stop.py``: B1's plain version in
    float32 on the CPU)."""
    from .kernels import gating

    K, win = Yw.shape
    if gating.gate(Yw, "pn_window"):
        from .kernels import pn_fused

        lam_full = torch.cat([lam_w, Yw.new_zeros((K, 1))], dim=-1)
        if w_init is not None and w_init.shape[-1] == win - 1:
            w_init = F.pad(w_init, (0, 1))
        return pn_fused.pn_tv1_fused(Yw, lam_full, w_init=w_init,
                                     tol_eps=0.0)
    if w_init is not None and w_init.shape[-1] == win:
        w_init = w_init[:, : win - 1]
    x, _, w = tv1d_l1.tv1_pn(Yw, lam_w, w_init=w_init, return_dual=True)
    return x, w


def _window_weights(lam, per_edge, S, K, chunk, overlap, win, lo, hi,
                    dtype, device):
    """(S*K, win - 1) window edge weights; window edges whose global index
    (less a left padding of ``lo``) lies outside [lo, hi) are zero."""
    eg = ((torch.arange(K, device=device) * chunk)[:, None]
          + torch.arange(win - 1, device=device)[None, :] - overlap)
    valid = (eg >= lo) & (eg < hi)
    if per_edge:
        lw = _windows(lam, K, chunk, overlap)[..., : win - 1]
        return torch.where(valid[None], lw, 0.0).reshape(S * K, win - 1)
    lw = torch.where(valid, lam, torch.zeros((), dtype=dtype, device=device))
    return torch.broadcast_to(lw[None], (S, K, win - 1)).reshape(S * K,
                                                                 win - 1)


def _glue(Ww, S, K, chunk, overlap):
    """(S, K*chunk) glued dual: the interior chunk of each window."""
    return (Ww.reshape(S, K, Ww.shape[-1])[:, :, overlap: overlap + chunk]
            .reshape(S, -1))


def tv1_long(y, lam, chunk: int = 5120, overlap: int = 640,
             cfg: TV1Config = DEFAULT_TV1):
    """TV-L1 prox of very long signals (``tv1d_long.py:232``).

    Args:
        y: (n,) signal, or (S, n) batch of long signals solved together (a
            tensor; the windows engage above one window length).
        lam: scalar penalty, or (n-1,) / (S, n-1) per-edge weights.
        chunk: interior samples owned by each window.
        overlap: margin solved but discarded on each side of a window.

    Returns:
        (x, info): the solution, shaped as ``y``, and the per-signal
        :class:`SolverInfo` certificate ((S,) fields: iterations of the
        polish, duality gap, rc).
    """
    single = y.ndim == 1
    Y = y[None] if single else y
    S, n = Y.shape
    dtype, dev = Y.dtype, Y.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    per_edge = lam.ndim >= 1
    # A shared (n-1,) weight vector is broadcast across the batch first.
    lam_b = (torch.broadcast_to(lam[None] if lam.ndim == 1 else lam,
                                (S, n - 1)) if per_edge else lam)

    if n <= chunk + 2 * overlap:
        x, info = tv1d_l1.tv1_pn(Y, lam_b, cfg=cfg)
        return (x[0] if single else x), info

    K = -(-n // chunk)
    win = chunk + 2 * overlap
    Yw = _windows(Y, K, chunk, overlap).reshape(S * K, win)
    lam_w = _window_weights(lam_b if per_edge else lam, per_edge, S, K, chunk,
                            overlap, win, 0, n - 1, dtype, dev)
    _, Ww = _solve_windows(Yw, lam_w)
    w_glued = _glue(Ww, S, K, chunk, overlap)[:, : n - 1]

    # The pass-1 certificate: the duality gap at the glued dual against
    # projected Newton's dtype-aware tolerance.
    yc = Y - torch.mean(Y, dim=-1, keepdim=True)
    scale = torch.clamp(0.5 * torch.sum(yc * yc, dim=-1), min=1.0)
    tol = torch.clamp(2.0 * torch.finfo(dtype).eps * scale, min=cfg.stop)

    def gap_at(x, w):
        return tv1d_l1._gap_tv1w(w, diffs.primal2grad(x), lam_b)

    x1 = diffs.dual2primal(w_glued, Y)
    gap1 = gap_at(x1, w_glued)
    zeros_i = torch.zeros((S,), dtype=torch.int32, device=dev)
    ok_rc = torch.full((S,), RC_OK, dtype=torch.int32, device=dev)
    if not debug.host(torch.any(gap1 > tol)):
        info = make_info(zeros_i, gap1, ok_rc)
        return (x1[0] if single else x1), info

    offset = chunk // 2
    lam_hi = lam_b if per_edge else lam

    def jitter_dual(w1):
        """The glued dual of a grid shifted by half a chunk, stitched with
        ``w1`` at pinned edges (``tv1d_long.py:327``).  The shift pads the
        signal on the left with ``offset`` zeros cut off by zero weights,
        so the shifted problem has the same solution."""
        n_pad = n + offset
        Kb = -(-n_pad // chunk)
        Yw2 = _windows(F.pad(Y, (offset, 0)), Kb, chunk, overlap).reshape(
            S * Kb, win)
        lam_src = F.pad(lam_b, (offset, 0)) if per_edge else lam
        lam_w2 = _window_weights(lam_src, per_edge, S, Kb, chunk, overlap,
                                 win, offset, n_pad - 1, dtype, dev)
        # Warm start from w1, windowed into the shifted grid and clipped
        # into its box (0 at the zero-weight edges).
        w_pad = F.pad(w1, (offset, 1))  # edge j of sample j
        Wi = _windows(w_pad, Kb, chunk, overlap).reshape(S * Kb, win)
        lam_box = torch.cat([lam_w2, Yw2.new_zeros((S * Kb, 1))], dim=-1)
        Wi = torch.clamp(Wi, -lam_box, lam_box)
        _, Ww2 = _solve_windows(Yw2, lam_w2, w_init=Wi)
        w2 = _glue(Ww2, S, Kb, chunk, overlap)[:, offset: n_pad - 1]
        # Stitch at pinned edges: where both grids agree at a bound the
        # dual problem decouples, so each region between such edges is
        # taken whole from the grid whose cuts lie farther from it.
        eps = torch.finfo(dtype).eps
        lam_e = lam_b if per_edge else torch.broadcast_to(lam, (1, n - 1))
        wmag = torch.clamp(torch.amax(torch.abs(w1), dim=-1, keepdim=True),
                           min=1.0)
        tiny = 32.0 * eps * wmag
        pinned = ((torch.abs(w1 - w2) <= tiny)
                  & (lam_e - torch.abs(w1) <= tiny))
        seg_start = torch.cat([torch.ones((S, 1), dtype=torch.bool,
                                          device=dev), pinned[:, :-1]], dim=1)
        i = torch.arange(n - 1, device=dev)
        mA = (i + 1) % chunk
        dA = torch.minimum(mA, chunk - mA).to(dtype)
        mB = (i + 1 + offset) % chunk
        dB = torch.minimum(mB, chunk - mB).to(dtype)
        minA = _segment_min_scan(torch.broadcast_to(dA[None], (S, n - 1)),
                                 seg_start)
        minB = _segment_min_scan(torch.broadcast_to(dB[None], (S, n - 1)),
                                 seg_start)
        return torch.where(minA < minB, w2, w1)

    def tol_contract(xs):
        # The escalation's tolerance: gap <= 1e-5 P(x) (BASELINE.md's "equal
        # solution" bar), never below the strict pass-1 tolerance.
        P = (0.5 * torch.sum((xs - Y) ** 2, dim=-1)
             + torch.sum(lam_b * torch.abs(diffs.forward_diff(xs)), dim=-1))
        return torch.maximum(tol, 1e-5 * P)

    def dual_pgd(w, iters=12):
        # Projected gradient on the dual, tau = 1/L with L = ||DD'|| = 4:
        # erases the near-Nyquist spikes of single-edge splice mismatches.
        for _ in range(iters):
            g = diffs.primal2grad(diffs.dual2primal(w, Y))
            w = torch.clamp(w - 0.25 * g, -lam_hi, lam_hi)
        return w

    # Escalation: two warm resumes of the windows clear float32 plateau
    # stalls; then the seam jitter, the PGD refinement and the snaps.
    _, Wr = _solve_windows(Yw, lam_w, w_init=Ww)
    _, Wr = _solve_windows(Yw, lam_w, w_init=Wr)
    w1r = _glue(Wr, S, K, chunk, overlap)[:, : n - 1]
    x1r = diffs.dual2primal(w1r, Y)
    gap1r = gap_at(x1r, w1r)
    wj = dual_pgd(jitter_dual(w1r))
    xj = diffs.dual2primal(wj, Y)
    gapj = gap_at(xj, wj)
    better = gapj < gap1r
    wb = torch.where(better[:, None], wj, w1r)
    xb = torch.where(better[:, None], xj, x1r)
    gapb = torch.minimum(gapj, gap1r)
    # Cascaded snap: the first pass flattens few-ulp wiggles into exact
    # runs, which lets the second merge across them.
    xs, dobj = _plateau_snap(xb, Y, lam_b, return_delta=True)
    xs, dobj2 = _plateau_snap(xs, Y, lam_b, return_delta=True)
    gap_s = torch.clamp(gapb + (dobj + dobj2), min=0.0)
    if not debug.host(torch.any(gap_s > tol_contract(xs))):
        info = make_info(zeros_i, gap_s, ok_rc)
        return (xs[0] if single else xs), info

    # Last: the warm global polish, whose info is the certificate.
    x, pinfo = tv1d_l1.tv1_pn(Y, lam_b, cfg=cfg, w_init=wb)
    xp, dp1 = _plateau_snap(x, Y, lam_b, return_delta=True)
    xp, dp2 = _plateau_snap(xp, Y, lam_b, return_delta=True)
    gap_p = torch.clamp(pinfo.gap + (dp1 + dp2), min=0.0)
    rc_p = torch.where(gap_p <= tol_contract(xp),
                       torch.full_like(pinfo.rc, RC_OK), pinfo.rc)
    info = make_info(pinfo.iters, gap_p, rc_p)
    return (xp[0] if single else xp), info
