"""Batched 1D TV-L1 proximity solvers (port of ``proxtv_tpu.ops.tv1d_l1``).

Solves, for every signal in a batch,

    min_x 0.5 ||x - y||^2 + sum_i w_i |x_{i+1} - x_i|

with scalar, per-signal or per-edge weights.

*   :func:`tv1_pn` — projected Newton on the dual box-constrained QP
    (reference ``src/TVL1opt.cpp:37`` ``PN_TV1`` and ``src/TVL1Wopt.cpp:37``
    ``PN_TV1_Weighted``).  The inactive-set Newton system is solved at full
    size by *masked* parallel cyclic reduction (active rows become identity
    rows), batched over signals.  On a CUDA batch its tridiagonal solves
    run kernel B2 in the batch's dtype (float32 or float64).
*   :func:`tv1_tautstring` — the weighted linearized taut string (reference
    ``src/TVL1Wopt.cpp:364``).  On a CUDA batch kernel D1
    (:mod:`.kernels.tautstring`, one warp a signal up to n = 16384 in
    float32, 8192 in float64); on the CPU :func:`tv1_tautstring_plain`,
    the JAX package's lock-step scan.
*   :func:`tv1_dp` — the Kolmogorov/Pock/Rolinek message-passing DP
    (reference ``src/TVL1opt_kolmogorov.cpp:38``), weighted-capable.  On a
    CUDA batch kernel D2 (:mod:`.kernels.dp`); on the CPU
    :func:`tv1_dp_plain`, the lock-step deque machine.
*   :func:`tv1_condat` — Condat's dual-variable segment scan (reference
    ``src/condat_fast_tv.cpp:78``) and :func:`tv1_classic_ts` — the classic
    hull-merge taut string (``src/TVL1opt_tautstring.cpp:256``): unweighted
    (one lambda a signal).  On a CUDA batch kernels D3
    (:mod:`.kernels.condat`) and D4 (:mod:`.kernels.classic_ts`), one
    launch each, float32 or float64; on the CPU :func:`tv1_condat_plain` and
    :func:`tv1_classic_ts_plain`, the JAX package's lock-step scans.
*   :func:`tv1_batched` — reference-compatible method names, routed by the
    JAX package's table (:func:`tv1_route`), a float64 CUDA batch by its
    float64 route.

The lock-step engines repeat the JAX package's ``while_loop`` bodies event
for event; their loops read the running flag to the host every
``_CHECK_EVERY`` events (a finished lane's event is a no-op, so the extra
events change nothing).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import debug, diffs
from ..utils.config import DEFAULT_TV1, EPSILON, TV1Config
from ..utils.info import RC_ITERS, RC_OK, RC_STUCK, make_info
from . import tridiag

# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _edge_weights(lam, B, n, dtype, device):
    """Broadcast lam (scalar, (B,), or (B, n-1)) to a (B, n-1) edge-weight array."""
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    if lam.ndim == 0:
        return torch.broadcast_to(lam, (B, n - 1))
    if lam.ndim == 1:
        if lam.shape[0] == B:
            return torch.broadcast_to(lam[:, None], (B, n - 1))
        if lam.shape[0] == n - 1:
            return torch.broadcast_to(lam[None, :], (B, n - 1))
        raise ValueError(f"Cannot interpret weight shape {tuple(lam.shape)} "
                         f"for batch {B}, n {n}")
    return torch.broadcast_to(lam, (B, n - 1))


def _gap_tv1w(w, g, lam):
    """Duality gap, reference GRAD2GAP (src/TVL1opt.cpp:46-49):
    gap = sum_i |g_i| lam_i + w_i g_i."""
    return torch.abs(torch.sum(torch.abs(g) * lam + w * g, dim=-1))


def _apply_degenerate_guards(x, y, lamv):
    """Handle the two degenerate penalty regimes exactly:

    * all-zero weights -> prox is the identity;
    * weights so large the solution is provably constant -> prox is the mean
      (sufficient condition: min_i lam_i >= n^2 * max|dy|,
      cf. src/TVL1opt.cpp:120-133).
    """
    n = y.shape[-1]
    dy_max = torch.amax(torch.abs(diffs.forward_diff(y)), dim=-1)
    all_zero = torch.all(lamv <= 0, dim=-1)
    huge = torch.amin(lamv, dim=-1) >= (float(n) * float(n)) * dy_max
    mean = torch.mean(y, dim=-1, keepdim=True)
    x = torch.where(huge[:, None], mean, x)
    return torch.where(all_zero[:, None], y, x)


# ---------------------------------------------------------------------------
# Projected Newton on the dual (batched, masked cyclic reduction)
# ---------------------------------------------------------------------------


def tv1_pn(y, lam, cfg: TV1Config = DEFAULT_TV1, tridiag_method: str = "pcr",
           w_init=None, return_dual: bool = False):
    """Batched projected-Newton TV-L1 prox (weighted-capable).

    Args:
        y: (B, n) batch of signals (any device; float32 or float64).
        lam: scalar, (B,), or (B, n-1) nonnegative penalty weights.
        cfg: solver tolerances (defaults mirror the reference).
        w_init: optional (B, n-1) dual warm start (reference Workspace warm
            restart, src/utils.h:30-33).
        return_dual: also return the final dual vector.

    Returns:
        (x, info) or (x, info, w).  The outer and line-search loops are
        Python loops; each trip reads one flag to the host.
    """
    B, n = y.shape
    dtype, dev = y.dtype, y.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    eps = scalar(EPSILON)
    big = scalar(torch.finfo(dtype).max)
    feps = torch.finfo(dtype).eps

    if n == 1:
        info1 = make_info(torch.zeros((B,), dtype=torch.int32, device=dev),
                          torch.zeros((B,), dtype=dtype, device=dev),
                          torch.zeros((B,), dtype=torch.int32, device=dev))
        if return_dual:
            return y, info1, y.new_zeros((B, 0))
        return y, info1

    lamv = _edge_weights(lam, B, n, dtype, dev)

    # Center each signal: the prox is translation-equivariant and the dual
    # depends only on Dy, so the internal magnitudes (and the dtype-relative
    # stopping scale) become invariant to DC offsets.
    ybar = torch.mean(y, dim=-1, keepdim=True)
    y = y - ybar

    dy = diffs.forward_diff(y)
    if w_init is None:
        # Unconstrained dual solution: DD' w = Dy (reference src/TVL1opt.cpp:110-117).
        w0 = tridiag.spd_second_difference_solve(dy, method=tridiag_method)
        w = torch.clamp(w0, -lamv, lamv)
    else:
        w = torch.clamp(torch.as_tensor(w_init, dtype=dtype, device=dev),
                        -lamv, lamv)

    x = diffs.dual2primal(w, y)
    g = diffs.primal2grad(x)
    fval = 0.5 * torch.sum(x * x, dim=-1)
    sigma = cfg.sigma

    scale = torch.clamp(0.5 * torch.sum(y * y, dim=-1), min=1.0)
    tol = torch.clamp(2.0 * feps * scale, min=cfg.stop)
    eps_gap = torch.maximum(eps, 2.0 * feps * scale)
    eps_f = torch.maximum(eps, 10.0 * feps * scale)
    MAX_STALL = 5

    def inactive_mask(w, g):
        # Reference CHECK_INACTIVE (src/TVL1opt.cpp:62-65), restricted to
        # lam_i > 0: a zero-weight edge's dual is pinned at 0.
        return (lamv > 0) & (
            ((w > -lamv) & (w < lamv)) | ((w == -lamv) & (g < -eps))
            | ((w == lamv) & (g > eps)))

    def armijo(w, g, d, mI, x, fval):
        """Bounded Armijo + quadratic-interpolation stepsize search
        (reference src/TVL1opt.cpp:203-276), batched with per-lane masks."""
        zero = torch.zeros((), dtype=dtype, device=dev)
        gRd = torch.sum(torch.where(mI, g * d, zero), dim=-1)
        zc = torch.zeros_like(w[:, :1])
        hw = (2.0 * w - torch.cat([zc, w[:, :-1]], dim=-1)
              - torch.cat([w[:, 1:], zc], dim=-1))
        dy_edges = diffs.forward_diff(y)
        use = mI & ~(w == lamv)

        def maxstep_fn(d):
            t_neg = torch.where(mI & (d < 0), (w - lamv) / d, -big)
            t_pos = torch.where(mI & (d > 0), (w + lamv) / d, -big)
            return torch.maximum(torch.amax(t_neg, dim=-1),
                                 torch.amax(t_pos, dim=-1))

        grad0 = torch.sum(torch.where(use, -d * (hw - dy_edges), zero), dim=-1)
        maxstep0 = maxstep_fn(d)

        k = 0
        delta = torch.ones((B,), dtype=dtype, device=dev)
        maxstep = maxstep0
        found = torch.zeros((B,), dtype=torch.bool, device=dev)
        stop_flag = torch.zeros((B,), dtype=torch.bool, device=dev)
        best_aux, best_x, best_f = w, x, fval
        recomp = torch.zeros((B,), dtype=torch.bool, device=dev)
        while k < cfg.max_armijo and debug.host(torch.any(~(found | stop_flag))):
            aux = torch.where(mI, torch.clamp(w - delta[:, None] * d, -lamv, lamv), w)
            # Cancellation-free objective change (x = y + D'w fixed during the
            # search): f(aux) - f(w) = sum x.(D'dw) + 0.5 ||D'dw||^2.
            dx = diffs.adjoint_diff(aux - w)
            x_new = x + dx
            improve = -(torch.sum(x * dx, dim=-1)
                        + 0.5 * torch.sum(dx * dx, dim=-1))
            f_new = fval - improve
            no_improve = improve <= eps_f
            ok = improve >= sigma * delta * gRd

            newly_done = (~found) & (~stop_flag) & (ok | no_improve)
            best_aux = torch.where(newly_done[:, None], aux, best_aux)
            best_x = torch.where(newly_done[:, None], x_new, best_x)
            best_f = torch.where(newly_done, f_new, best_f)
            found = found | newly_done

            searching = ~found & ~stop_flag
            tmp = grad0 * delta
            denom = 2.0 * (-improve - tmp)
            delta_interp = torch.where(denom != 0, -(tmp * delta) / denom,
                                       delta * 0.5)
            ms = torch.where(recomp, maxstep, maxstep0)
            delta_new = torch.minimum(delta_interp, ms)
            delta_new = torch.where(delta_new - delta >= -eps, delta * 0.5,
                                    delta_new)
            dead = searching & (delta_new < eps)
            best_aux = torch.where(dead[:, None], aux, best_aux)
            best_x = torch.where(dead[:, None], x_new, best_x)
            best_f = torch.where(dead, f_new, best_f)
            found = found | dead

            delta = torch.where(searching, delta_new, delta)
            maxstep = torch.where(searching, delta_new, maxstep)
            recomp = torch.ones_like(recomp)
            k += 1
        return best_aux, best_x, best_f

    stop = _gap_tv1w(w, g, lamv)
    best = stop
    stall = torch.zeros((B,), dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    running = stop > tol
    while debug.host(torch.any(running)
                     & (torch.amax(iters) < cfg.max_iters)):
        mI = inactive_mask(w, g)
        any_inactive = torch.any(mI, dim=-1)
        # Masked Newton direction (active rows identity / decoupled).
        d = tridiag.spd_second_difference_solve(
            torch.where(mI, g, torch.zeros_like(g)), mask=mI,
            method=tridiag_method)
        d = torch.where(mI, d, torch.zeros_like(d))

        aux, x_new, f_new = armijo(w, g, d, mI, x, fval)

        g_new = diffs.primal2grad(x_new)
        stop_new = _gap_tv1w(aux, g_new, lamv)

        act = running & any_inactive
        w = torch.where(act[:, None], aux, w)
        x = torch.where(act[:, None], x_new, x)
        g = torch.where(act[:, None], g_new, g)
        fval = torch.where(act, f_new, fval)
        stop = torch.where(act, stop_new, stop)
        # Stuck detection: consecutive iterations without a material
        # best-gap improvement (reference src/TVL1opt.cpp:286-290, made
        # robust to slow tails and f32 gap noise).
        improved = (stop < best - eps_gap) | (stop < 0.875 * best)
        best = torch.minimum(best, stop)
        stall = torch.where(act, torch.where(improved, 0, stall + 1), stall)
        iters = iters + act.to(torch.int32)
        running = running & any_inactive & (stop > tol) & (stall < MAX_STALL)

    rc = torch.where(iters >= cfg.max_iters, RC_ITERS,
                     torch.where((stop > tol) & (stall >= MAX_STALL),
                                 RC_STUCK, RC_OK))
    info = make_info(iters, torch.abs(stop), rc)
    x = x + ybar
    if return_dual:
        return x, info, w
    return x, info


# ---------------------------------------------------------------------------
# Direct engines: lock-step ports of the JAX package's while_loops
# ---------------------------------------------------------------------------

_CHECK_EVERY = 16  # events between host reads of the running flag


def _run_lockstep(body, state, running, cap=None):
    """Run ``body`` on ``state`` until ``running(state)`` reads False on the
    host (every ``_CHECK_EVERY`` events) or ``cap`` events have run."""
    it = 0
    while cap is None or it < cap:
        steps = _CHECK_EVERY if cap is None else min(_CHECK_EVERY, cap - it)
        for _ in range(steps):
            state = body(state)
        it += steps
        if not debug.host(running(state)):
            break
    return state


def _take(a, idx, lo, hi):
    """a[row, clip(idx, lo, hi)] for every row of a (B, m) tensor."""
    return torch.gather(a, 1, torch.clamp(idx, lo, hi)[:, None])[:, 0]


def _reverse_cummin(idx):
    return torch.flip(torch.cummin(torch.flip(idx, (1,)), dim=1).values, (1,))


def tv1_tautstring_plain(y, lam):
    """Batched linearized taut-string TV-L1 prox (weighted, exact): the
    JAX package's lock-step scan (``tv1d_l1.py:334-462``) on tensors of any
    device.  One event per lane per step: a point advance, a segment break
    (with backtrack) or the end; segments are recorded as (end, value) and
    the solution filled from them by a reverse cumulative minimum."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    if n == 1:
        return y
    eps = torch.tensor(EPSILON, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    lamv = _edge_weights(lam, B, n, dtype, dev)
    rows = torch.arange(B, device=dev)
    seg_val = torch.zeros((B, n + 1), dtype=dtype, device=dev)
    seg_mark = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)

    def body(state):
        i, mn, mx, mnH, mxH, mnB, mxB, last = state
        done = i >= n
        yi = _take(y, i, 0, n - 1)
        lam_i = _take(lamv, i, 0, n - 2)
        is_last = i == n - 1

        mnH1 = mnH + mn - yi
        ceil = torch.where(is_last, mnH1 > eps, lam_i < mnH1)
        mxH1 = mxH + mx - yi
        floor = ~ceil & torch.where(is_last, mxH1 < -eps, -lam_i > mxH1)
        brk = (ceil | floor) & ~done

        # break: restart after the pinned wall's last touch
        b_end = torch.where(ceil, mnB, mxB)
        b_val = torch.where(ceil, mn, mx)
        i_new = b_end + 1
        y_new = _take(y, i_new, 0, n - 1)
        lam_nm1 = _take(lamv, i_new - 1, 0, n - 2)
        lam_n = torch.where(is_last & (i_new == n - 1), zero,
                            _take(lamv, i_new, 0, n - 2))
        sgn = torch.where(ceil, one, -one)
        mn_b = y_new + sgn * lam_nm1 - lam_n
        mx_b = y_new + sgn * lam_nm1 + lam_n
        mnH_b = torch.where(is_last, -sgn * lam_nm1, -lam_n)
        mxH_b = torch.where(is_last, -sgn * lam_nm1, lam_n)
        i_b = torch.where(is_last, i_new, i_new + 1)

        # no violation: tighten the slopes where the walls are touched
        step_gen = ~brk & ~done & ~is_last
        denom = (i - last).to(dtype)
        touch_hi = mxH1 >= lam_i
        mx_g = torch.where(touch_hi, mx + (lam_i - mxH1) / denom, mx)
        mxH_g = torch.where(touch_hi, lam_i, mxH1)
        mxB_g = torch.where(touch_hi, i, mxB)
        touch_lo = mnH1 <= -lam_i
        mn_g = torch.where(touch_lo, mn + (-lam_i - mnH1) / denom, mn)
        mnH_g = torch.where(touch_lo, -lam_i, mnH1)
        mnB_g = torch.where(touch_lo, i, mnB)

        step_last = ~brk & ~done & is_last
        mn_l = torch.where(mnH1 <= 0, mn + (-mnH1) / denom, mn)

        i_next = torch.where(done, i, torch.where(brk, i_b, i + 1))
        mn_next = torch.where(brk, mn_b, torch.where(
            step_last, mn_l, torch.where(step_gen, mn_g, mn)))
        mx_next = torch.where(brk, mx_b, torch.where(step_gen, mx_g, mx))
        mnH_next = torch.where(brk, mnH_b, torch.where(step_gen, mnH_g, mnH1))
        mxH_next = torch.where(brk, mxH_b, torch.where(
            step_gen, mxH_g, torch.where(step_last, mxH1, mxH)))
        mnH_next = torch.where(done, mnH, mnH_next)
        mxH_next = torch.where(done, mxH, mxH_next)
        mn_next = torch.where(done, mn, mn_next)
        mx_next = torch.where(done, mx, mx_next)
        mnB_next = torch.where(brk, i_new, torch.where(step_gen, mnB_g, mnB))
        mxB_next = torch.where(brk, i_new, torch.where(step_gen, mxB_g, mxB))
        last_next = torch.where(brk, b_end, last)

        # segment record; column n is the bin of lanes with none
        rec = brk | step_last
        col = torch.where(rec, torch.where(brk, b_end, n - 1), n)
        seg_val[rows, col] = torch.where(brk, b_val, mn_l)
        seg_mark[rows, col] = True
        return (i_next, mn_next, mx_next, mnH_next, mxH_next, mnB_next,
                mxB_next, last_next)

    lam0 = lamv[:, 0]
    iz = torch.zeros((B,), dtype=torch.int64, device=dev)
    fz = torch.zeros((B,), dtype=dtype, device=dev)
    state = (iz, y[:, 0] - lam0, y[:, 0] + lam0, fz, fz, iz, iz,
             torch.full((B,), -1, dtype=torch.int64, device=dev))
    _run_lockstep(body, state, lambda s: torch.any(s[0] < n))

    # x[j] = value of the nearest recorded segment end >= j
    ar = torch.arange(n, device=dev)[None, :]
    nxt = _reverse_cummin(torch.where(seg_mark[:, :n], ar, n - 1))
    x = torch.gather(seg_val[:, :n], 1, nxt)
    return _apply_degenerate_guards(x, y, lamv)


def tv1_tautstring(y, lam):
    """Batched weighted taut-string TV-L1 prox: kernel D1 on a CUDA batch
    (float32 or float64, its instantiation for the batch's dtype; it
    launches or raises), :func:`tv1_tautstring_plain` on the CPU.
    ``lam``: scalar, (B,) per signal, (n-1,) shared or (B, n-1) per
    edge."""
    from .kernels import tautstring

    return tautstring.tautstring(y, lam)


def _unweighted_lam(lam, B, n, dtype, device, name, ref):
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    if lam.ndim >= 2 or (lam.ndim == 1 and lam.shape[0] == n - 1
                         and B != n - 1):
        raise ValueError(f"{name} is unweighted: lam must be scalar or (B,) "
                         f"per-signal ({ref} takes one lambda)")
    # A negative penalty would keep the scan from reaching its end event.
    return torch.clamp(torch.broadcast_to(lam, (B,)), min=0.0)


def _forward_fill(val, mark, n):
    """x[j] = value of the nearest recorded run START <= j."""
    ar = torch.arange(n, device=val.device)[None, :]
    prev = torch.cummax(torch.where(mark[:, :n], ar, 0), dim=1).values
    return torch.gather(val[:, :n], 1, prev)


def tv1_condat_plain(y, lam):
    """Batched Condat direct TV-L1 prox (unweighted, exact): the JAX
    package's lock-step port (``tv1d_l1.py:468-629``) of
    ``src/condat_fast_tv.cpp:78`` ``TV1D_denoise`` on tensors of any
    device: running dual excursions umin/umax, candidate values vmin/vmax,
    one reference loop event per step, segments recorded at their start
    and forward-filled.  ``lam``: scalar or (B,) per signal."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    if n == 1:
        return y
    lamv = _unweighted_lam(lam, B, n, dtype, dev, "tv1_condat",
                           "reference TV1D_denoise, src/condat_fast_tv.cpp:78,")
    rows = torch.arange(B, device=dev)
    seg_val = torch.zeros((B, n + 1), dtype=dtype, device=dev)
    seg_mark = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)

    def body(state):
        k, k0, kminus, kplus, vmin, vmax, umin, umax, done = state
        boundary = (k == n - 1) & ~done
        main = ~boundary & ~done

        # main-loop events (reference :100-118)
        ynext = _take(y, k + 1, 0, n - 1)
        umin1 = umin + ynext - vmin
        umax1 = umax + ynext - vmax
        neg = main & (umin1 < -lamv)
        pos = main & ~neg & (umax1 > lamv)
        nojump = main & ~neg & ~pos
        k0_n = kminus + 1
        y_n = _take(y, k0_n, 0, n - 1)
        k0_p = kplus + 1
        y_p = _take(y, k0_p, 0, n - 1)

        k_adv = k + 1
        denom = (k_adv - k0 + 1).to(dtype)
        hit_lo = nojump & (umin1 >= lamv)
        vmin_adv = torch.where(hit_lo, vmin + (umin1 - lamv) / denom, vmin)
        umin_adv = torch.where(hit_lo, lamv, umin1)
        kminus_adv = torch.where(hit_lo, k_adv, kminus)
        hit_hi = nojump & (umax1 <= -lamv)
        vmax_adv = torch.where(hit_hi, vmax + (umax1 + lamv) / denom, vmax)
        umax_adv = torch.where(hit_hi, -lamv, umax1)
        kplus_adv = torch.where(hit_hi, k_adv, kplus)

        # boundary events at k = n-1 (reference :88-99)
        b_neg = boundary & (umin < 0)
        b_pos = boundary & ~b_neg & (umax > 0)
        b_term = boundary & ~b_neg & ~b_pos
        ub_neg = y_n + lamv - vmax
        ub_pos = y_p - lamv - vmin
        v_term = vmin + umin / (k - k0 + 1).to(dtype)

        k_next = torch.where(neg, k0_n, torch.where(pos, k0_p, torch.where(
            nojump, k_adv, torch.where(b_neg, k0_n, torch.where(
                b_pos, k0_p, k)))))
        k0_next = torch.where(neg | b_neg, k0_n,
                              torch.where(pos | b_pos, k0_p, k0))
        kminus_next = torch.where(neg | b_neg, k0_n,
                                  torch.where(pos, k0_p, kminus_adv))
        kplus_next = torch.where(neg, k0_n,
                                 torch.where(pos | b_pos, k0_p, kplus_adv))
        vmin_next = torch.where(neg | b_neg, y_n, torch.where(
            pos, y_p - 2.0 * lamv, vmin_adv))
        vmax_next = torch.where(neg, y_n + 2.0 * lamv, torch.where(
            pos | b_pos, y_p, vmax_adv))
        umin_next = torch.where(neg | pos | b_neg, lamv,
                                torch.where(b_pos, ub_pos, umin_adv))
        umax_next = torch.where(neg | pos, -lamv, torch.where(
            b_neg, ub_neg, torch.where(b_pos, -lamv, umax_adv)))

        # segment record at its START k0; column n is the bin
        emit = neg | pos | b_neg | b_pos | b_term
        val = torch.where(neg | b_neg, vmin,
                          torch.where(pos | b_pos, vmax, v_term))
        col = torch.where(emit, k0, n)
        seg_val[rows, col] = val
        seg_mark[rows, col] = True
        return (k_next, k0_next, kminus_next, kplus_next, vmin_next,
                vmax_next, umin_next, umax_next, done | b_term)

    iz = torch.zeros((B,), dtype=torch.int64, device=dev)
    state = (iz, iz, iz, iz, y[:, 0] - lamv, y[:, 0] + lamv, lamv, -lamv,
             torch.zeros((B,), dtype=torch.bool, device=dev))
    _run_lockstep(body, state, lambda s: torch.any(~s[8]))
    x = _forward_fill(seg_val, seg_mark, n)
    return _apply_degenerate_guards(
        x, y, torch.broadcast_to(lamv[:, None], (B, n - 1)))


def tv1_condat(y, lam):
    """Batched Condat direct TV-L1 prox: kernel D3 on a CUDA batch
    (float32 or float64, its instantiation for the batch's dtype; it
    launches or raises), :func:`tv1_condat_plain` on the CPU.
    ``lam``: scalar or (B,) per signal."""
    from .kernels import condat

    return condat.condat(y, lam)


# Phases of the DP's deque machine (the JAX package's _PH_*).
_PH_INIT, _PH_LOWER, _PH_LOWER_EXIT, _PH_UPPER, _PH_UPPER_EXIT, _PH_DONE = (
    0, 1, 2, 3, 4, 5)


def tv1_dp_plain(y, lam):
    """Batched message-passing DP TV-L1 prox (weighted, exact, O(n)): the
    JAX package's lock-step port (``tv1d_l1.py:632-851``) of
    ``src/TVL1opt_kolmogorov.cpp:38-130`` on tensors of any device.  The
    breakpoint deque lives in a per-lane arena of 2n slots; one deque
    operation per step; then the backward pass
    ``x[i] = clip(x[i+1], lo[i], hi[i])``."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    if n == 1:
        return y
    lamv = _edge_weights(lam, B, n, dtype, dev)
    rows = torch.arange(B, device=dev)
    arena = 2 * n  # 2n-1 valid slots (0..2n-2) + the bin at 2n-1
    zero = torch.zeros((), dtype=dtype, device=dev)

    def g_arena(a, idx):
        return _take(a, idx, 0, arena - 1)

    def s_arena(a, idx, val, do):
        # in place; lanes without the write hit the never-read bin
        col = torch.where(do, torch.clamp(idx, 0, arena - 2), arena - 1)
        a[rows, col] = val.to(a.dtype)

    def s_bounds(a, idx, val, do):
        col = torch.where(do, torch.clamp(idx, 0, n - 1), n)
        a[rows, col] = val

    L0 = torch.full((B,), n - 1, dtype=torch.int64, device=dev)
    R0 = torch.full((B,), n, dtype=torch.int64, device=dev)
    P_lam = torch.zeros((B, arena), dtype=dtype, device=dev)
    P_slope = torch.zeros((B, arena), dtype=torch.int32, device=dev)
    lo = torch.zeros((B, n + 1), dtype=dtype, device=dev)
    hi = torch.zeros((B, n + 1), dtype=dtype, device=dev)
    w0 = lamv[:, 0]
    lo0 = -w0 + y[:, 0]
    hi0 = w0 + y[:, 0]
    P_slope[rows, L0 - 1] = -1
    P_lam[rows, L0] = lo0
    P_slope[rows, L0] = 0
    P_lam[rows, R0] = hi0
    P_slope[rows, R0] = -1
    lo[:, 0] = lo0
    hi[:, 0] = hi0

    def body(state):
        phase, i, A, L, R, msg_min, msg_max, slope, last_val = state
        W_prev = _take(lamv, i - 1, 0, n - 2)
        W = torch.where(i < n - 1, _take(lamv, i, 0, n - 2), zero)
        bi = _take(y, i, 0, n - 1)
        is_last = i == n - 1
        slope_f = slope.to(dtype)

        # INIT
        ph_init = phase == _PH_INIT
        mmin_i = -W_prev + g_arena(P_lam, L) - bi
        mmax_i = W_prev + g_arena(P_lam, R) - bi

        # LOWER
        ph_lower = phase == _PH_LOWER
        pop_l = msg_min < -W
        slope_l = g_arena(P_slope, L) + A
        L_l = L + 1
        l_overrun = L_l > R
        mmin_l = msg_min + (g_arena(P_lam, L_l) - g_arena(P_lam, L_l - 1)
                            ) * slope_l.to(dtype)

        # LOWER_EXIT
        ph_lexit = phase == _PH_LOWER_EXIT
        L_le_last = torch.where(L > R, L - 1, L)
        last_val_new = g_arena(P_lam, L_le_last) - msg_min / slope_f
        L_le = L - 1
        meet = L_le == R
        R_meet = R + 1
        pl_L_old = g_arena(P_lam, L_le)
        hi_meet = pl_L_old - (msg_max - W)
        lo_meet = pl_L_old - (msg_max + W)
        lo_nom = g_arena(P_lam, L_le + 1) - (W + msg_min) / slope_f

        # UPPER
        ph_upper = phase == _PH_UPPER
        pop_u = msg_max > W
        R_u = R - 1
        slope_u = g_arena(P_slope, R_u) + A
        mmax_u = msg_max - (g_arena(P_lam, R_u + 1) - g_arena(P_lam, R_u)
                            ) * slope_u.to(dtype)
        u_meet = R_u == L

        # UPPER_EXIT
        ph_uexit = phase == _PH_UPPER_EXIT
        R_ue = R + 1
        hi_ue = g_arena(P_lam, R_ue - 1) + (W - msg_max) / slope_f

        # merge (INIT)
        new_A = torch.where(ph_init, A + 1, A)
        new_mmin = torch.where(ph_init, mmin_i, msg_min)
        new_mmax = torch.where(ph_init, mmax_i, msg_max)
        new_slope = torch.where(ph_init, 1, slope)
        new_phase = torch.where(ph_init, _PH_LOWER, phase)

        # LOWER
        lower_pop = ph_lower & pop_l
        lower_stay = lower_pop & ~l_overrun
        lower_exit = ph_lower & (~pop_l | l_overrun)
        new_slope = torch.where(lower_pop, slope_l, new_slope)
        new_L = torch.where(lower_pop, L_l, L)
        new_mmin = torch.where(lower_stay, mmin_l, new_mmin)
        new_phase = torch.where(lower_exit, _PH_LOWER_EXIT, torch.where(
            lower_stay, _PH_LOWER, new_phase))

        # LOWER_EXIT
        le_done = ph_lexit & is_last
        new_last = torch.where(le_done, last_val_new, last_val)
        new_phase = torch.where(le_done, _PH_DONE, new_phase)
        new_L = torch.where(le_done, L_le_last, new_L)
        le_go = ph_lexit & ~is_last
        new_L = torch.where(le_go, L_le, new_L)
        s_arena(P_slope, L_le - 1, -A, le_go)
        le_meet = le_go & meet
        new_R = torch.where(le_meet, R_meet, R)
        s_arena(P_slope, R_meet, -A, le_meet)
        s_arena(P_lam, R_meet, hi_meet, le_meet)
        lo_le = torch.where(le_meet, lo_meet, lo_nom)
        s_arena(P_lam, L_le, lo_le, le_go)
        s_bounds(hi, i, hi_meet, le_meet)
        s_bounds(lo, i, lo_le, le_go)
        new_i = torch.where(le_meet, i + 1, i)
        new_phase = torch.where(le_meet, _PH_INIT, new_phase)
        le_nomeet = le_go & ~meet
        new_slope = torch.where(le_nomeet, 1, new_slope)
        new_phase = torch.where(le_nomeet, _PH_UPPER, new_phase)

        # UPPER
        upper_pop = ph_upper & pop_u
        new_R = torch.where(upper_pop, R_u, new_R)
        new_slope = torch.where(upper_pop, slope_u, new_slope)
        new_mmax = torch.where(upper_pop, mmax_u, new_mmax)
        upper_exit = ph_upper & (~pop_u | u_meet)
        new_phase = torch.where(upper_exit, _PH_UPPER_EXIT, torch.where(
            upper_pop & ~u_meet, _PH_UPPER, new_phase))

        # UPPER_EXIT
        new_R = torch.where(ph_uexit, R_ue, new_R)
        s_arena(P_slope, R_ue, -A, ph_uexit)
        s_arena(P_lam, R_ue, hi_ue, ph_uexit)
        s_bounds(hi, i, hi_ue, ph_uexit)
        new_i = torch.where(ph_uexit, i + 1, new_i)
        new_phase = torch.where(ph_uexit, _PH_INIT, new_phase)
        return (new_phase, new_i, new_A, new_L, new_R, new_mmin, new_mmax,
                new_slope, new_last)

    i32 = dict(dtype=torch.int32, device=dev)
    fz = torch.zeros((B,), dtype=dtype, device=dev)
    state = (torch.zeros((B,), **i32), torch.ones((B,), dtype=torch.int64,
                                                  device=dev),
             torch.ones((B,), **i32), L0, R0, fz, fz, torch.ones((B,), **i32),
             fz)
    state = _run_lockstep(body, state, lambda s: torch.any(s[0] != _PH_DONE))
    last_val = state[8]

    # backward clamping pass (reference :216-221)
    x = torch.empty((B, n), dtype=dtype, device=dev)
    x[:, n - 1] = last_val
    for j in range(n - 2, -1, -1):
        x[:, j] = torch.minimum(torch.maximum(x[:, j + 1], lo[:, j]), hi[:, j])
    return _apply_degenerate_guards(x, y, lamv)


def tv1_dp(y, lam):
    """Batched message-passing DP TV-L1 prox: kernel D2 on a CUDA batch
    (float32 or float64, its instantiation for the batch's dtype; it
    launches or raises), :func:`tv1_dp_plain` on the CPU.  Serves ``dp``,
    ``kolmogorov`` and ``johnson``, scalar or per-edge weights.
    ``lam`` as :func:`tv1_tautstring`."""
    from .kernels import dp

    return dp.dp(y, lam)


# Phases of the classic taut string (the JAX package's _CT_*).
_CT_MAJ, _CT_MIN, _CT_CROSS, _CT_FLUSH, _CT_DONE = 0, 1, 2, 3, 4


def tv1_classic_ts_plain(y, lam):
    """Batched classic taut-string TV-L1 prox (unweighted, exact): the JAX
    package's lock-step port (``tv1d_l1.py:854-1103``) of
    ``src/TVL1opt_tautstring.cpp:256`` ``classicTautString_TV1`` on tensors
    of any device: the concave majorant and convex minorant of the
    cumulative-sum tube kept as segment deques in per-lane arenas, one
    deque event per step (a hull pop, a push, a knot or a flush emission),
    runs recorded at their start and forward-filled.  At most 8n + 64
    events (the JAX package's watchdog bound, unreachable for well-formed
    input).  ``lam``: scalar or (B,) per signal."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    if n == 1:
        return y
    lamv = _unweighted_lam(lam, B, n, dtype, dev, "tv1_classic_ts",
                           "reference classicTautString_TV1, "
                           "src/TVL1opt_tautstring.cpp:256,")
    rows = torch.arange(B, device=dev)
    A = n + 2  # arena: <= n+1 live segments + the bin at A-1
    out_val = torch.zeros((B, n + 1), dtype=dtype, device=dev)
    out_mark = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    maj_ix = torch.zeros((B, A), dtype=torch.int64, device=dev)
    maj_iy = torch.zeros((B, A), dtype=dtype, device=dev)
    min_ix = torch.zeros((B, A), dtype=torch.int64, device=dev)
    min_iy = torch.zeros((B, A), dtype=dtype, device=dev)
    maj_ix[:, 0] = 1
    maj_iy[:, 0] = y[:, 0] - lamv
    min_ix[:, 0] = 1
    min_iy[:, 0] = y[:, 0] + lamv

    def g_arena(a, idx):
        return _take(a, idx, 0, A - 1)

    def s_arena(a, idx, val, do):
        col = torch.where(do, torch.clamp(idx, 0, A - 2), A - 1)
        a[rows, col] = val.to(a.dtype)

    def fresh(i, sign):
        """Pending unit segment for point i: the last point enters the
        majorant at y + lam and the minorant at y - lam (reference
        :317-323)."""
        yi = _take(y, i, 0, n - 1)
        return torch.where(i == n - 1, yi + sign * lamv, yi)

    def body(state):
        (phase, i, s_incx, s_incy, maj_f, maj_l, min_f, min_l, org_x, org_y,
         le_x, le_y, opos, flush_maj) = state

        def dct(v):
            return v.to(dtype)

        # hull merges
        in_maj = phase == _CT_MAJ
        in_min = phase == _CT_MIN
        mj_last_ix = g_arena(maj_ix, maj_l)
        mj_last_iy = g_arena(maj_iy, maj_l)
        mj_size = maj_l - maj_f + 1
        mj_pop = in_maj & (mj_size >= 1) & (
            s_incy > dct(s_incx) * (mj_last_iy / dct(mj_last_ix)))
        mj_push = in_maj & ~mj_pop
        mn_last_ix = g_arena(min_ix, min_l)
        mn_last_iy = g_arena(min_iy, min_l)
        mn_size = min_l - min_f + 1
        mn_pop = in_min & (mn_size >= 1) & (
            s_incy < dct(s_incx) * (mn_last_iy / dct(mn_last_ix)))
        mn_push = in_min & ~mn_pop

        # crossing check / knot emission.  Two single-segment hulls cannot
        # cross in exact arithmetic; in float32 a 1-ulp tie of their merged
        # sums at lam = 0 could fake a crossing that empties a deque.
        in_cross = phase == _CT_CROSS
        mj_first_ix = g_arena(maj_ix, maj_f)
        mj_first_iy = g_arena(maj_iy, maj_f)
        mn_first_ix = g_arena(min_ix, min_f)
        mn_first_iy = g_arena(min_iy, min_f)
        both_single = (mj_size == 1) & (mn_size == 1)
        crossing = in_cross & ~both_single & (
            (mn_first_iy / dct(mn_first_ix))
            < (mj_first_iy / dct(mj_first_ix)))
        take_min = crossing & (mn_first_ix < mj_first_ix)
        take_maj = crossing & ~take_min
        no_cross = in_cross & ~crossing
        rep_maj_ix = le_x - org_x - mn_first_ix
        rep_maj_iy = le_y - lamv - org_y - mn_first_iy
        rep_min_ix = le_x - org_x - mj_first_ix
        rep_min_iy = le_y + lamv - org_y - mj_first_iy

        # flush
        in_flush = phase == _CT_FLUSH
        fl_is_maj = flush_maj > 0
        fl_f = torch.where(fl_is_maj, maj_f, min_f)
        fl_l = torch.where(fl_is_maj, maj_l, min_l)
        fl_ix = torch.where(fl_is_maj, g_arena(maj_ix, fl_f),
                            g_arena(min_ix, fl_f))
        fl_iy = torch.where(fl_is_maj, g_arena(maj_iy, fl_f),
                            g_arena(min_iy, fl_f))
        fl_emit = in_flush & (fl_f <= fl_l)
        fl_done = in_flush & ~fl_emit

        # next state
        i_next = torch.where(no_cross, i + 1, i)
        to_min = mj_push
        to_cross = mn_push & (i < n - 1)
        to_flush = mn_push & (i == n - 1)
        to_maj = no_cross
        one_i = torch.ones_like(s_incx)
        s_incx_next = torch.where(mj_pop, s_incx + mj_last_ix, torch.where(
            mn_pop, s_incx + mn_last_ix, torch.where(
                to_min | to_maj, one_i, s_incx)))
        s_incy_next = torch.where(mj_pop, s_incy + mj_last_iy, torch.where(
            mn_pop, s_incy + mn_last_iy, torch.where(
                to_min, fresh(i, -1.0), torch.where(
                    to_maj, fresh(i_next, 1.0), s_incy))))

        mj_store = mj_push | take_min
        mj_col = torch.where(take_min, 0, maj_l + 1)
        s_arena(maj_ix, mj_col, torch.where(take_min, rep_maj_ix, s_incx),
                mj_store)
        s_arena(maj_iy, mj_col, torch.where(take_min, rep_maj_iy, s_incy),
                mj_store)
        maj_l_next = torch.where(mj_pop, maj_l - 1, torch.where(
            mj_push, maj_l + 1, torch.where(take_min, 0, maj_l)))
        maj_f_next = torch.where(take_min, 0, torch.where(
            take_maj, maj_f + 1, torch.where(fl_emit & fl_is_maj, maj_f + 1,
                                             maj_f)))
        mn_store = mn_push | take_maj
        mn_col = torch.where(take_maj, 0, min_l + 1)
        s_arena(min_ix, mn_col, torch.where(take_maj, rep_min_ix, s_incx),
                mn_store)
        s_arena(min_iy, mn_col, torch.where(take_maj, rep_min_iy, s_incy),
                mn_store)
        min_l_next = torch.where(mn_pop, min_l - 1, torch.where(
            mn_push, min_l + 1, torch.where(take_maj, 0, min_l)))
        min_f_next = torch.where(take_maj, 0, torch.where(
            take_min, min_f + 1, torch.where(fl_emit & ~fl_is_maj, min_f + 1,
                                             min_f)))

        knot_ix = torch.where(take_min, mn_first_ix, mj_first_ix)
        knot_iy = torch.where(take_min, mn_first_iy, mj_first_iy)
        org_x = torch.where(crossing, org_x + knot_ix, org_x)
        org_y = torch.where(crossing, org_y + knot_iy, org_y)
        le_x = torch.where(to_cross, le_x + 1, le_x)
        le_y = torch.where(to_cross, le_y + _take(y, i, 0, n - 1), le_y)

        # output runs, recorded at their start
        emit = crossing | fl_emit
        emit_ix = torch.where(crossing, knot_ix, fl_ix)
        emit_val = torch.where(crossing, knot_iy / dct(knot_ix),
                               fl_iy / dct(torch.clamp(fl_ix, min=1)))
        col = torch.where(emit, torch.clamp(opos, 0, n - 1), n)
        out_val[rows, col] = emit_val
        out_mark[rows, col] = True
        opos = torch.where(emit, opos + emit_ix, opos)

        flush_maj = torch.where(
            to_flush, ((maj_l_next - maj_f_next)
                       > (min_l_next - min_f_next)).to(flush_maj.dtype),
            flush_maj)
        phase_next = torch.where(mj_push, _CT_MIN, torch.where(
            to_cross, _CT_CROSS, torch.where(to_flush, _CT_FLUSH, torch.where(
                no_cross, _CT_MAJ, torch.where(fl_done, _CT_DONE, phase)))))
        return (phase_next, i_next, s_incx_next, s_incy_next, maj_f_next,
                maj_l_next, min_f_next, min_l_next, org_x, org_y, le_x, le_y,
                opos, flush_maj)

    i64 = dict(dtype=torch.int64, device=dev)
    iz = torch.zeros((B,), **i64)
    i0 = torch.ones((B,), **i64)
    state = (torch.full((B,), _CT_MAJ, **i64), i0, torch.ones((B,), **i64),
             fresh(i0, 1.0), iz, iz, iz, iz, iz,
             torch.zeros((B,), dtype=dtype, device=dev),
             torch.ones((B,), **i64), y[:, 0], iz, iz)
    _run_lockstep(body, state, lambda s: torch.any(s[0] != _CT_DONE),
                  cap=8 * n + 64)
    x = _forward_fill(out_val, out_mark, n)
    return _apply_degenerate_guards(
        x, y, torch.broadcast_to(lamv[:, None], (B, n - 1)))


def tv1_classic_ts(y, lam):
    """Batched classic taut-string TV-L1 prox: kernel D4 on a CUDA batch
    (float32 or float64, its instantiation for the batch's dtype; it
    launches or raises), :func:`tv1_classic_ts_plain` on the CPU.
    ``lam``: scalar or (B,) per signal."""
    from .kernels import classic_ts

    return classic_ts.classic_ts(y, lam)


# ---------------------------------------------------------------------------
# Method dispatch (mirrors the reference Python method table,
# prox_tv/__init__.py:163-172)
# ---------------------------------------------------------------------------

_SCAN_METHODS = {"classictautstring", "linearizedtautstring",
                 "hybridtautstring", "condattautstring", "tautstring"}
_DP_METHODS = {"dp", "kolmogorov", "johnson"}


def _per_edge(lam, B, n):
    shape = np.shape(lam)  # a tensor's own shape; no tensor is made
    return len(shape) >= 2 or (len(shape) == 1 and shape[0] == n - 1
                               and B != n - 1)


def _route_method(method, lam, B, n, strict):
    """The method name tv1_batched routes: lower case, checked, and an
    unweighted engine's name with per-edge weights refused (strict) or
    coerced to the taut string."""
    method = method.lower()
    known = _SCAN_METHODS | _DP_METHODS | {"condat", "pn"}
    if method not in known:
        raise ValueError(f"Unknown TV-L1 method: {method!r}")
    if method in ("classictautstring", "condat") and _per_edge(lam, B, n):
        if strict:
            raise ValueError(
                f"method={method!r} is unweighted (one lambda per signal); "
                "use 'tautstring'/'pn'/'dp' for per-edge weights")
        method = "hybridtautstring"
    return method


def _engine(method, fused_ok):
    """The engine of a routed method: ``pn_fused`` (kernel B1) where the
    gate let B1 take the batch, else the named engine: ``tv1_pn``,
    ``classic_ts``, ``condat``, ``tautstring`` or ``dp``."""
    if fused_ok:
        return "pn_fused"
    if method == "pn":
        return "tv1_pn"
    if method == "classictautstring":
        return "classic_ts"
    if method == "condat":
        return "condat"
    return "tautstring" if method in _SCAN_METHODS else "dp"


def tv1_route(method, lam, B, n, strict=False, is_cuda=False,
              dtype=torch.float32):
    """The engine :func:`tv1_batched` runs for a (B, n) batch of ``dtype``
    on a CUDA card (``is_cuda``) or the CPU, which a test can ask without
    a card: ``pn_fused`` (B1), ``tv1_pn`` (its Newton systems on B2 where
    ``gating.gate(rhs, "pcr")`` says so), or a direct engine,
    ``tautstring`` (D1), ``dp`` (D2), ``condat`` (D3) or ``classic_ts``
    (D4), each of which launches its kernel's instantiation for ``dtype``
    on the card.  A float64 CUDA batch takes the JAX package's float64
    route: B1 never, so the named engine (``tv1_pn`` for ``pn``).  Raises
    as :func:`tv1_batched` does (an unknown name, per-edge weights with a
    strict unweighted name, a card route the gate refuses)."""
    from .kernels import gating

    method = _route_method(method, lam, B, n, strict)
    fused_ok = ((method == "pn" or not strict)
                and gating.decide("pn", is_cuda, dtype, n))
    engine = _engine(method, fused_ok)
    kind = {"tautstring": "tautstring", "dp": "dp", "condat": "condat",
            "classic_ts": "classic"}.get(engine)
    if kind is not None:
        gating.decide(kind, is_cuda, dtype, n)  # raises where it would
    return engine


def tv1_batched(y, lam, method: str = "hybridtautstring",
                cfg: TV1Config = DEFAULT_TV1, strict: bool = False,
                tol_eps: float = 10.0):
    """Batched 1D TV-L1 prox with reference-compatible method names, routed
    by the JAX package's table (``tv1d_l1.py:1141-1191``; :func:`tv1_route`
    names the engine).

    ``classictautstring`` names :func:`tv1_classic_ts`; ``condat``
    :func:`tv1_condat`; ``tautstring``, ``linearizedtautstring``,
    ``hybridtautstring`` and ``condattautstring`` the taut-string scan
    (:func:`tv1_tautstring`); ``dp``, ``kolmogorov`` and ``johnson`` the
    message-passing DP (:func:`tv1_dp`); ``pn`` projected Newton.  All are
    exact to solver tolerance.

    With ``strict=True`` the named engine runs (on a CUDA batch the taut
    string is kernel D1, the DP kernel D2, Condat kernel D3 and the classic
    taut string kernel D4, one launch each).  With ``strict=False`` every name runs
    kernel B1 where ``gating.gate(y, "pn")`` says so (a CUDA float32 batch
    with 2 <= n <= 8192), and the named engine where it says no: on the CPU,
    past B1's lane limit, and for a float64 batch, which takes the JAX
    package's float64 route (D1, D2, D3 and D4 in float64).
    ``method="pn"`` runs B1 where the gate
    says so and :func:`tv1_pn` elsewhere (on a float64 CUDA batch its
    Newton systems on B2 in float64), strict or not.
    The unweighted engines (``condat``, ``classictautstring``) raise on
    per-edge weights when strict and take the taut string otherwise.
    ``tol_eps`` is B1's float32 stop floor (``pn_fused.pn_tv1_fused``; 10,
    the TPU kernel's, by default; ``diffprox.tv1_prox`` passes 0).
    """
    from .kernels import gating

    B, n = y.shape
    method = _route_method(method, lam, B, n, strict)
    fused_ok = (method == "pn" or not strict) and gating.gate(y, "pn")
    engine = _engine(method, fused_ok)
    if engine == "classic_ts":
        return tv1_classic_ts(y, lam)
    if engine == "condat":
        return tv1_condat(y, lam)
    if engine == "tautstring":
        return tv1_tautstring(y, lam)
    if engine == "dp":
        return tv1_dp(y, lam)
    if engine == "pn_fused":
        from .kernels import pn_fused

        if np.ndim(lam) == 0:
            # Uniform penalty rides to the kernel as a scalar argument — no
            # (B, n) penalty field is read.
            x, _ = pn_fused.pn_tv1_fused(y, lam_scalar=float(lam),
                                         return_dual=False, tol_eps=tol_eps)
            return x
        lamv = _edge_weights(lam, B, n, y.dtype, y.device)
        lam_full = torch.cat([lamv, y.new_zeros((B, 1))], dim=-1)
        x, _ = pn_fused.pn_tv1_fused(y, lam_full, return_dual=False,
                                     tol_eps=tol_eps)
        return x
    # the CPU, past B1's lane limit, or a float64 batch on the card
    x, _ = tv1_pn(y, lam, cfg=cfg)
    return x
