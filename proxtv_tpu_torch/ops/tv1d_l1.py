"""Batched 1D TV-L1 proximity solver: projected Newton (port of
``proxtv_tpu.ops.tv1d_l1``, the PN engine and the method routing).

Solves, for every signal in a batch,

    min_x 0.5 ||x - y||^2 + sum_i w_i |x_{i+1} - x_i|

with scalar or per-edge weights.

*   :func:`tv1_pn` — projected Newton on the dual box-constrained QP
    (reference ``src/TVL1opt.cpp:37`` ``PN_TV1`` and ``src/TVL1Wopt.cpp:37``
    ``PN_TV1_Weighted``).  The inactive-set Newton system is solved at full
    size by *masked* parallel cyclic reduction (active rows become identity
    rows), batched over signals.  On a CUDA batch its tridiagonal solves
    run kernel B2 (float32 only).
*   :func:`tv1_batched` — reference-compatible method names.  On a CUDA
    float32 batch every method runs the projected-Newton kernel B1
    (:mod:`.kernels.pn_fused`) up to its lane limit, :func:`tv1_pn` past
    it.

The direct engines of the JAX package (taut string, Condat, message passing,
classic taut string) are not ported yet (ROADMAP A8): a strict call that names
one raises ``NotImplementedError``.
"""
from __future__ import annotations

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
# Method dispatch (mirrors the reference Python method table,
# prox_tv/__init__.py:163-172)
# ---------------------------------------------------------------------------

_SCAN_METHODS = {"classictautstring", "linearizedtautstring",
                 "hybridtautstring", "condattautstring", "tautstring"}
_DIRECT_METHODS = _SCAN_METHODS | {"condat", "dp", "kolmogorov", "johnson"}


def tv1_batched(y, lam, method: str = "hybridtautstring",
                cfg: TV1Config = DEFAULT_TV1, strict: bool = False):
    """Batched 1D TV-L1 prox with reference-compatible method names.

    **Routing** (``strict``): with ``strict=False`` every method string runs
    projected Newton — all engines share one exact fixed point (the
    reference's tests assert cross-method equality, prox_tv_test.py:37-62).
    On a CUDA batch that is kernel B1 (the JAX package does the same on its
    accelerator, ``tv1d_l1.py:1186-1191``), which takes float32 and
    2 <= n <= 8192 or raises; past n = 8192, where the JAX package runs its
    taut string, and on the CPU, where it would run the named direct
    engine, it is :func:`tv1_pn` (the same fixed point).
    With ``strict=True`` a direct engine name raises ``NotImplementedError``:
    those engines are ROADMAP item A8.
    """
    method = method.lower()
    B, n = y.shape
    if method in ("classictautstring", "condat"):
        # Unweighted algorithms (one lambda per signal): strict raises on
        # per-edge weights, non-strict coerces, as in the JAX package.
        lam_a = torch.as_tensor(lam)
        per_edge_w = lam_a.ndim >= 2 or (lam_a.ndim == 1
                                         and lam_a.shape[0] == n - 1
                                         and B != n - 1)
        if per_edge_w:
            if strict:
                raise ValueError(
                    f"method={method!r} is unweighted (one lambda per "
                    "signal); use 'tautstring'/'pn'/'dp' for per-edge weights")
            method = "hybridtautstring"
    if method in _DIRECT_METHODS:
        if strict:
            raise NotImplementedError(
                f"method={method!r}: the direct 1D engines are not ported yet "
                "(ROADMAP A8); use method='pn'")
        method = "pn"
    if method != "pn":
        raise ValueError(f"Unknown TV-L1 method: {method!r}")
    from .kernels import gating

    if gating.gate(y, "pn"):
        from .kernels import pn_fused

        if torch.as_tensor(lam).ndim == 0:
            # Uniform penalty rides to the kernel as a scalar argument — no
            # (B, n) penalty field is read.
            x, _ = pn_fused.pn_tv1_fused(y, lam_scalar=float(lam),
                                         return_dual=False)
            return x
        lamv = _edge_weights(lam, B, n, y.dtype, y.device)
        lam_full = torch.cat([lamv, y.new_zeros((B, 1))], dim=-1)
        x, _ = pn_fused.pn_tv1_fused(y, lam_full, return_dual=False)
        return x
    x, _ = tv1_pn(y, lam, cfg=cfg)  # CPU, or past B1's lane limit
    return x
