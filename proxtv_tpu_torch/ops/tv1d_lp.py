"""Batched 1D TV-Lp proximity solvers for general p >= 1 (port of
``proxtv_tpu.ops.tv1d_lp``).

Solves, for every signal in a batch,

    min_x 0.5 ||x - y||^2 + lam ||D x||_p

via the dual ball-constrained quadratic

    min_{||w||_q <= lam} 0.5 w' DD' w - w' dy,      q = p/(p-1),

(reference ``src/TVLPopt.cpp``).  Engines:

*   :func:`tvp_gp` — projected gradient with step 1/L, L = 4 (reference
    ``GP_TVp`` :37).
*   :func:`tvp_ogp` — strongly-convex momentum with mu = 2 - 2 cos(pi/n)
    (reference ``OGP_TVp`` :295).
*   :func:`tvp_fista` — FISTA momentum over the projection (reference
    ``FISTA_TVp`` :583).
*   :func:`tvp_fw` — Frank-Wolfe with the closed-form Lp linear oracle and
    exact line search (reference ``FW_TVp`` :871).
*   :func:`tvp_gpfw` — the reference default hybrid: one GP step every
    ``cfg.fw_cycles`` FW steps; pure GP when p > ``cfg.p_gp_only``
    (reference ``GPFW_TVp`` :1111, fallback :1144-1145).  On a CUDA float32
    batch with q in [1.12, 3.1] (p ~ 1.47-9.3, p != 2) and 2 <= n <= 8192
    the whole dual loop is one launch of kernel B5
    (:mod:`.kernels.lp_fused`); elsewhere (a float64 CUDA batch among
    them) the torch composition runs, as the JAX package runs its XLA
    composition there.

The q-ball projection is :mod:`.lp`'s KKT root-find.  Closed-form exits
mirror the reference (``src/TVLPopt.cpp:1193-1219``): the unconstrained dual
(one tridiagonal solve, kernel B2 on the card up to n - 1 = 8192) is used
when it lies inside the ball (then x = mean(y)); p ~ 1 and p = 2 route to
the TV-L1 and TV-L2 engines.

The iteration loops are Python loops over masked per-row updates (a row
never restarts), so the host reads whether any row still runs only once
every ``cfg.fw_cycles`` iterations: the extra iterations are masked no-ops,
and the iteration cap is a host count, equal to the largest per-row count
while any row runs.
"""
from __future__ import annotations

import math

import torch

from ..utils import debug, diffs
from ..utils.config import DEFAULT_TVP, TVpConfig
from ..utils.info import RC_ITERS, RC_OK, make_info
from ..utils.lpnorms import P_LARGE, P_SMALL, lp_norm
from . import lp, tridiag
from .kernels import gating

_L_LIPSCHITZ = 4.0  # lambda_max(DD') < 4 (reference src/TVLPopt.cpp:45)


def _lam_vec(lam, B, dtype, device):
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    if lam.ndim == 0:
        return torch.broadcast_to(lam, (B,))
    return lam.reshape(B)


def _gap_tvp(w, g, lam, p):
    """Duality gap lam * ||g||_p + w'g (Holder; == 0 at the optimum), plus
    the magnitude of the two cancelling terms, which sets the gap's float32
    measurement floor."""
    tv = lam * lp_norm(g, p)
    cross = torch.sum(w * g, dim=-1)
    return torch.abs(tv + cross), tv + torch.abs(cross)


def _hess_mv(w):
    """DD' w as a stencil op."""
    return diffs.primal2grad(diffs.adjoint_diff(w))


def _tol_of(cfg, den, dtype):
    """Reference-parity stopping tolerance with a dtype-achievability floor
    scaled by the gap's own cancellation magnitude ``den``, shared by the
    projected-gradient and Frank-Wolfe drivers."""
    return torch.clamp(10.0 * torch.finfo(dtype).eps
                       * torch.clamp(den, min=1.0), min=cfg.stop)


def _common_setup(y, lam, p):
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    lamv = _lam_vec(lam, B, dtype, dev)
    # Center (translation equivariance; the dual is unchanged).
    ybar = torch.mean(y, dim=-1, keepdim=True)
    y = y - ybar
    dy = diffs.forward_diff(y)
    q = lp.dual_p(p)
    if n == 1:
        # No edges: the engines' n == 1 guards return at once.
        z0 = torch.zeros((B, 0), dtype=dtype, device=dev)
        return (y, ybar, B, n, dtype, lamv, z0, q, z0,
                torch.zeros((B,), dtype=torch.bool, device=dev), lamv <= 0)
    # Closed-form exit: unconstrained solution inside the ball -> x = mean.
    w0 = tridiag.spd_second_difference_solve(dy)
    interior = (lp_norm(w0, q) <= lamv) & (lamv > 0)
    zero_pen = lamv <= 0
    return y, ybar, B, n, dtype, lamv, dy, q, w0, interior, zero_pen


def _finalize(y, ybar, w, lamv, p, interior, zero_pen, w0, iters, running):
    x = diffs.dual2primal(torch.where(interior[:, None], w0, w), y)
    x = torch.where(zero_pen[:, None], y, x)
    g = diffs.primal2grad(x)
    gap = torch.where(interior | zero_pen, torch.zeros_like(lamv),
                      _gap_tvp(w, g, lamv, p)[0])
    rc = torch.where(running & ~interior & ~zero_pen, RC_ITERS, RC_OK)
    return x + ybar, make_info(iters, gap, rc)


def _identity_n1(y, ybar, B, return_state):
    dev = y.device
    info1 = make_info(torch.zeros((B,), dtype=torch.int32, device=dev),
                      torch.zeros((B,), dtype=y.dtype, device=dev),
                      torch.zeros((B,), dtype=torch.int32, device=dev))
    if return_state:
        return y + ybar, info1, (y.new_zeros((B, 0)), y.new_ones((B,)))
    return y + ybar, info1


def _start(w0, lamv, q, w_init, mu_init, dtype):
    """Feasible start: the projected unconstrained dual, or a warm start."""
    if w_init is None:
        w_start, mu0 = lp.lp_ball_project_ws(w0, lamv, q, None)
    else:
        w_start, mu0 = lp.lp_ball_project_ws(
            torch.as_tensor(w_init, dtype=dtype, device=w0.device), lamv, q,
            mu_init)
    if mu0 is None:
        mu0 = torch.ones_like(lamv)
    return w_start, mu0


def _loop(body, state, running_of, cap, cadence):
    """Run ``body`` until no row runs or ``cap`` iterations, reading the
    running flags to the host once every ``cadence`` iterations."""
    it = 0
    while it < cap:
        if it % cadence == 0 and not debug.host(torch.any(running_of(state))):
            break
        state = body(state)
        it += 1
    return state


def _run_projected(y, lam, p, cfg, max_iters, momentum, w_init=None,
                   mu_init=None, return_state=False):
    """Shared driver for GP / OGP / FISTA: projected (momentum) gradient with
    per-row convergence masking.  ``w_init`` / ``mu_init`` /
    ``return_state``: dual + KKT-multiplier warm start threading for
    combiners."""
    (y, ybar, B, n, dtype, lamv, dy, q, w0, interior,
     zero_pen) = _common_setup(y, lam, p)
    if n == 1:
        return _identity_n1(y, ybar, B, return_state)
    cap = int(max_iters) if max_iters else cfg.max_iters
    step = 1.0 / _L_LIPSCHITZ

    if momentum == "ogp":
        # mu-strongly-convex momentum (reference OGP_TVp :436), mu the
        # smallest eigenvalue of the (n-1)-dim DD'.
        mu_sc = 2.0 - 2.0 * math.cos(math.pi / n)
        kappa = _L_LIPSCHITZ / mu_sc
        beta_const = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)

    def body(state):
        w, z, t, mu, gap, iters, running = state
        grad = _hess_mv(z) - dy
        # Warm-started projection: the KKT multiplier barely moves between
        # gradient steps (reference Workspace warm restart analog).
        w_new, mu_new = lp.lp_ball_project_ws(z - step * grad, lamv, q, mu)
        if momentum == "gp":
            z_new, t_new = w_new, t
        elif momentum == "ogp":
            z_new = w_new + beta_const * (w_new - w)
            t_new = t
        else:  # fista
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            z_new = w_new + ((t - 1.0) / t_new)[:, None] * (w_new - w)
        x = diffs.dual2primal(w_new, y)
        g = diffs.primal2grad(x)
        gap_new, den = _gap_tvp(w_new, g, lamv, p)

        r2 = running[:, None]
        w = torch.where(r2, w_new, w)
        z = torch.where(r2, z_new, z)
        t = torch.where(running, t_new, t)
        mu = torch.where(running, mu_new, mu)
        gap = torch.where(running, gap_new, gap)
        iters = iters + running.to(torch.int32)
        running = running & (gap > _tol_of(cfg, den, dtype))
        return w, z, t, mu, gap, iters, running

    w_start, mu0 = _start(w0, lamv, q, w_init, mu_init, dtype)
    x0 = diffs.dual2primal(w_start, y)
    gap0, den0 = _gap_tvp(w_start, diffs.primal2grad(x0), lamv, p)
    running0 = (gap0 > _tol_of(cfg, den0, dtype)) & ~interior & ~zero_pen
    t0 = torch.ones_like(lamv)
    iters0 = torch.zeros((B,), dtype=torch.int32, device=y.device)
    w, _, _, mu, gap, iters, running = _loop(
        body, (w_start, w_start, t0, mu0, gap0, iters0, running0),
        lambda s: s[-1], cap, cfg.fw_cycles)
    out = _finalize(y, ybar, w, lamv, p, interior, zero_pen, w0, iters,
                    running)
    if return_state:
        return out + ((w, mu),)
    return out


def tvp_gp(y, lam, p: float, cfg: TVpConfig = DEFAULT_TVP, max_iters: int = 0,
           w_init=None, mu_init=None, return_state: bool = False):
    """Projected-gradient TV-Lp prox (reference GP_TVp)."""
    return _run_projected(y, lam, p, cfg, max_iters, "gp", w_init=w_init,
                          mu_init=mu_init, return_state=return_state)


def tvp_ogp(y, lam, p: float, cfg: TVpConfig = DEFAULT_TVP, max_iters: int = 0):
    """Optimized (strongly-convex momentum) gradient TV-Lp prox (reference
    OGP_TVp)."""
    return _run_projected(y, lam, p, cfg, max_iters, "ogp")


def tvp_fista(y, lam, p: float, cfg: TVpConfig = DEFAULT_TVP,
              max_iters: int = 0):
    """FISTA TV-Lp prox (reference FISTA_TVp)."""
    return _run_projected(y, lam, p, cfg, max_iters, "fista")


def _fw_direction(w, grad, lamv, q):
    """Frank-Wolfe atom and exact line-search step for the dual quadratic."""
    s = lp.solve_linear_lp(grad, lamv, q)
    d = s - w
    num = -torch.sum(grad * d, dim=-1)
    den = torch.sum(d * _hess_mv(d), dim=-1)
    gamma = torch.where(
        den > 0,
        torch.clamp(num / torch.clamp(den, min=1e-300), min=0.0, max=1.0),
        torch.where(num > 0, torch.ones_like(num), torch.zeros_like(num)))
    return d, gamma, num


def _run_fw(y, lam, p: float, cfg: TVpConfig, max_iters: int, gp_every: int,
            w_init=None, mu_init=None, return_state: bool = False):
    """Shared FW / GPFW driver.  ``gp_every == 0`` -> pure FW; otherwise one
    GP step every ``gp_every`` iterations (reference FW_CYCLES_TVLP = 10).

    ``w_init`` / ``mu_init``: optional dual vector and KKT-multiplier warm
    starts; with ``return_state`` the final ``(w, mu)`` pair is appended to
    the return tuple."""
    (y, ybar, B, n, dtype, lamv, dy, q, w0, interior,
     zero_pen) = _common_setup(y, lam, p)
    if n == 1:
        return _identity_n1(y, ybar, B, return_state)
    cap = int(max_iters) if max_iters else cfg.max_iters_fw
    step = 1.0 / _L_LIPSCHITZ

    def body(state):
        w, mu, gap, iters, k, running = state
        grad = _hess_mv(w) - dy
        d, gamma, fw_gap = _fw_direction(w, grad, lamv, q)
        if gp_every and k % gp_every == 0:
            # The GP cycle index is a host count, so the FW cycles skip the
            # warm-started projection entirely (the reference projects
            # every FW_CYCLES_TVLP-th iteration, src/TVLPopt.cpp:1252).
            w_new, mu_new = lp.lp_ball_project_ws(w - step * grad, lamv, q, mu)
        else:
            w_new, mu_new = w + gamma[:, None] * d, mu
        x = diffs.dual2primal(w_new, y)
        g = diffs.primal2grad(x)
        gap_new, den = _gap_tvp(w_new, g, lamv, p)

        w = torch.where(running[:, None], w_new, w)
        mu = torch.where(running, mu_new, mu)
        gap = torch.where(running, gap_new, gap)
        iters = iters + running.to(torch.int32)
        # The FW duality gap (-grad'd) is also a certificate; stop on either.
        tol_i = _tol_of(cfg, den, dtype)
        running = running & (gap > tol_i) & (fw_gap > tol_i)
        return w, mu, gap, iters, k + 1, running

    w_start, mu0 = _start(w0, lamv, q, w_init, mu_init, dtype)
    x0 = diffs.dual2primal(w_start, y)
    gap0, den0 = _gap_tvp(w_start, diffs.primal2grad(x0), lamv, p)
    running0 = (gap0 > _tol_of(cfg, den0, dtype)) & ~interior & ~zero_pen
    iters0 = torch.zeros((B,), dtype=torch.int32, device=y.device)
    w, mu, gap, iters, _, running = _loop(
        body, (w_start, mu0, gap0, iters0, 1, running0), lambda s: s[-1],
        cap, cfg.fw_cycles)
    out = _finalize(y, ybar, w, lamv, p, interior, zero_pen, w0, iters,
                    running)
    if return_state:
        return out + ((w, mu),)
    return out


def tvp_fw(y, lam, p: float, cfg: TVpConfig = DEFAULT_TVP, max_iters: int = 0):
    """Frank-Wolfe TV-Lp prox (reference FW_TVp)."""
    return _run_fw(y, lam, p, cfg, max_iters, 0)


def _fused_lp_ok(y, p: float) -> bool:
    """Route the GPFW driver to kernel B5, decided by p, q and n before any
    launch: q = p/(p-1) inside the joint-KKT Newton's float32 range
    [1.12, 3.1] (p ~ 1.47-9.3, p != 2) and n >= 2.  Then ``gating.gate``:
    False on the CPU, for a float32 CUDA tensor with n > 8192 and for a
    float64 CUDA tensor (the JAX package's float64 route composes); on
    the card True, or it raises for a tensor the kernel cannot take
    (another dtype, the switch off)."""
    if p <= P_SMALL or p >= P_LARGE or p == 2.0:
        return False
    q = lp.dual_p(p)
    if not (1.12 <= q <= 3.1 and y.shape[-1] >= gating.lane_limits("lp")[0]):
        return False
    return gating.gate(y, "lp")


def _run_gpfw_fused(y, lam, p: float, cfg: TVpConfig, max_iters: int,
                    w_init=None, mu_init=None, return_state: bool = False):
    """GPFW driver with the iteration loop in kernel B5
    (:mod:`.kernels.lp_fused`): the exact setup and finalize (centering, the
    unconstrained tridiagonal dual, the interior / zero-penalty exits,
    primal reconstruction) stay torch ops; the many-iteration hybrid FW/GP
    loop is one launch.  Same stopping contract (Holder duality gap <=
    cfg.stop) as :func:`_run_fw`; iteration counts are reported at
    fw-cycle granularity."""
    from .kernels import lp_fused

    (y, ybar, B, n, dtype, lamv, dy, q, w0, interior,
     zero_pen) = _common_setup(y, lam, p)
    cap = int(max_iters) if max_iters else cfg.max_iters_fw
    w_start, mu0 = _start(w0, lamv, q, w_init, mu_init, dtype)
    run_mask = (~interior & ~zero_pen).to(dtype)
    w_pad = torch.cat([w_start, y.new_zeros((B, 1))], dim=-1)
    w_k, mu, _gap, it_f = lp_fused.gpfw_fused(
        y, w_pad, lamv, mu0, run_mask, p=p, max_iters=cap,
        fw_cycles=cfg.fw_cycles, stop_rel=cfg.stop)
    w = w_k[:, : n - 1]
    iters = torch.floor(it_f).to(torch.int32)
    running = (it_f - torch.floor(it_f)) > 0.25  # the still-running marker
    out = _finalize(y, ybar, w, lamv, p, interior, zero_pen, w0, iters,
                    running)
    if return_state:
        return out + ((w, mu),)
    return out


def tvp_gpfw(y, lam, p: float, cfg: TVpConfig = DEFAULT_TVP,
             max_iters: int = 0, w_init=None, mu_init=None,
             return_state: bool = False):
    """Hybrid GP+FW TV-Lp prox, the reference default (GPFW_TVp).

    Pure GP for p > cfg.p_gp_only (reference :1144-1145: the FW oracle's
    |g|^{p-1} powers are ill-conditioned at large p).  ``w_init`` /
    ``mu_init`` / ``return_state``: warm-start threading for combiners.
    Where :func:`_fused_lp_ok` holds, the whole loop is one launch of
    kernel B5."""
    if _fused_lp_ok(y, p):
        return _run_gpfw_fused(y, lam, p, cfg, max_iters, w_init=w_init,
                               mu_init=mu_init, return_state=return_state)
    if p > cfg.p_gp_only:
        return tvp_gp(y, lam, p, cfg=cfg, max_iters=max_iters, w_init=w_init,
                      mu_init=mu_init, return_state=return_state)
    return _run_fw(y, lam, p, cfg, max_iters, cfg.fw_cycles, w_init=w_init,
                   mu_init=mu_init, return_state=return_state)


def tvp_batched(y, lam, p: float, method: str = "gpfw",
                cfg: TVpConfig = DEFAULT_TVP, max_iters: int = 0):
    """Method dispatch mirroring the reference (prox_tv/__init__.py:311-352),
    with the p-degenerate regimes routed to the specialized engines.

    p <= 1.002 (the reference's L1 clamp): the taut string
    (``tv1d_l1.tv1_tautstring``, kernel D1 on the card), as in the JAX
    package, with its zero ``SolverInfo``."""
    p = float(p)
    if p <= P_SMALL:
        from . import tv1d_l1

        x = tv1d_l1.tv1_tautstring(y, lam)
        B = x.shape[0]
        zi = torch.zeros((B,), dtype=torch.int32, device=x.device)
        return x, make_info(zi, torch.zeros((B,), dtype=x.dtype,
                                            device=x.device), zi)
    if p == 2.0:
        from . import tv1d_l2

        return tv1d_l2.tv2_ms(y, lam)
    method = method.lower()
    if method == "gp":
        return tvp_gp(y, lam, p, cfg=cfg, max_iters=max_iters)
    if method == "ogp":
        return tvp_ogp(y, lam, p, cfg=cfg, max_iters=max_iters)
    if method == "fista":
        return tvp_fista(y, lam, p, cfg=cfg, max_iters=max_iters)
    if method == "fw":
        return tvp_fw(y, lam, p, cfg=cfg, max_iters=max_iters)
    if method == "gpfw":
        return tvp_gpfw(y, lam, p, cfg=cfg, max_iters=max_iters)
    raise ValueError(f"Unknown TV-Lp method: {method!r}")
