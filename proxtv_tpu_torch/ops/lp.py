"""Lp-norm primitives: ball projections, proxes and the linear oracle (port of
``proxtv_tpu.ops.lp``).

Covers the capability set of reference ``src/LPopt.cpp``: ``LPnorm``
(:mod:`proxtv_tpu_torch.utils.lpnorms`), the norm proxes, the ball
projections and ``solveLinearLP`` (the Frank-Wolfe linear oracle).

The primitive is the ball projection, computed as a monotone root-find on the
KKT system, every step a full-width tensor op:

    proj onto {||x||_p <= R}:  |x_i| + mu * p * |x_i|^{p-1} = |y_i|,
    with the scalar mu >= 0 chosen so ||x||_p = R.

A joint primal-dual Newton on that system is the fast path; lanes whose KKT
residuals fail its acceptance test take the nested root-find (safeguarded
Newton on mu around per-coordinate safeguarded Newton), which always
converges.  The general prox follows by Moreau: prox_{t||.||_p}(y) =
y - proj_{||.||_q <= t}(y), q = p/(p-1).  Degenerate regimes follow the
reference's clamping (``src/LPopt.h:33-36``): p <= 1.002 -> L1, p >= 100 ->
Linf.

This module holds no kernel: it runs as torch ops on both devices, as the
JAX package's XLA code does on its accelerator.  The one data-dependent
branch (accept the joint pass, or merge in the nested root-find) reads one
flag to the host.
"""
from __future__ import annotations

import torch

from ..utils import debug
from ..utils.lpnorms import P_LARGE, P_SMALL, lp_norm

_BRACKET_STEPS = 60


def _bisect_steps(dtype):
    """(outer_bisect, outer_newton, inner_bisect, inner_newton) depths of
    the nested root-find."""
    if dtype == torch.float32:
        return 10, 6, 12, 5
    return 16, 8, 18, 7


def dual_p(p: float) -> float:
    """Holder conjugate exponent q = p/(p-1), with the inf/1 limits."""
    if p <= P_SMALL:
        return float("inf")
    if p >= P_LARGE:
        return 1.0
    return p / (p - 1.0)


def _rows(R, y):
    """Radius as a tensor of y's dtype and device, one per row of y."""
    R = torch.as_tensor(R, dtype=y.dtype, device=y.device)
    return torch.broadcast_to(R, y.shape[:-1])


# ---------------------------------------------------------------------------
# Closed-form special cases
# ---------------------------------------------------------------------------


def linf_ball_project(y, R):
    """Projection onto {||x||_inf <= R}: elementwise clip."""
    Rb = _rows(R, y)[..., None]
    return torch.clamp(y, min=-Rb, max=Rb)


def l2_ball_project(y, R):
    """Radial shrink onto {||x||_2 <= R} (reference PN_LP2 via Moreau)."""
    R = _rows(R, y)
    nrm = torch.linalg.vector_norm(y, dim=-1)
    scale = torch.where(nrm > R, R / torch.clamp(nrm, min=1e-300),
                        torch.ones_like(nrm))
    return y * scale[..., None]


def l1_ball_project(y, R):
    """Sort-based projection onto {||x||_1 <= R} (Duchi et al.; reference
    ``LP1_project``, src/LPopt.cpp:804), batched on the last axis."""
    R = _rows(R, y)
    a = torch.abs(y)
    inside = torch.sum(a, dim=-1) <= R
    s = torch.sort(a, dim=-1, descending=True).values
    cs = torch.cumsum(s, dim=-1)
    k = torch.arange(1, y.shape[-1] + 1, dtype=y.dtype, device=y.device)
    cand = (cs - R[..., None]) / k
    ok = s - cand > 0
    # Largest k with s_k > theta_k.  rho >= 1 holds for R > 0; at R == 0 no
    # candidate passes and the -1 would wrap to the last element: clamp to 0,
    # where theta = max|y| shrinks everything to the (correct) zero vector.
    rho = torch.clamp(torch.sum(ok, dim=-1) - 1, min=0)
    theta = torch.gather(cand, -1, rho[..., None])
    theta = torch.clamp(theta, min=0.0)
    x = torch.sign(y) * torch.clamp(a - theta, min=0.0)
    return torch.where(inside[..., None], y, x)


def soft_threshold(y, t):
    """Prox of t||.||_1 (reference PN_LP1, src/LPopt.cpp:95)."""
    tb = _rows(t, y)[..., None]
    return torch.sign(y) * torch.clamp(torch.abs(y) - tb, min=0.0)


# ---------------------------------------------------------------------------
# General-p ball projection: monotone KKT root-find
# ---------------------------------------------------------------------------


def _coord_root(a, mu, p, bisect_steps, newton_steps):
    """Solve s + mu*p*s^(p-1) = a for s in [0, a], elementwise (a >= 0,
    mu >= 0): bracketed bisection to localize, then safeguarded Newton inside
    the bracket (pure Newton's derivative blows up at s -> 0 for p < 2)."""

    def f(s):
        return s + mu * p * s ** (p - 1.0) - a

    lo, hi = torch.zeros_like(a), a
    for _ in range(bisect_steps):
        mid = 0.5 * (lo + hi)
        pos = f(mid) > 0
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)

    s = 0.5 * (lo + hi)
    for _ in range(newton_steps):
        fv = f(s)
        fp = 1.0 + mu * p * (p - 1.0) * s ** (p - 2.0)
        s_new = s - fv / fp
        # Safeguard: fall back to the bracket midpoint when Newton escapes.
        bad = ~((s_new > lo) & (s_new < hi)) | ~torch.isfinite(s_new)
        s_new = torch.where(bad, 0.5 * (lo + hi), s_new)
        pos = f(s_new) > 0
        lo = torch.where(pos, lo, s_new)
        hi = torch.where(pos, s_new, hi)
        s = s_new
    return 0.5 * (lo + hi)


def _joint_kkt_newton(an, Rn, T, p: float, mu_init, iters: int):
    """Joint primal-dual Newton on the full projection KKT system

        s_i + mu * p * s_i^{p-1} = an_i   (i = 1..n),    sum_i s_i^p = T,

    for normalized data ``an`` (row-max 1) strictly outside the ball.  The
    Jacobian is diagonal-plus-border, so each Newton step is closed form:

        ds_i = -(F_i + r_i dmu) / d_i,
        dmu  = (G - sum r F / d) / sum r^2 / d,       r_i = p s_i^{p-1},
        d_i  = 1 + mu p (p-1) s_i^{p-2}.

    For p < 2 it iterates in u = s^{p-1}, where the Jacobian stays bounded
    at s -> 0.  Returns (s, mu, max|F|, |G|) for the caller's acceptance
    test."""
    pos = an > 0
    nrm = torch.sum(an ** p, dim=-1) ** (1.0 / p)
    fac0 = Rn / torch.clamp(nrm, min=1e-300)
    s0 = an * fac0[..., None]
    if mu_init is None:
        # mu consistent with the largest coordinate (an = 1 there):
        # 1 - fac0 = mu p fac0^{p-1}.
        mu = (1.0 - fac0) / torch.clamp(p * fac0 ** (p - 1.0), min=1e-300)
    else:
        mu = torch.clamp(torch.as_tensor(mu_init, dtype=an.dtype,
                                         device=an.device), min=1e-30)

    zero = torch.zeros_like(an)
    if p >= 2.0:
        s = s0
        for _ in range(iters):
            sp1 = s ** (p - 1.0)
            F = s + mu[..., None] * p * sp1 - an
            G = torch.sum(s * sp1, dim=-1) - T
            d = 1.0 + mu[..., None] * p * (p - 1.0) * s ** (p - 2.0)
            r = p * sp1
            rod = r / d
            A = torch.sum(rod * F, dim=-1)
            Bq = torch.sum(rod * r, dim=-1)
            dmu = (G - A) / torch.clamp(Bq, min=1e-300)
            mu_new = torch.clamp(mu + dmu, min=0.0)
            ds = -(F + r * dmu[..., None]) / d
            # Keep s in (0, an]: s = 0 with an > 0 would pin the coordinate.
            s_new = torch.minimum(torch.clamp(s + ds, min=1e-20), an)
            s = torch.where(pos, s_new, zero)
            mu = mu_new
    else:
        rr = 1.0 / (p - 1.0)
        u_hi = an ** (p - 1.0)
        u = s0 ** (p - 1.0)
        for _ in range(iters):
            F = u ** rr + mu[..., None] * p * u - an
            G = torch.sum(u ** (rr * p), dim=-1) - T
            d = rr * u ** (rr - 1.0) + mu[..., None] * p
            g = (rr * p) * u ** (rr * p - 1.0)
            pu = p * u
            A = torch.sum(g * F / d, dim=-1)
            Bq = torch.sum(g * pu / d, dim=-1)
            dmu = (G - A) / torch.clamp(Bq, min=1e-300)
            mu_new = torch.clamp(mu + dmu, min=0.0)
            du = -(F + pu * dmu[..., None]) / d
            u_new = torch.minimum(torch.clamp(u + du, min=1e-30), u_hi)
            u = torch.where(pos, u_new, zero)
            mu = mu_new
        s = u ** rr

    sp1 = s ** (p - 1.0)
    F = torch.where(pos, s + mu[..., None] * p * sp1 - an, zero)
    G = torch.sum(s * sp1, dim=-1) - T
    return s, mu, torch.amax(torch.abs(F), dim=-1), torch.abs(G)


def _finite_mu(mu, mu0):
    """The multiplier with non-finite lanes replaced by the warm start (1
    cold).  A zero row lies inside every ball, and its joint Newton starts
    from 0 * inf: the JAX package returns mu = NaN there, which poisons the
    next warm-started projection of that row (ROADMAP C).  Finite lanes are
    untouched."""
    keep = torch.ones_like(mu) if mu0 is None else torch.as_tensor(
        mu0, dtype=mu.dtype, device=mu.device).expand_as(mu)
    return torch.where(torch.isfinite(mu), mu, keep)


def _lp_ball_project_general(y, R, p: float, mu0=None):
    """Projection onto {||x||_p <= R} for p in (1.002, 100), batched; returns
    (x, mu).

    Fast path: :func:`_joint_kkt_newton`, gated to the p range where every
    lane converges — [1.05, 3.6] in float64, [1.12, 3.1] in float32.  Lanes
    whose KKT residuals fail the acceptance test take the nested root-find's
    answer (:func:`_lp_ball_project_nested`); whether any lane failed is one
    host read (the JAX package's ``lax.cond``), so the gate only avoids
    wasted work, never correctness."""
    lo, hi = (1.05, 3.6) if y.dtype == torch.float64 else (1.12, 3.1)
    if not (lo <= p <= hi):
        x, mu = _lp_ball_project_nested(y, R, p, mu0)
        return x, _finite_mu(mu, mu0)
    a = torch.abs(y)
    R = _rows(R, y)
    nrm = lp_norm(a, p)
    inside = nrm <= R
    pos_R = R > 0

    scale = torch.clamp(torch.amax(a, dim=-1), min=1e-300)
    an = a / scale[..., None]
    Rn = R / scale
    T = Rn ** p

    iters = 8 if y.dtype == torch.float32 else 14
    s, mu, Fres, Gres = _joint_kkt_newton(an, Rn, T, p, mu0, iters)
    eps = torch.finfo(y.dtype).eps
    ok = (((Fres <= 64.0 * eps) & (Gres <= 64.0 * eps * torch.clamp(T, min=1.0)))
          | inside | ~pos_R)

    fac = torch.clamp(Rn / torch.clamp(torch.sum(s ** p, dim=-1) ** (1.0 / p),
                                       min=1e-300), max=1.0)
    x_joint = torch.sign(y) * s * (fac * scale)[..., None]
    x_joint = torch.where(pos_R[..., None], x_joint, torch.zeros_like(x_joint))
    x_joint = torch.where(inside[..., None], y, x_joint)
    if debug.host(torch.all(ok)):
        return x_joint, _finite_mu(mu, mu0)
    # Per-lane merge: lanes whose joint residuals passed keep the joint
    # result; only the rejected lanes take the nested root-find's answer.
    x_n, mu_n = _lp_ball_project_nested(y, R, p, mu0)
    return (torch.where(ok[..., None], x_joint, x_n),
            _finite_mu(torch.where(ok, mu, mu_n), mu0))


def _lp_ball_project_nested(y, R, p: float, mu0=None):
    """Nested monotone root-find projection onto {||x||_p <= R}, the joint
    Newton's fallback; returns (x, mu).

    Outer safeguarded root-find on the KKT multiplier mu
    (G(mu) = ||x(mu)||_p^p - R^p is strictly decreasing); inner
    per-coordinate Newton (:func:`_coord_root`).  ``mu0``: optional warm
    start for mu, which replaces the cold bracket and bisection with a few
    expansion / shrink checks."""
    a = torch.abs(y)
    R = _rows(R, y)
    nrm = lp_norm(a, p)
    inside = nrm <= R
    pos_R = R > 0

    # Work in a normalized scale to keep powers tame: divide by max|y|.
    scale = torch.clamp(torch.amax(a, dim=-1), min=1e-300)
    an = a / scale[..., None]
    Rn = R / scale
    T = Rn ** p

    ob, on, ib, inw = _bisect_steps(y.dtype)

    def norm_pp(mu):
        s = _coord_root(an, mu[..., None], p, ib, inw)
        return torch.sum(s ** p, dim=-1), s

    # Safeguarded Newton on G(mu) = sum s(mu)^p - R^p inside a bracket.
    # ds/dmu = -p*s / (s^(2-p) + mu*p*(p-1)) (algebraic form stable at s -> 0).
    def newton_body(lo, hi, mu):
        g, s = norm_pp(mu)
        mub = mu[..., None]
        dsd = -p * s / (s ** (2.0 - p) + mub * p * (p - 1.0) + 1e-300)
        dG = torch.sum(p * s ** (p - 1.0) * dsd, dim=-1)
        mu_new = mu - (g - T) / torch.clamp(dG, max=-1e-300)
        bad = ~((mu_new > lo) & (mu_new < hi)) | ~torch.isfinite(mu_new)
        mu_new = torch.where(bad, 0.5 * (lo + hi), mu_new)
        g2, _ = norm_pp(mu_new)
        too_big = g2 > T
        lo = torch.where(too_big, mu_new, lo)
        hi = torch.where(too_big, hi, mu_new)
        return lo, hi, mu_new

    if mu0 is None:
        # Cold start: bracket by quadrupling, bisect, then Newton.
        hi = torch.ones_like(Rn)
        done = torch.zeros(Rn.shape, dtype=torch.bool, device=Rn.device)
        for _ in range(_BRACKET_STEPS // 2):
            g, _ = norm_pp(hi)
            need = ~done & (g > T)
            hi = torch.where(need, hi * 4.0, hi)
            done = done | ~need
        lo = torch.zeros_like(hi)
        for _ in range(ob):
            mid = 0.5 * (lo + hi)
            g, _ = norm_pp(mid)
            too_big = g > T
            lo = torch.where(too_big, mid, lo)
            hi = torch.where(too_big, hi, mid)
        mu = 0.5 * (lo + hi)
        for _ in range(-(-on // 2)):
            lo, hi, mu = newton_body(lo, hi, mu)
    else:
        # Warm start: G(0) >= T always holds outside the ball, so lo = 0 is a
        # valid lower end; the upper end is adapted both ways around mu0.
        mu_w = torch.clamp(torch.as_tensor(mu0, dtype=y.dtype,
                                           device=y.device), min=1e-30)
        hi = 2.0 * mu_w
        for _ in range(3):
            g, _ = norm_pp(hi)
            hi = torch.where(g > T, hi * 16.0, hi)
        for _ in range(3):
            g, _ = norm_pp(hi * 0.0625)
            hi = torch.where(g <= T, hi * 0.0625, hi)
        lo = torch.zeros_like(hi)
        mu = torch.clamp(mu_w, min=lo, max=hi)
        for _ in range(on):
            lo, hi, mu = newton_body(lo, hi, mu)

    # Evaluate at the Newton iterate and clamp radially to exact
    # feasibility: the returned point always satisfies ||x||_p <= R.
    g_fin, s = norm_pp(mu)
    fac = torch.clamp(Rn / torch.clamp(g_fin ** (1.0 / p), min=1e-300),
                      max=1.0)
    x = torch.sign(y) * s * (fac * scale)[..., None]
    x = torch.where(pos_R[..., None], x, torch.zeros_like(x))
    return torch.where(inside[..., None], y, x), mu


def lp_ball_project(y, R, p: float):
    """Projection onto {||x||_p <= R} with the reference's p-clamping
    (reference LPp_project, src/LPopt.cpp:888)."""
    if p <= P_SMALL:
        return l1_ball_project(y, R)
    if p >= P_LARGE:
        return linf_ball_project(y, R)
    if p == 2.0:
        return l2_ball_project(y, R)
    return _lp_ball_project_general(y, R, p)[0]


def lp_ball_project_ws(y, R, p: float, mu0):
    """Warm-started projection: returns (x, mu) threading the KKT multiplier
    across calls.  Closed-form regimes pass mu through untouched."""
    if p <= P_SMALL:
        return l1_ball_project(y, R), mu0
    if p >= P_LARGE:
        return linf_ball_project(y, R), mu0
    if p == 2.0:
        return l2_ball_project(y, R), mu0
    return _lp_ball_project_general(y, R, p, mu0)


def lp_prox(y, t, p: float):
    """Prox of t*||.||_p via Moreau: y - proj_{||.||_q <= t}(y), q = p/(p-1)
    (reference PN_LPp, src/LPopt.cpp:212)."""
    if p <= P_SMALL:
        return soft_threshold(y, t)
    if p >= P_LARGE:
        # prox of t*||.||_inf = y - proj onto the L1 ball of radius t.
        return y - l1_ball_project(y, t)
    if p == 2.0:
        return y - l2_ball_project(y, t)
    return y - lp_ball_project(y, t, dual_p(p))


def solve_linear_lp(g, R, p: float):
    """Linear oracle: argmin_{||s||_p <= R} s'g (reference solveLinearLP,
    src/LPopt.cpp:1000).  Closed form via Holder equality: the minimizer is
    -R * sign(g) |g|^{q-1} / ||g||_q^{q-1} with q = p/(p-1); for p = 1 a
    signed vertex at the max-|g| coordinate; for p = inf the sign vector."""
    R = _rows(R, g)[..., None]
    if p <= P_SMALL:
        idx = torch.argmax(torch.abs(g), dim=-1, keepdim=True)
        val = torch.gather(g, -1, idx)
        onehot = torch.arange(g.shape[-1], device=g.device) == idx
        return torch.where(onehot, -R * torch.sign(val), torch.zeros_like(g))
    if p >= P_LARGE:
        return -R * torch.sign(g)
    q = dual_p(p)
    ag = torch.abs(g)
    mx = torch.clamp(torch.amax(ag, dim=-1, keepdim=True), min=1e-300)
    r = ag / mx
    num = r ** (q - 1.0)
    den = torch.clamp(torch.sum(r ** q, dim=-1, keepdim=True)
                      ** ((q - 1.0) / q), min=1e-300)
    return -R * torch.sign(g) * num / den
