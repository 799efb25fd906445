"""Kernel B5: the whole GPFW TV-Lp dual loop per fiber.

For each row y of a (B, n) batch of CENTERED signals it runs the hybrid
projected-gradient / Frank-Wolfe dual solve of

    min_{||w||_q <= lam} 0.5 w' DD' w - w' dy,      q = p/(p-1),

(reference ``GPFW_TVp``, src/TVLPopt.cpp:1111): per trip one
projected-gradient step (step 1/4) with the q-ball projection by
``newton_iters`` joint-KKT Newton steps and a radial clamp, then
``fw_cycles - 1`` Frank-Wolfe steps (closed-form Lp linear oracle, exact line
search), then the Holder duality gap ``|lam ||g||_p + w'g|`` and its stop
test ``gap > max(stop_rel, 10 eps max(1, den))``.

Replaces the TPU kernel ``proxtv_tpu/ops/kernels/lp_fused.py:gpfw_fused``;
the CUDA source is ``proxtv_tpu_torch/csrc/lp_fused.cu``.  Device traffic is
one read of (y, w0, lam, mu0, run_mask) and one write of (w, mu, gap, iters)
for the whole solve.

:func:`gpfw_fused` launches the kernel for a CUDA tensor and runs
:func:`gpfw_fused_plain` for a CPU tensor; :func:`bind` makes its C call
once, for tools that time the kernel alone.  The kernel runs a fiber on one
warp for n <= 256 (four fibers a block) and on a block of up to 16 warps
above, each lane holding a chunk of the row in registers; every row-wide
reduction crosses the warps once (one barrier), carrying its sums, a
(max, power sum) pair and the chunk edges it needs together.  The plain
version repeats the TPU kernel's arithmetic on tensors, its strength-reduced
powers included (:func:`_spow`), and takes its ``tb``: the TPU kernel loops
while any row of its tile runs and the tile's largest iteration count is
under the cap, with every update masked per row, so every ``tb`` gives the
per-fiber result; ``tb = 1`` is the CUDA kernel's loop and the TPU's ``tb``
reproduces its tiles.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.debug import Counter
from . import build
from .common import pad_rows
from .common import shift_left as _shift_left
from .common import shift_right as _shift_right
from .gating import lane_limits

LAUNCHES = Counter()
_TINY = 1e-30
_STEP = 0.25  # 1/L, L = 4 > lambda_max(DD') (src/TVLPopt.cpp:45)


def _spow(x, e: float):
    """``x ** e`` for x >= 0 with a host exponent, strength-reduced to a
    multiply / sqrt chain when e is an integer or half-integer in (0, 8]
    (the TPU kernel's ``_spow``, ``lp_fused.py:45-72``; the CUDA kernel
    evaluates the same chains)."""
    e = float(e)
    if e == 0.0:
        return torch.ones_like(x)
    if e == 1.0:
        return x
    if not (0.0 < e <= 8.0) or 2.0 * e != round(2.0 * e):
        return x ** e
    k = int(round(2.0 * e))  # e = k / 2
    acc = None
    base = x
    m = k // 2
    while m:  # square-and-multiply for the integer part
        if m & 1:
            acc = base if acc is None else acc * base
        m >>= 1
        if m:
            base = base * base
    if k % 2:
        s = torch.sqrt(x)
        acc = s if acc is None else acc * s
    return acc


def _pow_code(e: float) -> int:
    """How the CUDA kernel evaluates ``_spow(x, e)``: 0 -> ones, -1 ->
    ``powf``, k > 0 -> the chain for e = k / 2."""
    e = float(e)
    if e == 0.0:
        return 0
    if not (0.0 < e <= 8.0) or 2.0 * e != round(2.0 * e):
        return -1
    return int(round(2.0 * e))


def exponents(p: float):
    """The kernel's exponents, computed on the host in float64 as the TPU
    kernel computes them, in the order of ``csrc/lp_fused.cu``'s ``Pw``
    slots: q, 1/q, q-1, q-2, rr, rr q, rr-1, rr q-1 (rr = 1/(q-1)), p, 1/p,
    qq-1, qq, (qq-1)/qq (qq = q/(q-1), the oracle's exponent)."""
    q = p / (p - 1.0)
    rr = 1.0 / (q - 1.0)
    qq = q / (q - 1.0)
    return (q, 1.0 / q, q - 1.0, q - 2.0, rr, rr * q, rr - 1.0, rr * q - 1.0,
            p, 1.0 / p, qq - 1.0, qq, (qq - 1.0) / qq)


@functools.lru_cache(maxsize=16)
def _pow_args(p: float):
    """The C call's host arrays for p: the 13 exponents and their codes."""
    exps = exponents(p)
    return ((ctypes.c_float * len(exps))(*exps),
            (ctypes.c_int * len(exps))(*[_pow_code(e) for e in exps]),
            int(exps[0] >= 2.0))


def _rowsum(x):
    return torch.sum(x, dim=-1, keepdim=True)


def _rowmax(x):
    return torch.amax(x, dim=-1, keepdim=True)


def _tile_max(a, tb):
    """(Bp, 1) per-row values -> per-tile max, broadcast back to (Bp, 1)."""
    t = a.reshape(-1, tb).amax(dim=1, keepdim=True)
    return t.expand(-1, tb).reshape(-1, 1)


def _joint_newton_rows(an, Rn, T, q: float, mu, iters: int, nrm):
    """Joint primal-dual Newton for the q-ball projection KKT system on
    (rows, n) with (rows, 1) row scalars (``lp_fused.py:85-137``; the
    u-substitution for q < 2).  ``nrm`` is ``_spow(rowsum(_spow(an, q)),
    1/q)``, shared with the caller."""
    pos = an > 0
    zero = torch.zeros_like(an)
    fac0 = Rn / torch.clamp(nrm, min=_TINY)
    if q >= 2.0:
        s = an * fac0
        for _ in range(iters):
            sq1 = _spow(s, q - 1.0)
            F = s + mu * q * sq1 - an
            G = _rowsum(s * sq1) - T
            d = 1.0 + mu * q * (q - 1.0) * _spow(s, q - 2.0)
            r = q * sq1
            rod = r / d
            A = _rowsum(rod * F)
            Bq = _rowsum(rod * r)
            dmu = (G - A) / torch.clamp(Bq, min=_TINY)
            mu_new = torch.clamp(mu + dmu, min=0.0)
            ds = -(F + r * dmu) / d
            s = torch.where(pos, torch.minimum(torch.clamp(s + ds, min=1e-20),
                                               an), zero)
            mu = mu_new
        return s, mu
    rr = 1.0 / (q - 1.0)
    u_hi = _spow(an, q - 1.0)  # loop-invariant clip ceiling
    u = _spow(an * fac0, q - 1.0)
    for _ in range(iters):
        F = _spow(u, rr) + mu * q * u - an
        G = _rowsum(_spow(u, rr * q)) - T
        d = rr * _spow(u, rr - 1.0) + mu * q
        g = (rr * q) * _spow(u, rr * q - 1.0)
        qu = q * u
        A = _rowsum(g * F / d)
        Bq = _rowsum(g * qu / d)
        dmu = (G - A) / torch.clamp(Bq, min=_TINY)
        mu_new = torch.clamp(mu + dmu, min=0.0)
        du = -(F + qu * dmu) / d
        u = torch.where(pos, torch.minimum(torch.clamp(u + du, min=_TINY),
                                           u_hi), zero)
        mu = mu_new
    return _spow(u, rr), mu


def gpfw_fused_plain(y, w0, lam, mu0, run_mask, p: float, max_iters: int,
                     fw_cycles: int = 10, stop_rel: float = 1e-5,
                     newton_iters: int = 8, tb: int = 1):
    """The TPU kernel's arithmetic (``lp_fused.py:140-261``) on tensors,
    with its loop condition taken per tile of ``tb`` rows.  Arguments and
    returns as :func:`gpfw_fused`."""
    B, n = y.shape
    dtype, dev = y.dtype, y.device
    q = p / (p - 1.0)
    qq = q / (q - 1.0)
    yp = pad_rows(y, tb)
    Bp = yp.shape[0]
    v = (torch.arange(n, device=dev) < n - 1).to(dtype).expand(Bp, n)

    def rows(a):
        a = torch.broadcast_to(torch.as_tensor(a, dtype=dtype, device=dev)
                               .reshape(-1), (B,))
        return pad_rows(a.reshape(B, 1), tb)

    lam = rows(lam)
    run_mask = rows(run_mask)
    w = pad_rows(w0.to(dtype), tb) * v
    mu = torch.clamp(rows(mu0), min=_TINY)
    eps = torch.finfo(dtype).eps

    def primal(w):
        return yp + (w - _shift_right(w, 1, 0.0))

    def grad(x):
        return (x - _shift_left(x, 1, 0.0)) * v

    def gap_of(w, g):
        ag = torch.abs(g)
        mx = torch.clamp(_rowmax(ag), min=_TINY)
        tv = lam * mx * _spow(_rowsum(_spow(ag / mx, p)), 1.0 / p)
        cross = _rowsum(w * g)
        return torch.abs(tv + cross), tv + torch.abs(cross)

    def tol_of(den):
        return torch.clamp(10.0 * eps * torch.clamp(den, min=1.0),
                           min=stop_rel)

    def project(z, mu):
        """q-ball projection of z (radius lam), warm KKT multiplier."""
        a = torch.abs(z) * v
        mx = torch.clamp(_rowmax(a), min=_TINY)
        sq = _rowsum(_spow(a / mx, q))
        nrm = mx * _spow(sq, 1.0 / q)
        inside = nrm <= lam
        scale = mx
        an = a / scale
        Rn = lam / scale
        T = _spow(Rn, q)
        s, mu_new = _joint_newton_rows(an, Rn, T, q, mu, newton_iters,
                                       _spow(sq, 1.0 / q))
        # Radial clamp to exact feasibility: if a row's Newton missed, the
        # iterate stays feasible and the gap certificate stays truthful.
        snrm = _spow(_rowsum(_spow(s, q)), 1.0 / q)
        fac = torch.clamp(Rn / torch.clamp(snrm, min=_TINY), max=1.0)
        x = torch.sign(z) * s * fac * scale
        return torch.where(inside, z, x) * v, torch.where(inside, mu, mu_new)

    def fw_step(w):
        g = grad(primal(w))
        # Linear oracle over the q-ball: exponent qq = q/(q-1) (= p).
        ag = torch.abs(g)
        mx = torch.clamp(_rowmax(ag), min=_TINY)
        r = ag / mx
        s = -lam * torch.sign(g) * _spow(r, qq - 1.0) / torch.clamp(
            _spow(_rowsum(_spow(r, qq)), (qq - 1.0) / qq), min=_TINY)
        d = (s - w) * v
        ad = d - _shift_right(d, 1, 0.0)
        Hd = (ad - _shift_left(ad, 1, 0.0)) * v
        num = -_rowsum(g * d)
        den = _rowsum(d * Hd)
        one, zero = torch.ones_like(num), torch.zeros_like(num)
        gamma = torch.where(den > 0,
                            torch.clamp(num / torch.clamp(den, min=_TINY),
                                        min=0.0, max=1.0),
                            torch.where(num > 0, one, zero))
        return w + gamma * d

    g = grad(primal(w))
    gap, den = gap_of(w, g)
    running = run_mask * (gap > tol_of(den)).to(dtype)
    it = torch.zeros_like(gap)
    max_trips = -(-int(max_iters) // fw_cycles)
    cap = float(max_trips * fw_cycles)
    while True:
        go = (_tile_max(running, tb) > 0) & (_tile_max(it, tb) < cap)
        if not bool(go.any()):
            break
        act = running * go.to(dtype)
        on = act > 0
        g = grad(primal(w))
        w_gp, mu_gp = project(w - _STEP * g, mu)
        w = torch.where(on, w_gp, w)
        mu = torch.where(on, mu_gp, mu)
        for _ in range(fw_cycles - 1):
            w = torch.where(on, fw_step(w), w)
        g = grad(primal(w))
        gap_new, den = gap_of(w, g)
        it = it + float(fw_cycles) * act
        gap = torch.where(on, gap_new, gap)
        running = torch.where(go, running * (gap > tol_of(den)).to(dtype),
                              running)
    it_f = it * run_mask + 0.5 * running
    return (w * v)[:B], mu[:B, 0], gap[:B, 0], it_f[:B, 0]


def bind(y, w0, lam, mu0, run_mask, p: float, max_iters: int,
         fw_cycles: int = 10, stop_rel: float = 1e-5, newton_iters: int = 8):
    """The C entry point's call for a CUDA batch, its arguments made once.

    Checks the arguments as :func:`gpfw_fused` does and allocates the
    outputs.  Returns ``((w, mu, gap, iters_f), launch)``: each ``launch()``
    runs the kernel into those outputs and raises on a refused launch.
    ``launch`` does not count in :data:`LAUNCHES`; timing tools call it to
    time the kernel without the wrapper's host work."""
    if not y.is_cuda:
        raise ValueError("bind takes a CUDA batch: the kernel has no CPU "
                         "mode")
    B, n = y.shape
    lo, hi = lane_limits("lp")
    if y.dtype != torch.float32 or not lo <= n <= hi:
        raise ValueError(f"GPFW kernel takes float32 with {lo} <= n <= {hi}; "
                         f"got {y.dtype}, n = {n}")
    if tuple(w0.shape) != (B, n) or fw_cycles < 1:
        raise ValueError(f"w0 must be (B, n) = {(B, n)} and fw_cycles >= 1")

    def rows(a):
        a = torch.as_tensor(a, dtype=torch.float32,
                            device=y.device).reshape(-1)
        return torch.broadcast_to(a, (B,)).contiguous()

    y = y.contiguous()
    w0 = w0.to(torch.float32).contiguous()
    lam_t, mu_t, run_t = rows(lam), rows(mu0), rows(run_mask)
    outs = (torch.empty_like(y),
            *(torch.empty((B,), dtype=torch.float32, device=y.device)
              for _ in range(3)))
    e_arr, k_arr, q_ge2 = _pow_args(float(p))
    max_trips = -(-int(max_iters) // fw_cycles)
    args = (build.ptr(y), build.ptr(w0), build.ptr(lam_t), build.ptr(mu_t),
            build.ptr(run_t), *(build.ptr(o) for o in outs), B, n,
            max_trips, int(fw_cycles), float(stop_rel), int(newton_iters),
            q_ge2, e_arr, k_arr, build.stream_ptr(y.device))

    # keep: every tensor the pointers name, outputs too: a caller may drop
    # the outputs and launch again.
    def launch(keep=(y, w0, lam_t, mu_t, run_t, *outs)):
        build.check(build.lib().gpfw_fused(*args), "gpfw_fused")

    return outs, launch


def gpfw_fused(y, w0, lam, mu0, run_mask, p: float, max_iters: int,
               fw_cycles: int = 10, stop_rel: float = 1e-5,
               newton_iters: int = 8):
    """Run the fused GPFW dual loop.

    Args:
        y: (B, n) CENTERED signals.  CUDA tensors must be float32 with
            2 <= n <= 8192.
        w0: (B, n) dual start, zero final column (ball feasible).
        lam: (B,) per-signal penalties.
        mu0: (B,) warm KKT multipliers (>= 0; ones cold).
        run_mask: (B,) float 0/1; zero freezes a row (the caller's interior
            and zero-penalty rows).
        p: primal norm exponent; the dual ball uses q = p/(p-1).
        max_iters: iteration cap in single GPFW iterations.

    Returns:
        (w, mu, gap, iters_f): final dual (B, n), multiplier (B,), Holder
        gap (B,) and float iteration count (B,), ``fw_cycles`` per trip; a
        trailing 0.5 marks rows still running at the cap.
    """
    if not y.is_cuda:
        return gpfw_fused_plain(y, w0, lam, mu0, run_mask, p, max_iters,
                                fw_cycles, stop_rel, newton_iters, tb=1)
    outs, launch = bind(y, w0, lam, mu0, run_mask, p, max_iters, fw_cycles,
                        stop_rel, newton_iters)
    if y.shape[0] > 0:
        launch()
        LAUNCHES.value += 1
    return outs


def fixed_trips_agree(y, lam, p: float, w, it, w_r, it_r, ref64=None,
                      rtol: float = 1e-6, fw_cycles: int = 10,
                      x_atol: float = 5e-3, obj_rtol: float = 1e-5,
                      obj_atol: float = 1e-4):
    """Hold a launch stopped after a fixed count of trips against its plain
    version on the same inputs, by the dual objective
    ``0.5 ||D'w||^2 + y'D'w`` (float32 line searches part the iterates, not
    the objective).

    ``w, it`` are the kernel's dual and iteration counts, ``w_r, it_r`` the
    float32 plain version's.  Without ``ref64`` every row's dual objective
    is held within ``rtol`` relative of the plain version's.  With
    ``ref64 = (w64, it64)``, the plain version in float64 on the same
    inputs: the float32 plain version's largest relative error against it,
    over the rows where the two ran the same trips, is the rounding noise of
    a float32 run at this shape (``noise``); a row that ran the same trips
    on the kernel and the plain version is within ``rtol`` of the plain
    version or within ``noise`` of the float64 run; a row whose trip counts
    differ
    stopped on the earlier side by its stop test (a whole count), and the
    other side ran one trip more (``fw_cycles`` apart) or stopped by its
    test too; the primal ``x = y + D'w`` and objective of such a row and of
    every row that both sides stopped by their test are held at the
    converged bars (``x_atol``; ``obj_rtol`` relative plus ``obj_atol``).
    Returns ``(ok, numbers)``."""
    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64).detach().to("cpu")

    y, w, w_r, it, it_r = map(f64, (y, w, w_r, it, it_r))
    B = y.shape[0]
    lam = torch.broadcast_to(f64(lam).reshape(-1), (B,))

    def dual(wk):
        dtw = torch.diff(torch.nn.functional.pad(wk[:, :-1], (1, 1)), dim=1)
        return (dtw * (0.5 * dtw + y)).sum(1)

    def primal(wk):
        return y + torch.diff(torch.nn.functional.pad(wk, (1, 0)), dim=1)

    def objective(x):
        g = torch.diff(x, dim=1).abs()
        return (0.5 * ((x - y) ** 2).sum(1)
                + lam * (g ** p).sum(1) ** (1.0 / p))

    def most(a):
        return float(a.max()) if a.numel() else 0.0

    d, d_r = dual(w), dual(w_r)
    rel = (d - d_r).abs() / d_r.abs().clamp(min=1e-30)
    if ref64 is None:
        return bool((rel <= rtol).all()), dict(dual_rel=most(rel))
    w64, it64 = map(f64, ref64)
    d64 = dual(w64)
    e64, e64_r = ((dk - d64).abs() / d64.abs().clamp(min=1e-30)
                  for dk in (d, d_r))
    noise = most(e64_r[torch.floor(it_r) == torch.floor(it64)])
    same = torch.floor(it) == torch.floor(it_r)
    near64 = e64 <= noise
    whole = (it == torch.floor(it)) & (it_r == torch.floor(it_r))
    early = torch.minimum(it, it_r)[~same]
    held = ~same | whole  # held at the converged bars
    x, x_r = primal(w), primal(w_r)
    ex = (x - x_r).abs().amax(1)
    F, F_r = objective(x), objective(x_r)
    ef = (F - F_r).abs() / F_r.abs().clamp(min=1e-30)
    ok = (bool(((rel <= rtol) | near64)[same].all())
          and bool((early == torch.floor(early)).all())
          and bool(((torch.floor(it) - torch.floor(it_r)).abs()
                    == fw_cycles)[~same & ~whole].all())
          and bool((ex[held] <= x_atol).all())
          and bool(((F - F_r).abs()
                    <= obj_rtol * F_r.abs() + obj_atol)[held].all()))
    return ok, dict(dual_rel=most(rel[same]),
                    float32_noise=noise,
                    rows_within_noise=int((same & (rel > rtol)
                                           & near64).sum()),
                    rows_trips_apart=int((~same).sum()),
                    held_x_err=most(ex[held]), held_obj_rel=most(ef[held]))
