"""ONE very long 1D TV-L1 signal banded over a mesh (port of
``proxtv_tpu.ops.tv1d_long_banded``).

The single-card long route (:mod:`.tv1d_long`) cuts one signal into
overlapped windows, solves them in one launch of kernel B1, glues the
window duals and certifies with the global duality gap.  Here the signal is
cut into contiguous bands, one a rank, and every global ingredient becomes a
collective of :mod:`proxtv_tpu_torch.parallel.comm`:

*   window construction: ``overlap``-sample halos from the band neighbours
    (a window crosses at most one band edge); each rank's windows are one
    B1 launch on the card (``tv1d_long._solve_windows``, ``tol_eps = 0``);
*   the duality-gap certificate: an all-reduce of per-rank edge sums;
*   the escalation, rank-resident: warm window resumes, a
    half-chunk-shifted second grid stitched at pinned edges through the
    distributed segmented min scans (:mod:`..parallel.segscan`), dual
    projected-gradient steps (1-sample halos), and the cascaded plateau
    snap through distributed segmented mean scans, with the all-reduced
    objective change as its certificate;
*   the last rung, a warm projected-Newton polish whose masked Newton
    systems are solved by distributed parallel cyclic reduction
    (:func:`_pcr_masked_banded`, PyTorch ops; each +-stride shift is one
    exchange) and whose Armijo and stop logic run on all-reduced scalars.

No rung gathers the signal to one rank.  Every branch is taken on an
all-reduced value read to the host (one host sync each), so every rank
takes it alike.  Entry point: :func:`proxtv_tpu_torch.parallel.tv1_1d_banded`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import comm, segscan
from ..utils.config import DEFAULT_TV1, EPSILON
from ..utils.info import RC_ITERS, RC_OK
from . import tv1d_long


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _halos(a, h: int, mesh):
    """(left, right): the left neighbour's last ``h`` elements and the right
    neighbour's first ``h`` (zeros past the band's ends), one exchange."""
    if h == 0 or mesh.size == 1:
        z = a.new_zeros(a.shape[:-1] + (h,))
        return z, z
    return tuple(comm.permute(mesh, [(a[..., -h:], 1), (a[..., :h], -1)]))


def _extend(a, h: int, mesh):
    """``a`` with ``h``-sample halos of its neighbours on each side."""
    left, right = _halos(a, h, mesh)
    return torch.cat([left, a, right], dim=-1)


def _left_halo(a, h: int, mesh):
    """The left neighbour's last ``h`` elements (zeros on the first rank)."""
    if h == 0 or mesh.size == 1:
        return a.new_zeros(a.shape[:-1] + (h,))
    return comm.permute(mesh, [(a[..., -h:], 1)])[0]


def _prev(a, mesh):
    """a_global[i - 1] (zero before the global start)."""
    return torch.cat([_left_halo(a, 1, mesh), a[..., :-1]], dim=-1)


def _next(a, mesh):
    """a_global[i + 1] (zero past the global end)."""
    if mesh.size == 1:
        right = a.new_zeros(a.shape[:-1] + (1,))
    else:
        (right,) = comm.permute(mesh, [(a[..., :1], -1)])
    return torch.cat([a[..., 1:], right], dim=-1)


def _gshifts(a, s: int, fills, mesh):
    """Global shifts of the banded rows ``a`` ((R, B_l)) by ``s`` both ways,
    in one exchange: (right, left) with right[i] = a_global[i - s] and
    left[i] = a_global[i + s], ``fills`` ((R, 1)) beyond the global ends.
    A shift spans at most two source ranks: whole-band hops by q = s // B_l
    and q + 1 plus a local splice."""
    B_l = a.shape[-1]
    Ng = mesh.size * B_l
    if s >= Ng:
        full = torch.broadcast_to(fills, a.shape)
        return full, full
    q, r = divmod(s, B_l)
    if r == 0:
        right, left = comm.permute(mesh, [(a, q), (a, -q)])
    else:
        r_hi, r_lo, l_lo, l_hi = comm.permute(mesh, [
            (a[..., B_l - r:], q + 1), (a[..., :B_l - r], q),
            (a[..., r:], -q), (a[..., :r], -(q + 1))])
        right = torch.cat([r_hi, r_lo], dim=-1)
        left = torch.cat([l_lo, l_hi], dim=-1)
    gidx = mesh.rank * B_l + torch.arange(B_l, device=a.device)
    return (torch.where(gidx >= s, right, fills),
            torch.where(gidx <= Ng - 1 - s, left, fills))


def _pcr_masked_banded(rhs, mask, mesh):
    """Distributed masked second-difference solve, the banded counterpart
    of ``tridiag.spd_second_difference_solve(rhs, mask=mask)`` (the Newton
    system of projected Newton): parallel cyclic reduction whose per-level
    +-stride shifts are global shifts of the band (one exchange a level).
    Active rows are identity rows; couplings exist only between adjacent
    inactive rows."""
    B_l = rhs.shape[-1]
    Ng = mesh.size * B_l
    dtype = rhs.dtype
    mf = mask.to(dtype)
    left, right = _halos(mf, 1, mesh)
    mprev = torch.cat([left, mf[:-1]])
    mnext = torch.cat([mf[1:], right])
    a = torch.where(mask, 2.0, 1.0).to(dtype)
    b = torch.where(mask & (mprev > 0), -1.0, 0.0).to(dtype)
    c = torch.where(mask & (mnext > 0), -1.0, 0.0).to(dtype)
    d = torch.where(mask, rhs, 0.0)
    fills = torch.tensor([[1.0], [0.0], [0.0], [0.0]], dtype=dtype,
                         device=rhs.device)
    for k in range(max(1, math.ceil(math.log2(Ng)))):
        stride = 1 << k
        if stride >= Ng:
            break
        (am, bm, cm, dm), (ap, bp, cp, dp) = _gshifts(
            torch.stack([a, b, c, d]), stride, fills, mesh)
        alpha = -b / am
        beta = -c / ap
        a = a + alpha * cm + beta * bp
        d = d + alpha * dm + beta * dp
        b = alpha * bm
        c = beta * cp
    return torch.where(mask, d / a, 0.0)


def _windows_ext(ext, Kl: int, chunk: int, overlap: int):
    """(Kl, chunk + 2*overlap) windows of the halo-extended local block:
    window k covers ext[k*chunk : k*chunk + win] (pads and reshapes only)."""
    win = chunk + 2 * overlap
    nl = Kl * chunk
    body = ext[overlap: overlap + nl].reshape(Kl, chunk)
    left = ext[:nl].reshape(Kl, chunk)[:, :overlap]
    tail = ext[overlap + chunk:]
    tail = F.pad(tail, (0, nl - tail.shape[0]))
    right = tail.reshape(Kl, chunk)[:, :overlap]
    return torch.cat([left, body, right], dim=1)[:, :win]


def run_banded(yl, lam_arr, *, mesh, n: int, chunk: int, overlap: int,
               cfg=DEFAULT_TV1):
    """Solve the banded long signal on this rank's block (the JAX package's
    ``run_banded`` shard_map body, ``tv1d_long_banded.py:162``).

    Args:
        yl: (B_l,) this rank's contiguous block of the zero-padded signal
            (the mesh holds ``mesh.size * B_l >= n`` samples; the padding is
            cut off by zero edge weights).
        lam_arr: 0-d penalty, or (B_l,) block of the zero-padded per-edge
            weights (edge i at global index i).
        n: the signal's length.  chunk/overlap: window geometry.

    Returns:
        (x_local, gap, iters, rc): the (B_l,) block of the solution and the
        global certificate (host scalars: gap, polish iterations, rc).
    """
    B_l = yl.shape[0]
    dt, dev = yl.dtype, yl.device
    npd = _np_dtype(dt)
    Kl = B_l // chunk
    win = chunk + 2 * overlap
    offset = chunk // 2
    d_idx = mesh.rank
    base = d_idx * B_l
    last = d_idx == mesh.size - 1
    per_edge = lam_arr.ndim >= 1
    zero = torch.zeros((), dtype=dt, device=dev)
    idx = torch.arange(B_l, device=dev)
    eg_local = base + idx                       # global edge index per slot
    edge_valid = eg_local < n - 1
    lam_local = torch.where(edge_valid, lam_arr, zero)

    def red(*parts, op="sum"):
        """All-reduced local scalars, as the solve's host dtype."""
        return [npd(v) for v in comm.reduce_host(mesh, torch.stack(parts),
                                                 op)]

    # ---- pass-1 windows (overlap halos) ----
    hmax = offset + overlap
    yext_full = _extend(yl, hmax, mesh)
    Yw = _windows_ext(yext_full[hmax - overlap: hmax + B_l + overlap], Kl,
                      chunk, overlap)
    eg_w = (base + (torch.arange(Kl, device=dev) * chunk)[:, None]
            + torch.arange(win - 1, device=dev)[None, :] - overlap)
    valid_w = (eg_w >= 0) & (eg_w < n - 1)
    if per_edge:
        lext_full = _extend(lam_arr, hmax, mesh)
        lw = _windows_ext(lext_full[hmax - overlap: hmax + B_l + overlap],
                          Kl, chunk, overlap)[:, :win - 1]
        lam_w = torch.where(valid_w, lw, zero)
    else:
        lam_w = torch.where(valid_w, lam_arr, zero)
    _, Ww = tv1d_long._solve_windows(Yw, lam_w)

    def glue(W):
        return W[:, overlap: overlap + chunk].reshape(B_l)

    w1 = glue(Ww)

    # ---- local primal / gradient / global gap ----
    def primal_of(w):
        return yl + w - _prev(w, mesh)

    def grad_of(x):
        return x - _next(x, mesh)              # g_i = x_i - x_{i+1}

    def gap_of(w):
        x = primal_of(w)
        g = grad_of(x)
        contrib = torch.sum(torch.where(edge_valid,
                                        lam_local * torch.abs(g) + w * g,
                                        zero))
        return abs(red(contrib)[0]), x

    # The global dtype-relative tolerance (as tv1d_long: 0.5||y - mean||^2).
    sample_valid = eg_local < n
    (ysum,) = red(torch.sum(yl))
    ymean = npd(ysum / npd(n))
    (yc2,) = red(torch.sum(torch.where(sample_valid, (yl - ymean) ** 2,
                                       zero)))
    feps = npd(np.finfo(npd).eps)
    scale = max(npd(1.0), npd(0.5) * yc2)
    tol = max(npd(cfg.stop), npd(2.0) * feps * scale)

    gap1, x1 = gap_of(w1)
    if not gap1 > tol:
        return x1, gap1, 0, RC_OK

    def objective_of(x):
        g = grad_of(x)
        fid = torch.sum(torch.where(sample_valid, (x - yl) ** 2, zero))
        tv = torch.sum(torch.where(edge_valid, lam_local * torch.abs(g),
                                   zero))
        return red(0.5 * fid + tv)[0]

    def tol_contract(x):
        # the BASELINE contract: duality gap <= 1e-5 * objective
        return max(tol, npd(1e-5) * objective_of(x))

    def seg_end(ss):
        """Segment-end flags: ``ss`` shifted left, the right neighbour's
        first flag at the end (1 at the global end)."""
        nxt = _next(ss, mesh)[-1:]             # collective: every rank
        return torch.cat([ss[1:], torch.ones_like(nxt) if last else nxt])

    def plateau_snap(x):
        """``tv1d_long._plateau_snap`` on the band: ulp-flat runs replaced
        by their segment mean where the all-reduced objective change is
        negative.  Returns (x, change)."""
        eps = feps
        (scale_x,) = red(torch.max(torch.abs(torch.where(sample_valid, x,
                                                         zero))), op="max")
        scale_x = max(scale_x, npd(1e-30))
        flat_prev = torch.abs(x - _prev(x, mesh)) <= npd(256.0) * eps * scale_x
        seg_start = torch.where(eg_local == 0, True, ~flat_prev)
        # Padding samples (>= n) must not merge with real ones.
        seg_start = seg_start | (eg_local == n)
        ss = seg_start.to(dt)
        m = segscan.segment_mean(x, ss, mesh, seg_end(ss))
        e = torch.where(sample_valid, m - x, zero)
        d_fid = torch.sum(e * (x - yl)) + 0.5 * torch.sum(e * e)
        d_tv = torch.sum(torch.where(
            edge_valid, lam_local * (torch.abs(grad_of(m))
                                     - torch.abs(grad_of(x))), zero))
        (dobj,) = red(d_fid + d_tv)
        if dobj < 0.0:
            return torch.where(sample_valid, m, x), dobj
        return x, npd(0.0)

    def dual_pgd(w, iters):
        # projected gradient on the dual, tau = 1/L = 0.25
        for _ in range(iters):
            g = grad_of(primal_of(w))
            w = torch.clamp(w - 0.25 * g, -lam_local, lam_local)
        return w

    # ---- rank-resident projected-Newton polish (tv1_pn on the band) ----
    ylc = torch.where(sample_valid, yl - ymean, zero)
    epsd = npd(EPSILON)
    big = npd(np.finfo(npd).max)
    eps_gap = max(epsd, npd(2.0) * feps * scale)
    eps_f = max(epsd, npd(10.0) * feps * scale)
    sigma = npd(cfg.sigma)

    def gap_c(w, g):
        return abs(red(torch.sum(torch.where(
            edge_valid, lam_local * torch.abs(g) + w * g, zero)))[0])

    def inactive_mask(w, g):
        return (lam_local > 0) & (
            ((w > -lam_local) & (w < lam_local))
            | ((w == -lam_local) & (g < -epsd))
            | ((w == lam_local) & (g > epsd)))

    dy_edges = _next(ylc, mesh) - ylc          # y[i+1] - y[i] at edge i

    def armijo(w, g, dN, mI, x, fval):
        wm, wp = _halos(w, 1, mesh)
        hw = 2.0 * w - torch.cat([wm, w[:-1]]) - torch.cat([w[1:], wp])
        use = mI & ~(w == lam_local)
        gRd, grad0 = red(
            torch.sum(torch.where(mI, g * dN, zero)),
            torch.sum(torch.where(use, -dN * (hw - dy_edges), zero)))
        ninf = torch.full((), -float(big), dtype=dt, device=dev)
        t_neg = torch.where(mI & (dN < 0), (w - lam_local) / dN, ninf)
        t_pos = torch.where(mI & (dN > 0), (w + lam_local) / dN, ninf)
        (maxstep0,) = red(torch.maximum(torch.max(t_neg), torch.max(t_pos)),
                          op="max")
        delta, maxstep, recomp = npd(1.0), maxstep0, False
        for _ in range(cfg.max_armijo):
            aux = torch.where(mI, torch.clamp(w - delta * dN, -lam_local,
                                              lam_local), w)
            dwv = aux - w
            dx = dwv - _prev(dwv, mesh)
            x_new = x + dx
            sxd, sdd = red(torch.sum(x * dx), torch.sum(dx * dx))
            improve = -(sxd + npd(0.5) * sdd)
            f_new = fval - improve
            if improve >= sigma * delta * gRd or improve <= eps_f:
                return aux, x_new, f_new
            tmp = grad0 * delta
            denom = npd(2.0) * (-improve - tmp)
            delta_interp = (-(tmp * delta) / denom if denom != 0
                            else delta * npd(0.5))
            delta_new = np.minimum(delta_interp,
                                   maxstep if recomp else maxstep0)
            if delta_new - delta >= -epsd:
                delta_new = delta * npd(0.5)
            if delta_new < epsd:
                return aux, x_new, f_new
            delta, maxstep, recomp = delta_new, delta_new, True
        return w, x, fval

    def pn_polish(w0, max_iters: int):
        MAX_STALL = 5
        w = torch.clamp(w0, -lam_local, lam_local)
        x = ylc + w - _prev(w, mesh)
        g = grad_of(x)
        (fval,) = red(0.5 * torch.sum(x * x))
        stop = best = gap_c(w, g)
        stall, iters = 0, 0
        running = stop > tol
        while running and iters < max_iters:
            mI = inactive_mask(w, g)
            (any_inactive,) = red(torch.any(mI).to(dt), op="max")
            if not any_inactive > 0:
                break
            dN = _pcr_masked_banded(torch.where(mI, g, zero), mI, mesh)
            dN = torch.where(mI, dN, zero)
            w, x, fval = armijo(w, g, dN, mI, x, fval)
            g = grad_of(x)
            stop = gap_c(w, g)
            improved = (stop < best - eps_gap) or (stop < npd(0.875) * best)
            best = min(best, stop)
            stall = 0 if improved else stall + 1
            iters += 1
            running = stop > tol and stall < MAX_STALL
        return w, torch.where(sample_valid, x + ymean, zero), abs(stop), iters

    # ---- escalation ----
    # rung 0: warm window resumes (clear float32 plateau stalls; local).
    _, Wr = tv1d_long._solve_windows(Yw, lam_w, w_init=Ww)
    _, Wr = tv1d_long._solve_windows(Yw, lam_w, w_init=Wr)
    w1r = glue(Wr)
    gap1r, x1r = gap_of(w1r)

    # rung 1: the half-chunk-shifted grid, stitched at pinned edges.
    # Shifted window k owns global edges [base + offset + k*chunk, ...).
    sl = slice(hmax + offset - overlap, hmax + offset - overlap + B_l
               + 2 * overlap)
    Yw2 = _windows_ext(yext_full[sl], Kl, chunk, overlap)
    eg_w2 = eg_w + offset
    valid_w2 = (eg_w2 >= 0) & (eg_w2 < n - 1)
    if per_edge:
        lw2 = _windows_ext(lext_full[sl], Kl, chunk, overlap)[:, :win - 1]
        lam_w2 = torch.where(valid_w2, lw2, zero)
    else:
        lam_w2 = torch.where(valid_w2, lam_arr, zero)
    # Warm start from the resumed pass-1 glue, windowed on the shifted grid.
    Wi = _windows_ext(_extend(w1r, hmax, mesh)[sl], Kl, chunk,
                      overlap)[:, :win - 1]
    Wi = torch.clamp(Wi, -lam_w2, lam_w2)
    _, Ww2 = tv1d_long._solve_windows(Yw2, lam_w2, w_init=Wi)
    w2_seg = glue(Ww2)                          # edges [base + offset, ...)
    # Align to the band (edges [base, base + B_l)): the first `offset`
    # slots come from the left neighbour's segment tail.
    w2 = torch.cat([_left_halo(w2_seg, offset, mesh), w2_seg[:B_l - offset]])
    # Edges below `offset` are not covered by the shifted grid: grid A.
    uncovered = eg_local < offset
    w2 = torch.where(uncovered, w1r, w2)

    # Pinned-edge stitch (tv1d_long's jitter_dual): regions between edges
    # where both grids agree at a bound are taken whole from the grid whose
    # cuts lie farther from them (distributed segment minimum).
    (wmag,) = red(torch.max(torch.abs(w1r)), op="max")
    tiny = npd(32.0) * feps * max(wmag, npd(1.0))
    pinned = ((torch.abs(w1r - w2) <= tiny)
              & (lam_local - torch.abs(w1r) <= tiny))
    seg_start = torch.where(eg_local == 0, 1.0, _prev(pinned.to(dt), mesh))
    se = seg_end(seg_start)
    # seam distances in integers (exact at any n), cast for the scan
    mA = torch.remainder(eg_local + 1, chunk)
    dA = torch.minimum(mA, chunk - mA).to(dt)
    mB = torch.remainder(eg_local + 1 - offset + chunk, chunk)
    dB = torch.where(uncovered, -1.0, torch.minimum(mB, chunk - mB).to(dt))
    minA = segscan.segment_min(dA, seg_start, mesh, se)
    minB = segscan.segment_min(dB, seg_start, mesh, se)
    wj = torch.where(minA < minB, w2, w1r)

    # rung 2: dual PGD and the cascaded snap, certified.
    wj = dual_pgd(wj, 12)
    gapj, xj = gap_of(wj)
    wb, xb = (wj, xj) if gapj < gap1r else (w1r, x1r)
    gapb = min(gapj, gap1r)
    xs, dobj = plateau_snap(xb)
    xs, dobj2 = plateau_snap(xs)
    gap_s = max(gapb + dobj + dobj2, npd(0.0))
    it_p = 0
    if gap_s > tol_contract(xs):
        # rung 3: the warm projected-Newton polish and a snap, with the gap
        # carried to the snapped point.
        _, xp, gap_p, it_p = pn_polish(wb, cfg.max_iters)
        xps, dp1 = plateau_snap(xp)
        xps, dp2 = plateau_snap(xps)
        gps = max(gap_p + dp1 + dp2, npd(0.0))
        if gps < gap_s:
            xs = xps
        gap_s = min(gps, gap_s)
    rc = RC_OK if gap_s <= tol_contract(xs) else RC_ITERS
    return xs, gap_s, it_p, rc
