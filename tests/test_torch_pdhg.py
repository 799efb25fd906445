"""Port vs JAX package: the fused PDHG solver and kernel B3's plain version.

The JAX solver runs its Pallas chunk kernel in interpret mode (float32); the
port's solver runs B3's plain version on the CPU, with ``k_steps``/``tm``
pinned to the JAX package's values so the certificate cadence is the same.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from proxtv_tpu.models import tv2d as J2
from proxtv_tpu.ops.kernels import gating as JG
from proxtv_tpu.ops.kernels import pdhg_fused as JPK
from proxtv_tpu.utils.config import DEFAULT_COMBINER as JCFG
from proxtv_tpu_torch.models import tv2d as P2
from proxtv_tpu_torch.ops.kernels import pdhg_fused as PPK
from proxtv_tpu_torch.utils.config import DEFAULT_COMBINER as PCFG


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("variant", ["cp-acc", "cp"])
def test_sched_chunk_matches_jax_step_for_step(variant):
    """Each schedule step, taken from the JAX row's carried (sigma, tau),
    emits JAX's row to 1 float32 ulp.  XLA's float32 1/sqrt and divide are
    not correctly rounded (each is off by up to 1 ulp), so the next carried
    pair, sigma / theta with theta already 1 ulp apart, may differ by 2, and
    longer chains drift by a few ulps."""
    sig0 = np.float32(0.7)
    rows_j, carry_j = JPK.sched_chunk((jnp.float32(sig0),
                                       jnp.float32(0.9 / 5.6)), 12, 0.4,
                                      jnp.float32(sig0), 3.3, variant)
    rows_j = np.asarray(rows_j)
    nxt = [np.asarray(c) for c in carry_j]
    for i in range(12):
        rows_p, carry_p = PPK.sched_chunk((rows_j[i, 0], rows_j[i, 1]), 1,
                                          0.4, sig0, 3.3, variant)
        assert _ulps(rows_p[0], rows_j[i]).max() <= 1, i
        ref = rows_j[i + 1, :2] if i < 11 else nxt
        assert _ulps(carry_p, ref).max() <= 2, i
    sched = PPK.make_schedule(12, 0.4, sig0, np.float32(0.9 / 5.6), variant,
                              cap_mult=3.3)
    assert sched.shape == (12, 4) and sched.dtype == np.float32
    assert _ulps(sched, rows_j).max() <= 8


@pytest.mark.parametrize("variant", ["cp", "condat"])
def test_pdhg_fused_trajectory_matches_jax(variant):
    """gap_tol = 0 runs both solvers to the 120-iteration cap: the same
    iterates, at the JAX kernel test's bar (tests/test_kernels.py:137-153)."""
    rng = np.random.RandomState(0)
    B, M, N = 2, 20, 17
    Y = rng.randn(B, M, N).astype(np.float32)
    k, tm = JG.pdhg2d_params(N)
    xj, ij = J2._run_pdhg_fused(jnp.asarray(Y), jnp.float32(0.4), 120, 1e-9,
                                JCFG, variant, gap_tol=0.0)
    xp, ip = P2._run_pdhg_fused(torch.from_numpy(Y), 0.4, 120, 1e-9, PCFG,
                                variant, gap_tol=0.0, k_steps=k, tm=tm)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=5e-5)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


@pytest.mark.parametrize("B", [1, 2])
def test_pdhg_fused_restart_controller_matches_jax(B):
    """cp-acc with the gap-stall restart at a high lam (lam_rel ~ 3): B = 1
    certifies in the kernel every chunk, B = 2 through gap_and_primal."""
    rng = np.random.RandomState(1)
    Y = rng.randn(B, 20, 18).astype(np.float32)
    k, tm = JG.pdhg2d_params(18)
    xj, ij = J2._run_pdhg_fused(jnp.asarray(Y), 3.0, 6000, 1e-6, JCFG,
                                "cp-acc")
    xp, ip = P2._run_pdhg_fused(torch.from_numpy(Y), 3.0, 6000, 1e-6, PCFG,
                                "cp-acc", k_steps=k, tm=tm)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-4)


def _canvas_state(rng, Mp, Np, M, N, stride, count, halo):
    """A mid-solve-like state on a canvas, with NaN garbage in the padding
    rows that the kernel must sanitize."""
    f = [rng.randn(Mp, Np).astype(np.float32) for _ in range(5)]
    for a in f[:4]:
        a[:halo] = np.nan
    r = np.arange(Mp)[:, None] - halo
    in_img = (r >= 0) & (r < count * stride) & ((r % stride) < M)
    f[4] = np.where(in_img & (np.arange(Np)[None, :] < N), f[4], 0.0)
    return [a.astype(np.float32) for a in f]


@pytest.mark.parametrize("mode", ["cp_cert", "condat", "weighted_cert"])
def test_pdhg_chunk_plain_matches_pallas_kernel(mode):
    """One chunk of B3's plain version vs the Pallas kernel: core rows of the
    four state fields and the summed certificate partials."""
    rng = np.random.RandomState(2)
    M, N, count = 18, 20, 2
    k, tm = 4, 24
    halo = 2 * k
    stride = M + 8
    tiles = -(-(count * stride) // tm)
    Mp, Np = tiles * tm + 2 * halo, 128
    x, xb, u1, u2, y = _canvas_state(rng, Mp, Np, M, N, stride, count, halo)
    sched = PPK.make_schedule(k, 0.4, np.float32(0.6), np.float32(0.2),
                              "cp-acc", cap_mult=4.0)
    weighted = mode == "weighted_cert"
    wr = wc = None
    if weighted:
        wr = (0.2 + 0.3 * rng.rand(Mp, Np)).astype(np.float32)
        wc = (0.2 + 0.3 * rng.rand(Mp, Np)).astype(np.float32)
    cert = mode != "condat"
    kw = dict(k_steps=k, tm=tm, n_valid=N, m_valid=M, stride=stride,
              count=count, pad_top=halo, grad_step=mode == "condat",
              cert=cert)
    outj = JPK.pdhg_chunk(jnp.asarray(sched), *(jnp.asarray(a) for a in
                          (x, xb, u1, u2, y)),
                          wr=None if wr is None else jnp.asarray(wr),
                          wc=None if wc is None else jnp.asarray(wc), **kw)
    t = torch.from_numpy
    outp = PPK.pdhg_chunk(t(sched), *(t(a) for a in (x, xb, u1, u2, y)),
                          wr=None if wr is None else t(wr),
                          wc=None if wc is None else t(wc), **kw)
    core = slice(halo, Mp - halo)
    for a, b in zip(outp[:4], outj[:4]):
        np.testing.assert_allclose(a.numpy()[core], np.asarray(b)[core],
                                   atol=1e-5)
    if cert:
        for a, b in zip(outp[4:], outj[4:]):
            np.testing.assert_allclose(float(a.sum()), float(np.sum(b)),
                                       rtol=1e-5)


def test_pdhg_dual_warm_restart():
    """Re-solving from the solver's own converged duals (u0 / return_duals)
    certifies within one certificate period at the same output."""
    rng = np.random.RandomState(3)
    Y = torch.from_numpy(rng.randn(2, 24, 20).astype(np.float32))
    x1, i1, (u1, u2) = P2._run_pdhg_fused(Y, 0.4, 2500, PCFG.stop, PCFG,
                                          "cp-acc", return_duals=True)
    assert u1.shape == (2, 24, 19) and u2.shape == (2, 23, 20)
    x2, i2 = P2._run_pdhg_fused(Y, 0.4, 2500, PCFG.stop, PCFG, "cp-acc",
                                u0=(u1, u2))
    assert np.all(i1.rc.numpy() == 0)
    assert np.all(i2.iters.numpy() <= np.minimum(i1.iters.numpy(), 24))
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), atol=1e-3)


@pytest.mark.parametrize("option", ["weighted", "obj_target", "x0"])
def test_pdhg_fused_solver_options_match_jax(option):
    """Per-edge weight fields, equal-quality stopping and a primal warm
    start, each against the JAX solver (same iterations, same iterate)."""
    rng = np.random.RandomState(5)
    B, M, N = 1, 18, 16
    Y = rng.randn(B, M, N).astype(np.float32)
    k, tm = JG.pdhg2d_params(N, weighted=option == "weighted")
    kw_j, kw_p, lam = {}, {}, 0.5
    if option == "weighted":
        lam = 0.0
        for name, shp in (("W_col", (B, M - 1, N)), ("W_row", (B, M, N - 1))):
            w = (0.2 + 0.3 * rng.rand(*shp)).astype(np.float32)
            kw_j[name], kw_p[name] = jnp.asarray(w), torch.from_numpy(w)
    if option == "obj_target":
        kw_j["obj_target"] = kw_p["obj_target"] = 60.0
    if option == "x0":
        x0 = (0.5 * Y).astype(np.float32)
        kw_j["x0"], kw_p["x0"] = jnp.asarray(x0), torch.from_numpy(x0)
    xj, ij = J2._run_pdhg_fused(jnp.asarray(Y), lam, 3000, 1e-9, JCFG,
                                "cp-acc", **kw_j)
    xp, ip = P2._run_pdhg_fused(torch.from_numpy(Y), lam, 3000, 1e-9, PCFG,
                                "cp-acc", k_steps=k, tm=tm, **kw_p)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-4)


def _chunk_on_fields(sched, x, xb, u1, u2, y, lamr, lamc, vr, vc, in_img,
                     k_steps, grad_step):
    """B3's plain arithmetic (``pdhg_chunk_plain``) with the masks and
    lam x mask given as fields, as the CUDA kernel holds them: returns the
    four fields and the per-cell gap and objective of the certificate."""
    zero = torch.zeros((), dtype=x.dtype)
    x = torch.where(in_img, x, zero)
    xb = torch.where(in_img, xb, zero)
    u1 = torch.where(vr, u1, zero)
    u2 = torch.where(vc, u2, zero)
    for k in range(k_steps):
        sigma, tau, theta = sched[k, 0], sched[k, 1], sched[k, 2]
        u1 = torch.minimum(torch.maximum(u1 + sigma * PPK._drow(xb), -lamr),
                           lamr)
        u2 = torch.minimum(torch.maximum(u2 + sigma * PPK._dcol(xb), -lamc),
                           lamc)
        div = PPK._drow_t(u1) + PPK._dcol_t(u2)
        if grad_step:
            xn = x - tau * ((x - y) + div)
        else:
            xn = (x - tau * div + tau * y) * (1.0 / (1.0 + tau))
        xb = xn + theta * (xn - x)
        x = xn
    xhat = y - (PPK._drow_t(u1) + PPK._dcol_t(u2))
    gr = PPK._drow(xhat) * vr.to(x.dtype)
    gc = PPK._dcol(xhat) * vc.to(x.dtype)
    e_gap = lamr * torch.abs(gr) - u1 * gr + lamc * torch.abs(gc) - u2 * gc
    e_obj = (0.5 * (xhat - y) * (xhat - y) * in_img.to(x.dtype)
             + lamr * torch.abs(gr) + lamc * torch.abs(gc))
    return x, xb, u1, u2, e_gap, e_obj


@pytest.mark.parametrize("halo", ["kernel", "fields_short", "cert_short"])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("mode", ["cp", "condat", "weighted"])
def test_pdhg_window_halo(mode, k, halo):
    """The CUDA kernel's windows: cores of 8 x 8 cells, each cut from the
    canvas with a halo of K + 1 (``window_halo``) and zero outside it, run
    B3's plain arithmetic on their own and reproduce the whole canvas's
    fields and per-core certificate sums.  One cell less fails: K - 1 for
    the fields, K for the certificate.  Two images stacked with gap rows, a
    column margin past N, NaN in the top padding; weights (or lam) of 20-50
    keep the duals off their bounds, which would hide a spoiled cell."""
    rng = np.random.RandomState(7)
    M, N, count, pad_top, core = 20, 41, 2, 4, 8
    stride = M + 8
    Mp, Np = pad_top + count * stride + 4, 48
    x, xb, u1, u2, y = (torch.from_numpy(a) for a in _canvas_state(
        rng, Mp, Np, M, N, stride, count, pad_top))
    u1, u2 = 5.0 * u1, 5.0 * u2
    sched = torch.from_numpy(PPK.make_schedule(k, 30.0, np.float32(0.6),
                                               np.float32(0.2), "cp-acc",
                                               cap_mult=4.0))
    wr = wc = None
    if mode == "weighted":
        wr, wc = (torch.from_numpy((20.0 + 30.0 * rng.rand(Mp, Np))
                                   .astype(np.float32)) for _ in range(2))
    grad = mode == "condat"
    in_img, vr, vc = PPK._masks(Mp, Np, N, M, stride, count, pad_top,
                                torch.float32, "cpu")
    in_img = in_img.contiguous()
    lam = sched[0, 3]
    lamr = (wr if wr is not None else lam) * vr.to(torch.float32)
    lamc = (wc if wc is not None else lam) * vc.to(torch.float32)
    whole = _chunk_on_fields(sched, x, xb, u1, u2, y, lamr, lamc, vr, vc,
                             in_img, k, grad)
    # The helper is the plain version on the whole canvas.
    ref = PPK.pdhg_chunk_plain(sched, x, xb, u1, u2, y, k, core, N, M,
                               stride, count, pad_top, grad, wr, wc,
                               cert=True)
    for a, b in zip(whole[:4], ref[:4]):
        assert torch.equal(a, b)
    h0 = PPK._halo(k)
    band = slice(h0, h0 + (Mp - 2 * h0) // core * core)
    np.testing.assert_allclose(float(whole[4][band].sum()),
                               float(ref[4].sum()), rtol=1e-6)

    h = PPK.window_halo(k) - {"kernel": 0, "fields_short": 2,
                              "cert_short": 1}[halo]
    fields = (x, xb, u1, u2, y, lamr, lamc, vr, vc, in_img)
    pad = [torch.nn.functional.pad(f.to(torch.float32), (h, h + core,
                                                         h, h + core))
           for f in fields]
    pad[7:] = [f > 0 for f in pad[7:]]
    worst_f = worst_cell = worst_sum = 0.0
    for r0 in range(0, Mp, core):
        for c0 in range(0, Np, core):
            win = [f[r0:r0 + core + 2 * h, c0:c0 + core + 2 * h] for f in pad]
            out = _chunk_on_fields(sched, *win, k, grad)
            rows = slice(r0, min(r0 + core, Mp))
            cols = slice(c0, min(c0 + core, Np))
            cr = slice(h, h + rows.stop - rows.start)
            cc = slice(h, h + cols.stop - cols.start)
            for a, b in zip(out[:4], whole[:4]):
                worst_f = max(worst_f, float((a[cr, cc] - b[rows, cols])
                                             .abs().max()))
            for a, b in zip(out[4:], whole[4:]):
                worst_cell = max(worst_cell, float((a[cr, cc] - b[rows, cols])
                                                   .abs().max()))
                sa, sb = float(a[cr, cc].sum()), float(b[rows, cols].sum())
                worst_sum = max(worst_sum, abs(sa - sb) / max(1.0, abs(sb)))
    # A spoiled cell parts by far more than rounding: at K = 8 by ~7e-5 on
    # the fields and ~1e-3 on a cell's certificate terms.
    if halo == "kernel":
        assert worst_f <= 1e-6 and worst_sum <= 1e-6, (worst_f, worst_sum)
    elif halo == "cert_short":  # K keeps the fields, not the certificate
        assert worst_f <= 1e-6 and worst_cell > 1e-5, (worst_f, worst_cell)
    else:
        assert worst_f > 1e-5, worst_f
