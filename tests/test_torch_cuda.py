"""Card-only tests of the port's hand-written CUDA kernels against their
plain PyTorch versions.  They skip without a CUDA card (the kernels have no
CPU mode).  This file imports neither JAX nor the JAX package, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from proxtv_tpu_torch.ops.kernels import pcr as PK
from proxtv_tpu_torch.ops.kernels import pdhg_fused as PPK
from proxtv_tpu_torch.ops.kernels import pn_fused as PPF

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["plain", "masked", "shifted"])
def test_pcr_kernel_matches_plain(mode, dev):
    rng = np.random.RandomState(3)
    B, n = 300, 1000
    d = torch.from_numpy((0.01 * rng.randn(B, n)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(B, n) > 0.3)
    sh = torch.from_numpy((rng.rand(B) + 0.5).astype(np.float32))
    kw = {"masked": {"mask": mask}, "shifted": {"diag_shift": sh},
          "plain": {}}[mode]
    ref = PK.pcr_spd_solve_plain(d, **kw).numpy()
    before = PK.LAUNCHES.value
    out = PK.pcr_spd_solve(d.to(dev), **{k: v.to(dev) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert PK.LAUNCHES.value == before + 1
    # (DD')^-1 has condition ~4n^2/pi^2 unmasked: the two roundings may part
    # by ~1e-4 of the solution's size there; the masked/shifted systems are
    # well conditioned.
    rel = 1e-4 if mode == "plain" else 1e-5
    np.testing.assert_allclose(out.cpu().numpy(), ref,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


def test_kernels_raise_on_unsupported_cuda_input(dev):
    y64 = torch.zeros((4, 16), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        PK.pcr_spd_solve(y64)
    with pytest.raises(ValueError):
        PPF.pn_tv1_fused(y64, lam_scalar=0.5)
    with pytest.raises(ValueError):
        PK.pcr_spd_solve(torch.zeros((4, 9000), device=dev))
    with pytest.raises(ValueError):
        PPF.pn_tv1_fused(torch.zeros((4, 1), device=dev), lam_scalar=0.5)


def _lam_full(W):
    return np.concatenate([W, np.zeros((W.shape[0], 1), W.dtype)], axis=1)


@pytest.mark.parametrize("mode", ["scalar", "lam_full", "warm", "long"])
def test_pn_kernel_matches_plain(mode, dev):
    rng = np.random.RandomState(8)
    B, n = (16, 5000) if mode == "long" else (64, 1000)
    Y = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    lf = torch.from_numpy(_lam_full((rng.rand(B, n - 1) * 1.2)
                                    .astype(np.float32)))
    kw = {"lam_full": lf} if mode in ("lam_full", "warm") else {"lam_scalar": 0.7}
    if mode == "warm":
        kw["w_init"] = PPF.pn_tv1_fused_plain(Y * 0.9, lf)[1]
    ref, wref, it_ref = PPF.pn_tv1_fused_plain(Y, tb=1, **kw)
    kw = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()}
    x, w, iters = PPF.pn_tv1_fused(Y.to(dev), return_iters=True, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=2e-3)
    np.testing.assert_allclose(w.cpu().numpy(), wref.numpy(), atol=2e-3)
    assert np.abs(iters.cpu().numpy() - it_ref.numpy()).max() <= 2


def _canvas_state(rng, Mp, Np, M, N, stride, count, halo):
    f = [rng.randn(Mp, Np).astype(np.float32) for _ in range(5)]
    for a in f[:4]:
        a[:halo] = np.nan
    r = np.arange(Mp)[:, None] - halo
    in_img = (r >= 0) & (r < count * stride) & ((r % stride) < M)
    f[4] = np.where(in_img & (np.arange(Np)[None, :] < N), f[4], 0.0)
    return [torch.from_numpy(a.astype(np.float32)) for a in f]


@pytest.mark.parametrize("mode", ["cp_cert", "condat", "weighted_cert"])
def test_pdhg_kernel_matches_plain(mode, dev):
    rng = np.random.RandomState(4)
    M, N, count = 100, 90, 2
    k, tm = 8, 32
    halo = 2 * k
    stride = M + 8
    tiles = -(-(count * stride) // tm)
    Mp, Np = tiles * tm + 2 * halo, 128
    t = _canvas_state(rng, Mp, Np, M, N, stride, count, halo)
    sched = torch.from_numpy(PPK.make_schedule(k, 0.4, np.float32(0.6),
                                               np.float32(0.2), "cp-acc"))
    w = [None, None]
    if mode == "weighted_cert":
        w = [torch.from_numpy((0.2 + 0.3 * rng.rand(Mp, Np))
                              .astype(np.float32)) for _ in range(2)]
    kw = dict(k_steps=k, tm=tm, n_valid=N, m_valid=M, stride=stride,
              count=count, pad_top=halo, grad_step=mode == "condat",
              cert=mode != "condat")
    ref = PPK.pdhg_chunk_plain(sched, *t, wr=w[0], wc=w[1], **kw)
    out = PPK.pdhg_chunk(sched.to(dev), *(a.to(dev) for a in t),
                         wr=None if w[0] is None else w[0].to(dev),
                         wc=None if w[1] is None else w[1].to(dev), **kw)
    torch.cuda.synchronize()
    core = slice(halo, Mp - halo)
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy()[core], b.numpy()[core],
                                   atol=1e-4)
    if kw["cert"]:
        for a, b in zip(out[4:], ref[4:]):
            np.testing.assert_allclose(float(a.sum()), float(b.sum()),
                                       rtol=1e-4)


@pytest.mark.parametrize("n", [2, 3, 33, 129, 1025, 2049, 8192])
def test_kernels_across_the_lane_range(n, dev):
    """PN (every template instance) and PCR at the edges of 2..8192."""
    rng = np.random.RandomState(n)
    B = 8
    Y = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    ref, wref, _ = PPF.pn_tv1_fused_plain(Y, lam_scalar=0.5)
    x, w = PPF.pn_tv1_fused(Y.to(dev), lam_scalar=0.5)
    torch.cuda.synchronize()
    np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), atol=2e-3)
    np.testing.assert_allclose(w.cpu().numpy(), wref.numpy(), atol=2e-3)
    d = torch.from_numpy((0.01 * rng.randn(B, n)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(B, n) > 0.3)
    for kw in ({}, {"mask": mask}):
        ref = PK.pcr_spd_solve_plain(d, **kw).numpy()
        out = PK.pcr_spd_solve(d.to(dev), **{k: v.to(dev)
                                             for k, v in kw.items()})
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            out.cpu().numpy(), ref,
            atol=1e-3 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("method", ["dr", "pd", "yang", "kolmogorov",
                                    "condat", "chambolle-pock",
                                    "chambolle-pock-acc"])
def test_tv1_2d_batched_on_card_matches_cpu_float64(method, dev):
    """Every method through the card's kernels (B = 2: the PDHG solver's
    multi-image certificate) against the float64 CPU composition, at the
    cross-method bar of tests/test_tv2d.py (1e-3)."""
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops.kernels import pn_fused

    rng = np.random.RandomState(11)
    Y = rng.randn(2, 40, 36)
    cap = 1000 if method in ("dr", "pd", "yang") else 2500
    ref, _ = tv2d.tv1_2d_batched(torch.from_numpy(Y), 0.35, method="pd",
                                 max_iters=1000)
    b1, b3 = pn_fused.LAUNCHES.value, PPK.LAUNCHES.value
    x, info = tv2d.tv1_2d_batched(torch.from_numpy(Y).float().to(dev), 0.35,
                                  method=method, max_iters=cap)
    torch.cuda.synchronize()
    if method in ("condat", "chambolle-pock", "chambolle-pock-acc"):
        assert PPK.LAUNCHES.value > b3
    else:
        assert pn_fused.LAUNCHES.value > b1
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("case", ["tv1_batched_f64", "tv1_pn_f64",
                                  "tv2d_dr_f64", "tv2d_cp_acc_f64",
                                  "tv2d_dr_n1", "pcr_mask_and_shift",
                                  "pcr_thomas", "switch_off"])
def test_call_sites_raise_instead_of_running_plain_on_the_card(case, dev):
    """Every call site that holds a kernel launches it for a CUDA tensor or
    raises; none runs the plain composition on the card."""
    from proxtv_tpu_torch.models import tv2d
    from proxtv_tpu_torch.ops import tridiag, tv1d_l1
    from proxtv_tpu_torch.ops.kernels import gating

    y64 = torch.randn((4, 32), dtype=torch.float64, device=dev)
    y32 = y64.float()
    mask = torch.ones((4, 32), dtype=torch.bool, device=dev)
    calls = {
        "tv1_batched_f64": lambda: tv1d_l1.tv1_batched(y64, 0.5, method="pn"),
        "tv1_pn_f64": lambda: tv1d_l1.tv1_pn(y64, 0.5),
        "tv2d_dr_f64": lambda: tv2d.tv1_2d_batched(y64[None], 0.5),
        "tv2d_cp_acc_f64": lambda: tv2d.tv1_2d_batched(
            y64[None], 0.5, method="chambolle-pock-acc"),
        "tv2d_dr_n1": lambda: tv2d.tv1_2d_batched(y32[None, :, :1], 0.5),
        "pcr_mask_and_shift": lambda: tridiag.spd_second_difference_solve(
            y32, diag_shift=0.5, mask=mask),
        "pcr_thomas": lambda: tridiag.spd_second_difference_solve(
            y32, method="thomas"),
    }
    if case == "switch_off":
        with gating.fused_ctx(False), pytest.raises(RuntimeError):
            tv1d_l1.tv1_batched(y32, 0.5, method="pn")
        return
    with pytest.raises(ValueError):
        calls[case]()


def test_small_image_runs_the_pdhg_kernel(dev):
    """An image shorter than a PDHG tile (M = 5) still takes kernel B3."""
    from proxtv_tpu_torch.models import tv2d

    rng = np.random.RandomState(12)
    Y = rng.randn(1, 5, 12)
    ref, _ = tv2d.tv1_2d_batched(torch.from_numpy(Y), 0.35, method="pd",
                                 max_iters=1000)
    b3 = PPK.LAUNCHES.value
    x, info = tv2d.tv1_2d_batched(torch.from_numpy(Y).float().to(dev), 0.35,
                                  method="chambolle-pock-acc", max_iters=2500)
    torch.cuda.synchronize()
    assert PPK.LAUNCHES.value > b3
    np.testing.assert_allclose(x.cpu().double().numpy(), ref.numpy(),
                               atol=1e-3)
