"""Port vs JAX package: projected Newton (tv1_pn) and kernel B1.

Inputs are made by numpy from a seed.  The JAX Pallas kernel runs in
interpret mode; the port's plain version of B1 is pinned to the JAX tile
height ``tb`` so its tile-wide decisions match.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import oracles
from proxtv_tpu.ops import tv1d_l1 as JL
from proxtv_tpu_torch.ops import tv1d_l1 as PL
from proxtv_tpu_torch.ops.kernels import pn_fused as PPF


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _lam(kind, B, n, rng):
    return {"scalar": 0.7, "per_signal": rng.rand(B) + 0.2,
            "weighted": rng.rand(B, n - 1) * 1.2, "zero": 0.0,
            "huge": 1e7}[kind]


@pytest.mark.parametrize("kind", ["scalar", "per_signal", "weighted", "zero",
                                  "huge"])
def test_tv1_pn_matches_jax(kind):
    rng = np.random.RandomState(0)
    B, n = 8, 30
    Y = rng.randn(B, n) * 2
    lam = _lam(kind, B, n, rng)
    xj, ij = JL.tv1_pn(jnp.asarray(Y), jnp.asarray(lam))
    xp, ip = PL.tv1_pn(torch.from_numpy(Y), torch.from_numpy(np.asarray(lam)))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    assert np.all(ip.rc.numpy() == np.asarray(ij.rc))


def test_tv1_pn_warm_start_and_dual_match_jax():
    rng = np.random.RandomState(1)
    B, n = 6, 24
    Y = rng.randn(B, n)
    W = rng.rand(B, n - 1) * 1.2
    w0 = rng.randn(B, n - 1) * 0.3
    xj, ij, wj = JL.tv1_pn(jnp.asarray(Y), jnp.asarray(W),
                           w_init=jnp.asarray(w0), return_dual=True)
    xp, ip, wp = PL.tv1_pn(torch.from_numpy(Y), torch.from_numpy(W),
                           w_init=torch.from_numpy(w0), return_dual=True)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


def test_degenerate_guards_match_jax():
    rng = np.random.RandomState(2)
    B, n = 5, 12
    Y = rng.randn(B, n)
    X = rng.randn(B, n)
    lamv = np.abs(rng.randn(B, n - 1))
    lamv[1] = 0.0
    lamv[3] = 1e9
    xj = JL._apply_degenerate_guards(jnp.asarray(X), jnp.asarray(Y),
                                     jnp.asarray(lamv))
    xp = PL._apply_degenerate_guards(torch.from_numpy(X), torch.from_numpy(Y),
                                     torch.from_numpy(lamv))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-12)


def _lam_full(W):
    return np.concatenate([W, np.zeros((W.shape[0], 1), W.dtype)], axis=1)


@pytest.mark.parametrize("mode", ["scalar", "lam_full", "warm", "dc_offset"])
def test_pn_fused_plain_matches_pallas_kernel(mode):
    """B1's plain version at the JAX tile height vs the Pallas kernel (f32)."""
    from proxtv_tpu.ops.kernels import pn_fused as JPF

    rng = np.random.RandomState(3)
    B, n, tb = 16, 64, 8
    Y = (rng.randn(B, n) * 2).astype(np.float32)
    if mode == "dc_offset":
        Y = (100.0 + rng.randn(B, n)).astype(np.float32)
    W = (rng.rand(B, n - 1) * 1.2).astype(np.float32)
    kw_j, kw_p = {}, {}
    if mode in ("scalar", "dc_offset"):
        kw_j["lam_scalar"] = kw_p["lam_scalar"] = 0.7
    else:
        lf = _lam_full(W)
        kw_j["lam_full"], kw_p["lam_full"] = jnp.asarray(lf), torch.from_numpy(lf)
    if mode == "warm":
        w0 = _lam_full((0.3 * rng.randn(B, n - 1)).astype(np.float32))
        kw_j["w_init"], kw_p["w_init"] = jnp.asarray(w0), torch.from_numpy(w0)
    xj, wj = JPF.pn_tv1_fused(jnp.asarray(Y), tb=tb, **kw_j)
    xp, wp, _ = PPF.pn_tv1_fused_plain(torch.from_numpy(Y), tb=tb, **kw_p)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-5)


def test_pn_fused_plain_return_dual_off():
    from proxtv_tpu.ops.kernels import pn_fused as JPF

    rng = np.random.RandomState(4)
    Y = rng.randn(8, 30).astype(np.float32)
    xj, wj = JPF.pn_tv1_fused(jnp.asarray(Y), lam_scalar=1.3, tb=8,
                              return_dual=False)
    xp, wp = PPF.pn_tv1_fused(torch.from_numpy(Y), lam_scalar=1.3,
                              return_dual=False)
    assert wj is None and wp is None
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_pn_fused_plain_tb1_matches_oracle(weighted):
    """Per-fiber decisions (tb = 1, the CUDA kernel's semantics) against the
    L-BFGS-B oracle, at the JAX kernel test's own bar."""
    rng = np.random.RandomState(5)
    B, n = 8, 30
    Y = (rng.randn(B, n) * 2).astype(np.float32)
    W = (rng.rand(B, n - 1) * 1.2 + 0.05).astype(np.float32)
    if not weighted:
        W[:] = 0.7
    x, w, iters = PPF.pn_tv1_fused(torch.from_numpy(Y),
                                   torch.from_numpy(_lam_full(W)),
                                   return_iters=True)
    assert np.all(iters.numpy() >= 0)
    for k in range(B):
        ref = oracles.tv1w_oracle(Y[k].astype(float), W[k].astype(float))
        np.testing.assert_allclose(x.numpy()[k], ref, atol=1e-3)


def test_pn_fused_plain_degenerate():
    rng = np.random.RandomState(6)
    B, n = 4, 16
    Y = rng.randn(B, n).astype(np.float32)
    x, _ = PPF.pn_tv1_fused(torch.from_numpy(Y),
                            torch.zeros((B, n), dtype=torch.float32))
    np.testing.assert_allclose(x.numpy(), Y, atol=1e-6)
    x, _ = PPF.pn_tv1_fused(torch.from_numpy(Y), lam_scalar=1e7)
    np.testing.assert_allclose(x.numpy(), Y.mean(1, keepdims=True)
                               * np.ones((1, n)), atol=1e-5)


def test_tv1_batched_routing():
    rng = np.random.RandomState(7)
    Y = torch.from_numpy(rng.randn(4, 20))
    xpn, _ = PL.tv1_pn(Y, 0.5)
    for m in ("pn", "hybridtautstring", "condat", "dp", "classictautstring"):
        np.testing.assert_array_equal(PL.tv1_batched(Y, 0.5, method=m).numpy(),
                                      xpn.numpy())
    with pytest.raises(NotImplementedError, match="A8"):
        PL.tv1_batched(Y, 0.5, method="tautstring", strict=True)
    with pytest.raises(ValueError):
        PL.tv1_batched(Y, torch.rand(4, 19), method="condat", strict=True)
    with pytest.raises(ValueError):
        PL.tv1_batched(Y, 0.5, method="nope")
