"""Port vs JAX package: the TV-L2 engines (tv2_ms, tv2_pg, tv2_mspg, the
spectral path) and kernel B4's plain version.

Inputs are made by numpy from a seed.  The JAX Pallas kernel runs in
interpret mode; the port's plain version of B4 is given the JAX tile height
``tb``.  The engines run in float64 on the CPU in both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import oracles
from proxtv_tpu.ops import tv1d_l2 as JL2
from proxtv_tpu_torch.ops import tv1d_l2 as PL2
from proxtv_tpu_torch.ops.kernels import ms_fused as PMS
from proxtv_tpu_torch.utils import interop

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _ms_case(mode):
    """The cases of tests/test_kernels.py:187-221 (float32, tb = 8)."""
    rng = np.random.RandomState(0)
    if mode == "scalar":
        Y = (rng.randn(8, 30) * 2).astype(np.float32)
        return Y, {"lam": 1.3}
    Y = rng.randn(6, 24).astype(np.float32)
    return Y, {"lam_rows": np.array([0.0, 0.4, 0.9, 2.0, 50.0, 1.1],
                                    np.float32)}


@pytest.mark.parametrize("mode", ["scalar", "rows", "warm"])
def test_ms_fused_plain_matches_pallas_kernel(mode):
    """B4's plain version at the JAX tile height vs the Pallas kernel: x to
    1e-5, equal iteration counts, alpha and gap to float32 rounding."""
    from proxtv_tpu.ops.kernels import ms_fused as JMS

    Y, kw = _ms_case("rows" if mode == "warm" else mode)
    kw_j = {k: jnp.asarray(v) for k, v in kw.items()}
    kw_p = {k: torch.as_tensor(v) for k, v in kw.items()}
    if mode == "warm":
        _, a0, _, _ = JMS.ms_tv2_fused(jnp.asarray(Y), tb=8, **kw_j)
        kw_j["alpha_init"] = a0
        kw_p["alpha_init"] = torch.from_numpy(np.array(a0))
    xj, aj, gj, ij = JMS.ms_tv2_fused(jnp.asarray(Y), tb=8, **kw_j)
    xp, ap, gp, ip = PMS.ms_tv2_fused_plain(torch.from_numpy(Y), tb=8, **kw_p)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-5)
    if mode == "rows":  # lam = 0: identity; lam = 50: interior, the mean
        np.testing.assert_allclose(xp.numpy()[0], Y[0], atol=1e-6)
        np.testing.assert_allclose(xp.numpy()[4], np.full(24, Y[4].mean()),
                                   atol=1e-5)
    if mode == "warm":
        assert int(ip.max()) <= 1


def test_ms_fused_per_fiber_semantics():
    """The CPU wrapper is the plain version at tb = 1 (the CUDA kernel's
    per-fiber loop); row-masked updates make every tb give the same result,
    and it solves the prox to the JAX kernel test's oracle bar."""
    Y, kw = _ms_case("scalar")
    x, a, g, it = PMS.ms_tv2_fused(torch.from_numpy(Y), **kw)
    x8, a8, g8, it8 = PMS.ms_tv2_fused_plain(torch.from_numpy(Y), tb=8, **kw)
    np.testing.assert_array_equal(x.numpy(), x8.numpy())
    np.testing.assert_array_equal(it.numpy(), it8.numpy())
    for k in range(Y.shape[0]):
        ref = oracles.tv2_oracle(Y[k].astype(float), 1.3)
        np.testing.assert_allclose(x.numpy()[k], ref, atol=2e-3)
    with pytest.raises(ValueError):
        PMS.ms_tv2_fused(torch.from_numpy(Y))


@pytest.mark.parametrize("engine", ["ms", "pg", "mspg"])
@pytest.mark.parametrize("n", [2, 3, 24, 65])
def test_tv2_engines_match_jax(engine, n):
    rng = np.random.RandomState(n)
    Y = rng.randn(6, n) * 2
    lam = float(rng.rand() + 0.2)
    xj, ij = JL2.tv2_batched(jnp.asarray(Y), lam, method=engine)
    xp, ip = PL2.tv2_batched(torch.from_numpy(Y), lam, method=engine)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))
    np.testing.assert_allclose(ip.gap.numpy(), np.asarray(ij.gap), atol=1e-8)


def test_tv2_ms_rows_and_alpha_warm_start_match_jax():
    """Per-row lam with a zero and an interior row, and the secular alpha
    carried from the JAX package through interop as a warm start."""
    rng = np.random.RandomState(1)
    Y = rng.randn(5, 40)
    lams = np.array([0.0, 0.3, 1.5, 1e6, 4.0])
    xj, ij, aj = JL2.tv2_ms(jnp.asarray(Y), jnp.asarray(lams),
                            return_alpha=True)
    xp, ip, ap = PL2.tv2_ms(torch.from_numpy(Y), torch.from_numpy(lams),
                            return_alpha=True)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_allclose(xp.numpy()[0], Y[0], atol=1e-12)
    np.testing.assert_allclose(xp.numpy()[3], np.full(40, Y[3].mean()),
                               atol=1e-8)
    a0 = interop.ms_alpha(np.asarray(aj))
    Y2 = Y + 0.01 * rng.randn(*Y.shape)
    xj2, ij2 = JL2.tv2_ms(jnp.asarray(Y2), jnp.asarray(lams), alpha_init=aj)
    xp2, ip2 = PL2.tv2_ms(torch.from_numpy(Y2), torch.from_numpy(lams),
                          alpha_init=a0)
    np.testing.assert_allclose(xp2.numpy(), np.asarray(xj2), atol=1e-8)
    np.testing.assert_array_equal(ip2.iters.numpy(), np.asarray(ij2.iters))
    with pytest.raises(ValueError):
        interop.ms_alpha(np.zeros((2, 3)))


def _kkt(x, y, lam):
    """The sharp KKT certificate of tests/test_tv1d_l2.py:70-139: at the
    optimum w = -lam Dx / ||Dx||, and w is the running sum of x - y."""
    g = x[:-1] - x[1:]
    w = np.cumsum(x - y)[:-1]
    np.testing.assert_allclose(w, -lam * g / np.linalg.norm(g), atol=1e-6)


@pytest.mark.parametrize("n,lam", [(12288, 10.0), (10007, 8.0)])
def test_spectral_path_matches_jax(n, lam):
    """n > 8192: the direct DST-I (2n 2-3-smooth, n = 12288) and the chirp-z
    DST with one exact back-solve (prime n = 10007), with a zero-penalty
    row, against the JAX package to 1e-8 and the KKT certificate."""
    assert PL2._fft_friendly(2 * n) == (n == 12288)
    rng = np.random.RandomState(n)
    Y = np.cumsum(rng.randn(2, n), axis=1) * 0.05 + rng.randn(2, n)
    lams = np.array([lam, 0.0])
    xj, ij, aj = JL2.tv2_ms(jnp.asarray(Y), jnp.asarray(lams),
                            return_alpha=True)
    xp, ip, ap = PL2.tv2_ms(torch.from_numpy(Y), torch.from_numpy(lams),
                            return_alpha=True)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), [0, 0])
    assert int(ip.iters[1]) == 0
    np.testing.assert_allclose(xp.numpy()[1], Y[1], atol=1e-12)
    _kkt(xp.numpy()[0], Y[0], lam)
    # Re-solving from its own alpha takes (near) zero iterations.
    x2, i2 = PL2.tv2_ms(torch.from_numpy(Y[:1]), lam, alpha_init=ap[:1])
    assert int(i2.iters[0]) <= 1
    np.testing.assert_allclose(x2.numpy(), xp.numpy()[:1], atol=1e-8)


def test_dst1_chirp_matches_direct_and_jax():
    rng = np.random.RandomState(2)
    for m in [5, 64, 1000]:
        x = rng.randn(2, m)
        direct = PL2._dst1(torch.from_numpy(x))
        np.testing.assert_allclose(PL2._dst1_chirp(torch.from_numpy(x)).numpy(),
                                   direct.numpy(), atol=1e-12)
        np.testing.assert_allclose(direct.numpy(),
                                   np.asarray(JL2._dst1(jnp.asarray(x))),
                                   atol=1e-12)
    x = torch.from_numpy(rng.randn(1, 10007))  # prime length: involution
    np.testing.assert_allclose(PL2._dst1_chirp(PL2._dst1_chirp(x)).numpy(),
                               x.numpy(), atol=1e-12)


def test_tv2_batched_unknown_method_raises():
    with pytest.raises(ValueError):
        PL2.tv2_batched(torch.zeros((2, 5), dtype=torch.float64), 1.0,
                        method="nope")
