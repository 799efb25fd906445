"""Port vs JAX package: tridiagonal solves and kernel B2 (PCR).

Inputs are made by numpy from a seed and handed to both packages as arrays.
The JAX Pallas kernel runs in interpret mode, as tests/test_kernels.py runs
it; the port's kernel wrapper takes its plain version for CPU tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from proxtv_tpu.ops import tridiag as JT
from proxtv_tpu_torch.ops import tridiag as PT
from proxtv_tpu_torch.ops.kernels import pcr as PK


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _inputs(B=12, n=40, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n), rng.rand(B, n) > 0.3, rng.rand(B) + 0.5)


@pytest.mark.parametrize("mode", ["plain", "masked", "shifted", "shift_vec",
                                  "thomas"])
def test_spd_second_difference_solve_matches_jax(mode):
    d, mask, sh = _inputs()
    kw_j, kw_p = {}, {}
    if mode == "masked":
        kw_j["mask"], kw_p["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if mode == "shifted":
        kw_j["diag_shift"], kw_p["diag_shift"] = 0.7, 0.7
    if mode == "shift_vec":
        kw_j["diag_shift"] = jnp.asarray(sh[:, None])
        kw_p["diag_shift"] = torch.from_numpy(sh[:, None])
    if mode == "thomas":
        kw_j["method"] = kw_p["method"] = "thomas"
    xj = np.asarray(JT.spd_second_difference_solve(jnp.asarray(d), **kw_j))
    xp = PT.spd_second_difference_solve(torch.from_numpy(d), **kw_p).numpy()
    np.testing.assert_allclose(xp, xj, atol=1e-12)


def test_pcr_solve_general_and_normalized_match_jax():
    rng = np.random.RandomState(1)
    B, n = 6, 33
    a = 3.0 + rng.rand(B, n)
    b = rng.randn(B, n)
    c = rng.randn(B, n)
    b[:, 0] = 0.0
    c[:, -1] = 0.0
    d = rng.randn(B, n)
    xj = np.asarray(JT.pcr_solve(*(jnp.asarray(v) for v in (a, b, c, d))))
    xp = PT.pcr_solve(*(torch.from_numpy(v) for v in (a, b, c, d))).numpy()
    np.testing.assert_allclose(xp, xj, atol=1e-12)
    sh = rng.rand(B, 1)
    xj = np.asarray(JT.spd_shifted_solve_normalized(jnp.asarray(d),
                                                    jnp.asarray(sh)))
    xp = PT.spd_shifted_solve_normalized(torch.from_numpy(d),
                                         torch.from_numpy(sh)).numpy()
    np.testing.assert_allclose(xp, xj, atol=1e-12)


@pytest.mark.parametrize("mode", ["plain", "masked", "shifted"])
def test_pcr_plain_matches_pallas_kernel(mode):
    """B2's plain version repeats the TPU kernel's arithmetic: f32 against
    the Pallas kernel in interpret mode (solutions of size ~10)."""
    from proxtv_tpu.ops.kernels import pcr as JK

    rng = np.random.RandomState(2)
    B, n = 16, 32
    d = (0.05 * rng.randn(B, n)).astype(np.float32)
    mask = rng.rand(B, n) > 0.3
    sh = (rng.rand(B) + 0.5).astype(np.float32)
    kw_j, kw_p = {}, {}
    if mode == "masked":
        kw_j["mask"], kw_p["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if mode == "shifted":
        kw_j["diag_shift"] = jnp.asarray(sh)
        kw_p["diag_shift"] = torch.from_numpy(sh)
    xj = np.asarray(JK.pcr_spd_solve_pallas(jnp.asarray(d), tb=8, **kw_j))
    xp = PK.pcr_spd_solve(torch.from_numpy(d), **kw_p).numpy()
    assert xp.dtype == np.float32
    np.testing.assert_allclose(xp, xj, atol=1e-5)


def test_pcr_wrapper_cpu_takes_plain_and_checks_args():
    d, mask, sh = _inputs(4, 16)
    t = torch.from_numpy(d)
    np.testing.assert_array_equal(PK.pcr_spd_solve(t).numpy(),
                                  PK.pcr_spd_solve_plain(t).numpy())
    with pytest.raises(ValueError):
        PK.pcr_spd_solve(t, mask=torch.from_numpy(mask),
                         diag_shift=torch.from_numpy(sh))
