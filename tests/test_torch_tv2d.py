"""Port vs JAX package: the scalar-lam 2D TV-L1 combiners, float64 on the CPU.

On the CPU both packages take their compositions (the JAX package's XLA
paths, the port's plain PyTorch), so the values agree to rounding and the
per-image iteration counts are equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proxtv_tpu.models import tv2d as J2
from proxtv_tpu_torch.models import tv2d as P2

METHODS = ["dr", "pd", "yang", "kolmogorov", "condat", "chambolle-pock",
           "chambolle-pock-acc"]


@pytest.mark.parametrize("method", METHODS)
def test_tv1_2d_batched_matches_jax(method):
    rng = np.random.RandomState(0)
    B, M, N = 2, 12, 10
    Y = rng.randn(B, M, N)
    lam = 0.35
    cap = 300 if method in ("condat", "chambolle-pock") else 0
    xj, ij = J2.tv1_2d_batched(jnp.asarray(Y), lam, method=method,
                               max_iters=cap)
    xp, ip = P2.tv1_2d_batched(torch.from_numpy(Y), lam, method=method,
                               max_iters=cap)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))


def test_prox_rows_cols_match_jax():
    rng = np.random.RandomState(1)
    X = rng.randn(2, 7, 9)
    for fn in ("prox_rows", "prox_cols"):
        xj = getattr(J2, fn)(jnp.asarray(X), 0.4)
        xp = getattr(P2, fn)(torch.from_numpy(X), 0.4)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-8)


def test_per_image_lam_raises_until_weighted_solver():
    Y = torch.zeros((2, 8, 8), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        P2.tv1_2d_batched(Y, torch.tensor([0.1, 0.2]), method="dr")


def test_freeze_tree_contract():
    B = 2
    running = torch.tensor([True, False])
    new = (torch.ones(4, 3), torch.tensor(5.0))
    old = (torch.zeros(4, 3), torch.tensor(1.0))
    out = P2._freeze_tree(new, old, running, B)
    np.testing.assert_array_equal(out[0].numpy(),
                                  np.array([[1.0] * 3] * 2 + [[0.0] * 3] * 2))
    assert float(out[1]) == 5.0
    with pytest.raises(ValueError, match="image-major"):
        P2._freeze_tree((torch.ones(3, 2),), (torch.ones(3, 2),), running, B)


def test_sigma_schedule_matches_jax():
    rng = np.random.RandomState(2)
    Y = rng.randn(1, 16, 16)
    s_j, c_j = J2._pdhg_sigma_schedule(jnp.asarray(Y), 0.8, jnp.float64)
    s_p, c_p = P2._pdhg_sigma_schedule(torch.from_numpy(Y), 0.8,
                                       torch.float64)
    np.testing.assert_allclose([float(s_p), float(c_p)],
                               [float(s_j), float(c_j)], rtol=1e-12)
