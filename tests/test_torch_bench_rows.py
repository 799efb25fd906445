"""bench.py's rows that land farther than 2e-3 from float64 on the card, in
float32 on the CPU: the port's route against the JAX package's.

``chip_smoke.py`` holds F2 (per-edge-weighted pn, 10000 x 1000) and F3 (a
stream of 8 signals of 10^6) by the certified-gap rule against the float64
host taut string, and prints each row's distance: on F2's rows 2617 and
3871, and on F3's signals 3 and 5, the float32 solution it certifies lies
several 1e-3 to 1e-2 from float64.  These tests take those rows and show
that the JAX package's float32 route lands on the same solution, so the
distance is the reference algorithm's stop floor, not the port's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from proxtv_tpu.ops import tv1d_long as JL
from proxtv_tpu.ops.kernels import pn_fused as JPF
from proxtv_tpu_torch.ops import tv1d_long as TL
from proxtv_tpu_torch.ops.kernels import pn_fused as TPF
from proxtv_tpu_torch.runtime import native

torch.set_num_threads(1)

# F2's rows past 2e-3 and their max |x - x_host64| on the card
# (chip_smoke.py's F2 line, H100 80GB HBM3).
F2_CARD = {2617: 4.2508e-3, 3871: 3.1557e-3}


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _f2_rows(rows):
    """chip_smoke.py's F2 inputs: the bench batch from RandomState(0) after
    the 1024^2 image; the weights 0.5 + U[0, 1) from RandomState(6) after
    the 4K image."""
    rng = np.random.RandomState(0)
    rng.randn(1024, 1024)
    Y = rng.randn(10000, 1000)[rows]
    rng = np.random.RandomState(6)
    rng.randn(1, 2160, 3840)
    W = 0.5 + rng.rand(10000, 999)[rows]
    return Y.astype(np.float32), W.astype(np.float32)


def test_f2_far_rows_land_where_the_jax_kernel_does(interpret_pallas):
    """F2's two far rows: the JAX package's fused PN kernel (the TPU
    kernel's arithmetic, interpret mode) and the port's plain version of B1
    agree to 1e-5, and both land as far from the float64 host taut string
    as the card did (1e-6)."""
    rows = sorted(F2_CARD)
    Y, W = _f2_rows(rows)
    lam_full = np.concatenate([W, np.zeros((len(rows), 1), np.float32)], 1)
    xj, _ = JPF.pn_tv1_fused(jnp.asarray(Y), jnp.asarray(lam_full), tb=8)
    xp, _, _ = TPF.pn_tv1_fused_plain(torch.from_numpy(Y),
                                      torch.from_numpy(lam_full), tb=1)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-5)
    for i, r in enumerate(rows):
        ref = native.tv1w_host(Y[i], W[i])
        d = float(np.abs(np.asarray(xj)[i] - ref).max())
        assert abs(d - F2_CARD[r]) <= 1e-6, (r, d)


def _stream_rows(rows):
    """chip_smoke.py's F3 stream: RandomState(6) after the 4K image and
    F2's weights."""
    rng = np.random.RandomState(6)
    rng.randn(1, 2160, 3840)
    rng.rand(10000, 999)
    walk = rng.randn(8, 1_000_000)
    noise = rng.randn(8, 1_000_000)
    return (np.cumsum(walk[rows], axis=1) * 0.05
            + noise[rows]).astype(np.float32)


def test_float32_long_route_on_the_bench_stream_matches_jax():
    """Rows 3 and 5 of the stream at lam 0.7, float32 on the CPU: the port's
    solution within 1e-4 of the JAX package's, both certified (rc 0).  (Their
    float32 gaps, sums of 10^6 terms that cancel, part by ~1e-3 of the
    gap.)"""
    for y in _stream_rows([3, 5]):
        xp, ip = TL.tv1_long(torch.from_numpy(y), 0.7)
        xj, ij = JL.tv1_long(jnp.asarray(y), 0.7)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-4)
        assert int(ip.rc[0]) == 0 and int(np.asarray(ij.rc).ravel()[0]) == 0
