"""Port vs JAX package: the ND generalized-TV combiners, the chunked 3D
primal-dual solve and kernel B6's plain version, and 2D TV-Lp.

The JAX 3D driver runs its Pallas chunk kernel in interpret mode (float32);
the port's driver runs B6's plain version on the CPU.  The combiners run in
float64 on the CPU in both packages, so they agree to rounding with equal
iteration counts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from proxtv_tpu.models import tv2d as J2
from proxtv_tpu.models import tvnd as JN
from proxtv_tpu.ops.kernels import pdhg3d_fused as JK3
from proxtv_tpu.utils.config import DEFAULT_COMBINER as JCFG
from proxtv_tpu_torch.models import tv2d as P2
from proxtv_tpu_torch.models import tvnd as PN
from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as PK3
from proxtv_tpu_torch.utils.config import DEFAULT_COMBINER as PCFG

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


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("variant", ["cp-acc", "cp"])
def test_sched_chunk3_matches_jax_step_for_step(variant):
    """As the 2D schedule (tests/test_torch_pdhg.py): each step from the JAX
    row's carried pair emits JAX's sigma and tau exactly and the penalty
    columns exactly.  theta = 1/sqrt(1 + 2 tau) is within 1 float32 ulp of
    its float64 value in the port (numpy rounds the sqrt and the divide);
    XLA's fused float32 1/sqrt inside the JAX scan is off by up to 1 ulp the
    other way, so the two may sit 2 ulps apart."""
    sig0 = np.float32(0.7)
    lams = (0.3, 0.4, 0.35)
    rows_j, _ = JK3.sched_chunk3((jnp.float32(sig0), jnp.float32(0.9 / 8.4)),
                                 10, lams, jnp.float32(sig0), 3.3, variant)
    rows_j = np.asarray(rows_j)
    for i in range(10):
        rows_p, _ = PK3.sched_chunk3((rows_j[i, 0], rows_j[i, 1]), 1, lams,
                                     sig0, 3.3, variant)
        np.testing.assert_array_equal(rows_p[0, [0, 1, 3, 4, 5]],
                                      rows_j[i, [0, 1, 3, 4, 5]])
        if variant == "cp-acc" and rows_p[0, 2] != 1.0:
            a = np.float32(1.0) + np.float32(2.0) * rows_p[0, 1]
            exact = np.float32(1.0 / np.sqrt(np.float64(a)))
            assert _ulps(rows_p[0, 2], exact).max() <= 1, i
        assert _ulps(rows_p[0, 2], rows_j[i, 2]).max() <= 2, i
    sched = PK3.make_schedule3(10, lams, sig0, np.float32(0.9 / 8.4),
                               variant, cap_mult=3.3)
    assert sched.shape == (10, 6) and sched.dtype == np.float32
    np.testing.assert_array_equal(sched[:, 3:], rows_j[:, 3:])
    assert _ulps(sched, rows_j).max() <= 8


@pytest.mark.parametrize("variant", ["cp", "cp-acc", "condat"])
def test_pdhg3d_chunk_plain_matches_pallas_kernel(variant):
    """One chunk of B6's plain version vs the Pallas kernel on the JAX
    driver's canvas layout (gap layers, L and M halos, lane padding, NaN in
    the leading halo): 1e-5 on the cores, NaN in neither."""
    rng = np.random.RandomState(0)
    k, tl, tm = 2, 4, 8
    hl, hm = 2 * k, 8
    L, M, N, count = 3, 10, 9, 2
    S = L + 2
    Lp = -(-(count * S) // tl) * tl + 2 * hl
    Mp = -(-M // tm) * tm + 2 * hm
    f = [rng.randn(Lp, Mp, 128).astype(np.float32) for _ in range(6)]
    for a in f[:5]:
        a[:hl] = np.nan
    sched = PK3.make_schedule3(k, (0.3, 0.4, 0.35), np.float32(0.6),
                               np.float32(0.1), variant, 4.0)
    kw = dict(k_steps=k, n_valid=N, m_valid=M, l_valid=L, stride=S,
              count=count, pad_top=hl, pad_m=hm,
              grad_step=variant == "condat")
    outj = JK3.pdhg3d_chunk(jnp.asarray(sched), *(jnp.asarray(a) for a in f),
                            tl=tl, tm=tm, **kw)
    outp = PK3.pdhg3d_chunk(torch.from_numpy(sched),
                            *(torch.from_numpy(a) for a in f), **kw)
    core = (slice(hl, Lp - hl), slice(hm, Mp - hm))
    for a, b in zip(outp, outj):
        assert not torch.isnan(a[core]).any()
        np.testing.assert_allclose(a.numpy()[core], np.asarray(b)[core],
                                   atol=1e-5)


@pytest.mark.parametrize("variant", ["cp", "condat"])
def test_run_pdhg3d_fused_trajectory_matches_jax(variant):
    """gap_tol = 0 runs both drivers to the 48-iteration cap: the same
    iterates, at the bar of tests/test_pdhg3d.py:60-72."""
    rng = np.random.RandomState(1)
    Y = rng.randn(2, 5, 12, 9).astype(np.float32)
    lams = (0.35, 0.4, 0.3)
    xj, ij = JN._run_pdhg3d_fused(jnp.asarray(Y), lams, 48, JCFG, variant,
                                  gap_tol=0.0)
    xp, ip = PN._run_pdhg3d_fused(torch.from_numpy(Y), lams, 48, PCFG,
                                  variant, gap_tol=0.0)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=5e-5)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


def test_run_pdhg3d_fused_cp_acc_matches_jax():
    """cp-acc to the certificate with the JAX driver's K (same certificate
    cadence): equal iteration counts and return codes, and the solution of
    the JAX package's own convergence test (tests/test_pdhg3d.py:75-85)."""
    rng = np.random.RandomState(2)
    Y = rng.randn(2, 4, 10, 9).astype(np.float32)
    k, _, _ = JK3.best_params(128)
    xj, ij = JN._run_pdhg3d_fused(jnp.asarray(Y), (0.3, 0.3, 0.3), 4000,
                                  JCFG, "cp-acc")
    xp, ip = PN._run_pdhg3d_fused(torch.from_numpy(Y), (0.3, 0.3, 0.3), 4000,
                                  PCFG, "cp-acc", k_steps=k)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(ip.gap.numpy(), np.asarray(ij.gap), rtol=1e-2)


def test_run_pdhg3d_fused_options():
    """Zero penalties return Y certified at once; an explicit schedule equal
    to the auto-tuned one reproduces the auto run exactly; an objective
    target stops each volume as the JAX driver does."""
    rng = np.random.RandomState(3)
    Y = torch.from_numpy(rng.randn(1, 3, 9, 9).astype(np.float32))
    x, info = PN._run_pdhg3d_fused(Y, (0.0, 0.0, 0.0), 100, PCFG, "cp-acc")
    np.testing.assert_allclose(x.numpy(), Y.numpy(), atol=1e-7)
    assert np.all(info.rc.numpy() == 0)
    lams = (0.3, 0.4, 0.35)
    s0, cm = P2._pdhg_sigma_schedule(Y, max(lams), torch.float32)
    xa, ia = PN._run_pdhg3d_fused(Y, lams, 96, PCFG, "cp-acc", gap_tol=0.0)
    xo, io = PN._run_pdhg3d_fused(Y, lams, 96, PCFG, "cp-acc", gap_tol=0.0,
                                  schedule_override=(float(s0), float(cm)))
    np.testing.assert_array_equal(xa.numpy(), xo.numpy())
    np.testing.assert_array_equal(ia.iters.numpy(), io.iters.numpy())
    k, _, _ = JK3.best_params(128)
    xj, ij = JN._run_pdhg3d_fused(jnp.asarray(Y.numpy()), lams, 2500, JCFG,
                                  "cp-acc", obj_target=60.0)
    xp, ip = PN._run_pdhg3d_fused(Y, lams, 2500, PCFG, "cp-acc",
                                  obj_target=60.0, k_steps=k)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))


@pytest.mark.parametrize("method,ws,ds,ps", [
    ("pd", (0.35, 0.25, 0.3), (1, 2, 3), (1.0, 2.0, 1.0)),
    ("pd2", (0.35, 0.25), (1, 3), (1.0, 2.0)),
    ("pdr", (0.35, 0.25), (1, 3), (2.0, 2.0)),
    ("yang", (0.35, 0.25, 0.3), (1, 2, 3), (2.0, 1.0, 2.0)),
    ("pd", (0.4,), (2,), (2.0,)),
])
def test_tv_nd_batched_matches_jax(method, ws, ds, ps):
    rng = np.random.RandomState(4)
    Y = rng.randn(2, 6, 7, 8)
    xj, ij = JN.tv_nd_batched(jnp.asarray(Y), ws, ds, ps, method=method)
    xp, ip = PN.tv_nd_batched(torch.from_numpy(Y), ws, ds, ps, method=method)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
    np.testing.assert_array_equal(ip.rc.numpy(), np.asarray(ij.rc))


@pytest.mark.parametrize("shape,ws,ds,ps", [
    ((24,), [0.7], [1], [1.0]),
    ((10, 9), [0.4, 0.3], [2, 1], [2.0, 1.0]),
    ((5, 4, 3), [0.3] * 3, [1, 2, 3], [1.0, 2.0, 1.0]),
    ((5, 4, 3), [0.3, 0.2], [1, 3], [2.0, 1.0]),
])
def test_tvgen_dispatch_matches_jax(shape, ws, ds, ps):
    X = np.random.RandomState(5).randn(*shape)
    xj, ij = JN.tvgen_dispatch(jnp.asarray(X), ws, ds, ps)
    xp, ip = PN.tvgen_dispatch(torch.from_numpy(X), ws, ds, ps)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))


def test_tv_value_matches_jax():
    X = np.random.RandomState(6).randn(6, 5, 4)
    for ws, ds, ps in (([1.0, 2.0], [1, 2], [1.0, 2.0]),
                       ([0.5, 1.5, 2.0], [3, 1, 2], [1.5, 200.0, 1.0])):
        vj = JN.tv_value(X, ws, ds, ps)
        vp = PN.tv_value(torch.from_numpy(X), ws, ds, ps)
        np.testing.assert_allclose(float(vp), float(vj), rtol=1e-12)


@pytest.mark.parametrize("method", ["condat", "chambolle-pock",
                                    "chambolle-pock-acc"])
def test_primal_dual_nd_methods_raise_on_cpu(method):
    """As the JAX package off its accelerator (tvnd.py:547-552)."""
    Y = torch.from_numpy(np.random.RandomState(7).randn(1, 3, 4, 5))
    with pytest.raises(ValueError, match="primal-dual"):
        PN.tv_nd_batched(Y, (0.3,) * 3, (1, 2, 3), (1.0,) * 3, method=method)


def test_tv_nd_batched_rejects_bad_methods_and_p():
    Y = torch.zeros((1, 3, 4, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="pd2"):
        PN.tv_nd_batched(Y, (0.3,) * 3, (1, 2, 3), (1.0,) * 3, method="pd2")
    with pytest.raises(ValueError, match="Unknown"):
        PN.tv_nd_batched(Y, (0.3,) * 2, (1, 2), (1.0,) * 2, method="nope")


@pytest.mark.parametrize("ps", [(1.0, 2.0), (2.0, 2.0), (2.0, 1.0),
                                (1.5, 1.5), (3.0, 1.0)])
def test_tvp_2d_batched_matches_jax(ps):
    """p in {1, 2} to 1e-10 with equal sweep counts.  A TV-Lp axis: the
    first pass projects each fiber's zero dual, where the JAX package's
    joint Newton returns a NaN multiplier that degrades its later warm
    projections; the port keeps the warm multiplier (ROADMAP C), so the two
    reach the optimum by different paths and are held to the cross-method
    bar of tests/test_tv2d.py (1e-3).  At (0.5, 0.4) the JAX package's
    degraded fiber solves at p = 1.5 run toward their 10^6-iteration cap
    (minutes), so the TV-Lp cases take (0.2, 0.15)."""
    X = np.random.RandomState(8).randn(2, 9, 8)
    lp_case = not set(ps) <= {1.0, 2.0}
    lams = (0.2, 0.15) if lp_case else (0.5, 0.4)
    xj, ij = J2.tvp_2d_batched(jnp.asarray(X), *lams, *ps)
    xp, ip = P2.tvp_2d_batched(torch.from_numpy(X), *lams, *ps)
    if lp_case:
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-3)
        assert np.all(ip.rc.numpy() == 0)
        return
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_array_equal(ip.iters.numpy(), np.asarray(ij.iters))
