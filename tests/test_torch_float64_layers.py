"""Port vs JAX package: the float64 route of the layers above TV-L1 on the
card.

The JAX package's gate says no to every kernel for a float64 array, so a
float64 batch runs its compositions wherever it lies: the DP's lock-step
engine, the More-Sorensen TV-L2 composition (its shifted solves on the
Pallas PCR kernel on an accelerator, ``tv1d_l2.py:301-308``), the TV-Lp
compositions, the ND combiners over them, the long-signal windows by
``tv1_pn`` and the 2D backward's labelling loop.  The port takes the same
route for a float64 CUDA tensor: kernel D2 in float64 for the DP names,
B2 in float64 for every tridiagonal system up to 8192 lanes (TV-L2's with a
per-row shift), L1 in float64 for the 2D backward, and no B1, B4, B5 or
B6.

Here, without a card, ``gating.gate`` answers as it does for a CUDA
tensor and each kernel wrapper records its kernel, dtype and arguments
before running (on the CPU tensor) its plain version; the port's results
are held against the JAX package's float64 functions on the same
numpy-seeded inputs: the DP at 1e-12 (the direct engines' bar), TV-L2 and
TV-Lp at 1e-8, the 2D and ND combiners with p = 2 terms within 1e-6 of the
JAX package's same method, the long route at 1e-8 (tests/test_tv1d_long.py's
bar) and the 2D VJP at 1e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from proxtv_tpu.models import tv2d as J2
from proxtv_tpu.models import tvnd as JN
from proxtv_tpu.ops import diffprox as JD
from proxtv_tpu.ops import tv1d_l1 as J1
from proxtv_tpu.ops import tv1d_l2 as J2L
from proxtv_tpu.ops import tv1d_long as JL
from proxtv_tpu.ops import tv1d_lp as JLP
from proxtv_tpu_torch.models import tv2d as P2
from proxtv_tpu_torch.models import tvnd as PN
from proxtv_tpu_torch.ops import diffprox
from proxtv_tpu_torch.ops import tv1d_l1 as P1
from proxtv_tpu_torch.ops import tv1d_l2 as P2L
from proxtv_tpu_torch.ops import tv1d_long as PL
from proxtv_tpu_torch.ops import tv1d_lp as PLP
from proxtv_tpu_torch.ops.kernels import dp as DPK
from proxtv_tpu_torch.ops.kernels import gating
from proxtv_tpu_torch.ops.kernels import labels as LK
from proxtv_tpu_torch.ops.kernels import lp_fused as LPK
from proxtv_tpu_torch.ops.kernels import ms_fused as MSK
from proxtv_tpu_torch.ops.kernels import pcr as PK
from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as P3K
from proxtv_tpu_torch.ops.kernels import pn_fused as PNK

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)

F64 = torch.float64
LP_METHODS = ["gp", "ogp", "fista", "fw", "gpfw"]


@pytest.fixture
def card(monkeypatch):
    """gating.gate answers as for a CUDA tensor, and the kernel wrappers
    record (kernel, dtype, what rides along) before running their plain
    versions on the CPU tensor: B2 whether it got a mask or a shift."""
    monkeypatch.setattr(gating, "gate", lambda y, kind: gating.decide(
        kind, True, y.dtype, y.shape[-1]))
    calls = []
    for kid, mod, fn in (("B1", PNK, "pn_tv1_fused"),
                         ("B2", PK, "pcr_spd_solve"),
                         ("B4", MSK, "ms_tv2_fused"),
                         ("B5", LPK, "gpfw_fused"),
                         ("B6", P3K, "pdhg3d_chunk"),
                         ("D2", DPK, "dp"),
                         ("L1", LK, "component_labels")):
        orig = getattr(mod, fn)

        def rec(y, *a, kid_=kid, orig_=orig, **k):
            extra = ("mask" if k.get("mask") is not None else
                     "shift" if k.get("diag_shift") is not None else "")
            calls.append((kid_, y.dtype, extra))
            return orig_(y, *a, **k)

        monkeypatch.setattr(mod, fn, rec)
    return calls


def _kids(calls):
    return {c[0] for c in calls}


def _walks(seed, B, n):
    rng = np.random.RandomState(seed)
    return rng, rng.randn(B, n) + np.cumsum(rng.randn(B, n), axis=1) * 0.3


@pytest.mark.parametrize("lam_kind", ["scalar", "per_edge"])
def test_dp_names_take_d2_in_float64(lam_kind, card):
    """dp, kolmogorov and johnson, strict and not, scalar or per-edge
    weights: one D2 launch in float64 each (the JAX package runs its DP
    for all three on a float64 array), within 1e-12 of the JAX package's
    float64 tv1_dp."""
    rng, Y = _walks(3, 4, 60)
    lam = 0.6 if lam_kind == "scalar" else rng.rand(4, 59) * 1.2
    ref = np.asarray(J1.tv1_dp(jnp.asarray(Y), jnp.asarray(lam)))
    for m, strict in (("dp", False), ("dp", True), ("kolmogorov", True),
                      ("johnson", False)):
        card.clear()
        assert P1.tv1_route(m, lam, 4, 60, strict, is_cuda=True,
                            dtype=F64) == "dp"
        x = P1.tv1_batched(torch.from_numpy(Y), torch.as_tensor(lam)
                           if lam_kind == "per_edge" else lam, method=m,
                           strict=strict)
        assert card == [("D2", F64, "")], (m, strict, card)
        np.testing.assert_allclose(x.numpy(), ref, atol=1e-12, rtol=0,
                                   err_msg=m)


@pytest.mark.parametrize("engine", ["ms", "pg", "mspg", "batched"])
def test_tv2_float64_route_runs_b2_with_a_shift(engine, card):
    """TV-L2 on the card's float64 route: the More-Sorensen composition
    (B4 never), its shifted solves on B2 in float64 with a per-row shift
    (the JAX package's accelerator branch), scalar and per-row lam, within
    1e-8 of the JAX package's float64 engine of the same name."""
    rng, Y = _walks(5, 5, 200)
    for lam in (1.5, rng.rand(5) * 3.0):
        card.clear()
        jf = {"ms": J2L.tv2_ms, "pg": J2L.tv2_pg, "mspg": J2L.tv2_mspg,
              "batched": J2L.tv2_batched}[engine]
        pf = {"ms": P2L.tv2_ms, "pg": P2L.tv2_pg, "mspg": P2L.tv2_mspg,
              "batched": P2L.tv2_batched}[engine]
        lam_t = lam if np.ndim(lam) == 0 else torch.from_numpy(lam)
        x, info = pf(torch.from_numpy(Y), lam_t)
        xj, ij = jf(jnp.asarray(Y), jnp.asarray(lam))
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8,
                                   rtol=0)
        assert "B4" not in _kids(card)
        if engine != "pg":  # pg solves no system
            assert card and set(card) == {("B2", F64, "shift")}, card
        assert (info.rc.numpy() == np.asarray(ij.rc)).all()


def test_tv2_ms_float64_warm_start_and_long_rows(card):
    """The warm-started secular iteration (alpha carried) on the float64
    route within 1e-8 of the JAX package's, and a row of 9000 (8999
    lanes, past B2's 8192): the spectral route, with no B2 launch, as in
    float32."""
    rng, Y = _walks(9, 3, 150)
    _, _, a0 = P2L.tv2_ms(torch.from_numpy(Y), 2.0, return_alpha=True)
    card.clear()
    x, _, a = P2L.tv2_ms(torch.from_numpy(Y), 2.0, alpha_init=a0 * 0.7,
                         return_alpha=True)
    xj, _, aj = J2L.tv2_ms(jnp.asarray(Y), 2.0,
                           alpha_init=jnp.asarray(a0.numpy() * 0.7),
                           return_alpha=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=1e-8)
    assert set(card) == {("B2", F64, "shift")}
    _, y = _walks(10, 1, 9000)
    card.clear()
    x, info = P2L.tv2_ms(torch.from_numpy(y), 20.0)
    xj, _ = J2L.tv2_ms(jnp.asarray(y), 20.0)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8, rtol=0)
    assert card == [] and int(info.rc[0]) == 0


@pytest.mark.parametrize("p", [1.5, 3.0, 5.0])
def test_tvp_float64_route_has_no_b5(p, card):
    """Every TV-Lp engine on the card's float64 route: the compositions
    (B5 never; the setup solve on B2 in float64), within 1e-8 of the JAX
    package's float64 engine with equal iteration counts.  Pure FW gets a
    cap (SKILL.md's TV-Lp note), on both sides; p = 1 and p = 2 take the
    TV-L1 and TV-L2 routes."""
    Y = np.random.RandomState(0).randn(6, 16) * 2
    for m in LP_METHODS:
        card.clear()
        x, info = PLP.tvp_batched(torch.from_numpy(Y), 0.8, p, method=m,
                                  max_iters=2000)
        xj, ij = JLP.tvp_batched(jnp.asarray(Y), 0.8, p, method=m,
                                 max_iters=2000)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8,
                                   rtol=0, err_msg=m)
        np.testing.assert_array_equal(info.iters.numpy(),
                                      np.asarray(ij.iters))
        assert ("B2", F64, "") in card and _kids(card) == {"B2"}, (m, card)
    card.clear()
    PLP.tvp_batched(torch.from_numpy(Y), 0.8, 2.0)
    assert _kids(card) == {"B2"} and all(c[2] == "shift" for c in card)


@pytest.mark.parametrize("ps", [(2.0, 2.0), (1.0, 2.0), (1.5, 1.5)])
def test_tvp_2d_float64_route_matches_jax(ps, card):
    """tvp_2d_batched on the card's float64 route (fibers warm-started by
    tv1_pn, the TV-L2 and the TV-Lp compositions; B2 in float64, never B1,
    B4 or B5): p in {1, 2} within 1e-6 of the JAX package's float64 run
    with equal sweeps.  A p = 1.5 axis parts from the JAX package by its
    NaN-multiplier fault (ROADMAP C, _finite_mu), so it is held as
    tests/test_torch_tvnd.py holds it on the CPU: the cross-method bar of
    tests/test_tv2d.py (1e-3), at its lams, and rc 0."""
    X = np.random.RandomState(8).randn(2, 9, 8)
    lp_case = not set(ps) <= {1.0, 2.0}
    lams = (0.2, 0.15) if lp_case else (0.5, 0.4)
    x, info = P2.tvp_2d_batched(torch.from_numpy(X), *lams, *ps)
    xj, ij = J2.tvp_2d_batched(jnp.asarray(X), *lams, *ps)
    assert _kids(card) == {"B2"} and all(c[1] == F64 for c in card)
    if lp_case:
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-3)
        assert np.all(info.rc.numpy() == 0)
        return
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(info.iters.numpy(), np.asarray(ij.iters))


@pytest.mark.parametrize("method,ws,ds,ps", [
    ("pd", (0.35, 0.25, 0.3), (1, 2, 3), (1.0, 2.0, 1.0)),
    ("pd2", (0.35, 0.25), (1, 3), (1.0, 2.0)),
    ("pdr", (0.35, 0.25), (1, 3), (2.0, 2.0)),
    ("yang", (0.35, 0.25, 0.3), (1, 2, 3), (2.0, 1.0, 2.0)),
])
def test_tv_nd_float64_route_matches_jax(method, ws, ds, ps, card):
    """tv_nd_batched's combiners on the card's float64 route with p = 2
    terms (B2 in float64 for every fiber system, never B1, B4 or B6),
    within 1e-6 of the JAX package's float64 run of the same method, with
    equal sweeps, at the shapes of tests/test_torch_tvnd.py."""
    Y = np.random.RandomState(4).randn(2, 6, 7, 8)
    x, info = PN.tv_nd_batched(torch.from_numpy(Y), ws, ds, ps,
                               method=method)
    xj, ij = JN.tv_nd_batched(jnp.asarray(Y), ws, ds, ps, method=method)
    assert _kids(card) == {"B2"} and all(c[1] == F64 for c in card)
    assert {c[2] for c in card} == ({"mask", "shift"} if 1.0 in ps
                                    else {"shift"})
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(info.iters.numpy(), np.asarray(ij.iters))


@pytest.mark.parametrize("layer", ["tv1_pn", "tv2", "tvp"])
def test_two_sample_signals_take_the_float64_route(layer, card,
                                                   monkeypatch):
    """A signal of two samples on the card's float64 route: its one-lane
    systems (tv1_pn's and TV-Lp's setup solve, TV-L2's shifted solves)
    have nothing to reduce and are solved in closed form, as the JAX
    package's gate sends them below the PCR kernel's lower limit (no
    kernel launches), within 1e-10 of the JAX package's float64 engine;
    and as the columns of a 2 x 9 image under tvp_2d_batched (its rows
    on B2 in float64), within 1e-10 of the same call on the CPU."""
    rng = np.random.RandomState(12)
    Y = rng.randn(5, 2) * 2
    pf, jf = {"tv1_pn": (lambda y: P1.tv1_pn(y, 0.3),
                         lambda y: J1.tv1_pn(y, 0.3)),
              "tv2": (lambda y: P2L.tv2_batched(y, 0.8),
                      lambda y: J2L.tv2_batched(y, 0.8)),
              "tvp": (lambda y: PLP.tvp_batched(y, 0.8, 1.5),
                      lambda y: JLP.tvp_batched(y, 0.8, 1.5))}[layer]
    x, _ = pf(torch.from_numpy(Y))
    xj, _ = jf(jnp.asarray(Y))
    assert card == []
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-10, rtol=0)
    p = {"tv1_pn": 1.0, "tv2": 2.0, "tvp": 1.5}[layer]
    X = torch.from_numpy(rng.randn(1, 2, 9))
    x2, _ = P2.tvp_2d_batched(X, 0.3, 0.2, p, p)
    assert _kids(card) <= {"B2"} and all(c[1] == F64 for c in card)
    monkeypatch.setattr(gating, "gate", lambda y, kind: False)  # the CPU's
    ref, _ = P2.tvp_2d_batched(X, 0.3, 0.2, p, p)
    np.testing.assert_allclose(x2.numpy(), ref.numpy(), atol=1e-10, rtol=0)


def test_tv1_long_float64_route_matches_jax(card):
    """The long-signal route on the card's float64 route, at n = 1500 with
    the JAX tests' chunk 512 and overlap 128 (three windows): the windows
    by tv1_pn, their masked Newton systems on B2 in float64 (no B1),
    within 1e-8 of the JAX package's float64 tv1_long, rc 0 on both."""
    rng = np.random.RandomState(0)
    y = np.cumsum(rng.randn(1500)) * 0.05 + rng.randn(1500)
    x, info = PL.tv1_long(torch.from_numpy(y), 0.7, chunk=512, overlap=128)
    xj, ij = JL.tv1_long(jnp.asarray(y), 0.7, chunk=512, overlap=128)
    # tv1_pn's dual start (unmasked) and its Newton systems (masked)
    assert {c[1:] for c in card} == {(F64, ""), (F64, "mask")}, card
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8, rtol=0)
    assert int(info.rc[0]) == 0 and int(np.asarray(ij.rc)[0]) == 0


@pytest.mark.parametrize("method,iters", [("dr", 300), ("chambolle-pock-acc",
                                                        0)])
def test_tv2d_prox_float64_vjp_matches_jax(method, iters, card):
    """tv2d_prox on the card's float64 route: the forward on tv1_pn (dr:
    B2 in float64) or the unfused primal-dual iteration (cp-acc), the
    backward one L1 call in float64; the VJP within 1e-10 of the JAX
    package's (the bar of tests/test_diffprox.py:46-49), lam's gradient
    zero."""
    rng = np.random.RandomState(0)
    Y = rng.randn(2, 10, 9)
    g = rng.randn(2, 10, 9)

    def fj(y):
        return jnp.sum(JD.tv2d_prox(y, 0.5, method, iters) * g)

    gyj = jax.grad(fj)(jnp.asarray(Y))
    y_t = torch.tensor(Y, requires_grad=True)
    lam_t = torch.tensor(0.5, dtype=F64, requires_grad=True)
    x = diffprox.tv2d_prox(y_t, lam_t, method, iters)
    card.clear()
    (x * torch.from_numpy(g)).sum().backward()
    assert card == [("L1", F64, "")]
    np.testing.assert_allclose(y_t.grad.numpy(), np.asarray(gyj), atol=1e-10,
                               rtol=0)
    assert float(lam_t.grad) == 0.0
