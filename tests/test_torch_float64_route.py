"""Port vs JAX package: the float64 route of the batched TV-L1 layers.

The JAX package's gate says no to every kernel for a float64 array ("f32
by design (f64 runs use the XLA compositions)"), so a float64 batch runs
its compositions and named engines wherever it lies.  The port takes the
same route for a float64 CUDA batch, with kernels B2 (the Newton systems
of ``tv1_pn``), D1, D2, D3 and D4 in float64 (``ops/kernels/gating.py``).
The other layers' float64 route (TV-L2, TV-Lp, ND, the long signals, the
2D backward) is held in tests/test_torch_float64_layers.py.

Here, without a card, the route is asked of ``gating.decide`` and
``tv1d_l1.tv1_route`` (the decision ``tv1_batched`` and the 2D combiners
make for a CUDA tensor) and pinned against the JAX package's code; then the
port runs that route on float64 CPU tensors, ``gating.gate`` answering as
it does for a CUDA tensor (each kernel's wrapper, given a CPU tensor, runs
its plain version), and its results are held against the JAX package's in
float64: the direct engines at 1e-12, ``tv1_pn`` at 5e-4 (the oracle bar
of tests/test_tv1d_l1.py), the 2D methods within 1e-6 of the JAX package's
run of the same method and within 1e-3 of dr (tests/test_tv2d.py's
cross-method bar).  Inputs are made from seeds with numpy.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proxtv_tpu.models import tv2d as J2
from proxtv_tpu.ops import tv1d_l1 as J
from proxtv_tpu.ops.kernels import gating as JG
from proxtv_tpu_torch.models import tv2d as P2
from proxtv_tpu_torch.ops import tv1d_l1 as P
from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
from proxtv_tpu_torch.ops.kernels import condat as CDK
from proxtv_tpu_torch.ops.kernels import dp as DPK
from proxtv_tpu_torch.ops.kernels import gating
from proxtv_tpu_torch.ops.kernels import pcr as PK
from proxtv_tpu_torch.ops.kernels import pn_fused as PNK
from proxtv_tpu_torch.ops.kernels import tautstring as TSK

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)

F64 = torch.float64
METHODS = ["classictautstring", "linearizedtautstring", "hybridtautstring",
           "pn", "condat", "dp", "condattautstring", "kolmogorov", "johnson",
           "tautstring"]
# The port's engine names and the JAX package's functions they mirror.
JAX_ENGINE = {"tautstring": "tv1_tautstring", "dp": "tv1_dp",
              "condat": "tv1_condat", "classic_ts": "tv1_classic_ts",
              "tv1_pn": "tv1_pn"}
# The kernel each engine launches on a float64 CUDA batch (tv1_pn: its
# Newton systems).
F64_KERNEL = {"tautstring": "D1", "condat": "D3", "classic_ts": "D4",
              "tv1_pn": "B2", "dp": "D2"}
METHODS_2D = ["dr", "pd", "yang", "kolmogorov", "condat", "chambolle-pock",
              "chambolle-pock-acc"]


def _jax_engine(method, strict, lam, monkeypatch):
    """The engine the JAX package's tv1_batched runs for a float64 batch:
    its engines replaced by recorders, its own gate answering."""
    calls = []
    y = jnp.zeros((3, 16))
    for name in JAX_ENGINE.values():
        ret = (y, None) if name == "tv1_pn" else y
        monkeypatch.setattr(J, name, lambda *a, n_=name, r_=ret, **k:
                            calls.append(n_) or r_)
    try:
        J.tv1_batched(y, lam, method=method, strict=strict)
    except ValueError as e:
        return f"raise: {e}"
    finally:
        monkeypatch.undo()
    assert len(calls) == 1, calls
    return calls[0]


@pytest.fixture
def card_route(monkeypatch):
    """gating.gate answers as for a CUDA tensor (decide with is_cuda), and
    the kernel wrappers record their calls and dtypes before running (on a
    CPU tensor) their plain versions."""
    monkeypatch.setattr(gating, "gate", lambda y, kind: gating.decide(
        kind, True, y.dtype, y.shape[-1]))
    calls = []
    for kid, mod, fn in (("B1", PNK, "pn_tv1_fused"), ("B2", PK,
                         "pcr_spd_solve"), ("D1", TSK, "tautstring"),
                         ("D2", DPK, "dp"), ("D3", CDK, "condat"),
                         ("D4", CTK, "classic_ts")):
        orig = getattr(mod, fn)

        def rec(y, *a, kid_=kid, orig_=orig, **k):
            calls.append((kid_, y.dtype))
            return orig_(y, *a, **k)

        monkeypatch.setattr(mod, fn, rec)
    for name in ("_run_pdhg", "_run_pdhg_fused"):
        orig = getattr(P2, name)

        def rec2(*a, name_=name, orig_=orig, **k):
            calls.append((name_, a[0].dtype))
            return orig_(*a, **k)

        monkeypatch.setattr(P2, name, rec2)
    return calls


def _signals(seed, B, n):
    rng = np.random.RandomState(seed)
    return rng, rng.randn(B, n) * 2 + np.cumsum(rng.randn(B, n), axis=1) * 0.3


def test_gate_float64_rules():
    """The gate's float64 rule for each family: the composing families (and
    pdhg3d, whose ND caller raises as the JAX package's does) say "not
    this kernel" at any length, the five built in double take it (B2
    composes past its lane limit, as in float32), and every family has one
    of these rules.  The JAX package's gate says no to every family for a
    float64 array."""
    y64 = jnp.zeros((2, 64), jnp.float64)
    for kind in gating._KIND_LANE_LIMITS:
        if kind in JG._KIND_LANE_LIMITS:
            assert JG.gate(y64, kind) is False
        for n in (64, 9000):
            if kind not in gating.F64_KERNELS:
                assert gating.decide(kind, True, F64, n) is False
            else:
                want = not (kind == "pcr" and n > 8192)
                assert gating.decide(kind, True, F64, n) is want
            assert gating.decide(kind, False, F64, n) is False
    assert gating.F64_KERNELS == {"pcr", "tautstring", "dp", "condat",
                                  "classic"}
    assert gating.F64_COMPOSES == {"pn", "pn_window", "pdhg2d", "ms", "lp"}
    assert (set(gating._KIND_LANE_LIMITS) - gating.F64_KERNELS
            - gating.F64_COMPOSES) == {"pdhg3d"}
    # float32 keeps its rules; other dtypes raise on the card.
    assert gating.decide("pn", True, torch.float32, 1000) is True
    assert gating.decide("pn", True, torch.float32, 9000) is False
    with pytest.raises(ValueError, match="float32"):
        gating.decide("tautstring", True, torch.float16, 1000)
    with gating.fused_ctx(False), pytest.raises(RuntimeError):
        gating.decide("tautstring", True, F64, 1000)


@pytest.mark.parametrize("lam_kind", ["scalar", "edge"])
def test_tv1_route_float64_matches_jax(lam_kind, monkeypatch):
    """Every tv1_batched name, strict or not, scalar or per-edge weights:
    the engine a float64 CUDA batch takes (tv1_route) is the engine the JAX
    package's tv1_batched runs for a float64 array, and each launches its
    kernel's float64 instantiation (the DP's names kernel D2).  A float32
    CUDA batch inside B1's lane limit takes B1 unless strict (the JAX
    package's TPU route)."""
    B, n = 3, 16
    lam = 0.5 if lam_kind == "scalar" else np.full((B, n - 1), 0.5)
    for m in METHODS:
        for strict in (False, True):
            want = _jax_engine(m, strict, lam if lam_kind == "scalar"
                               else jnp.asarray(lam), monkeypatch)
            try:
                got = P.tv1_route(m, lam, B, n, strict, is_cuda=True,
                                  dtype=F64)
            except ValueError as e:
                got = f"raise: {e}"
            if want.startswith("raise"):
                assert got.startswith("raise"), (m, strict, got)
                assert "unweighted" in got
                continue
            assert JAX_ENGINE[got] == want, (m, strict, got, want)
            assert F64_KERNEL[got] is not None
            f32 = P.tv1_route(m, lam, B, n, strict, is_cuda=True,
                              dtype=torch.float32)
            assert f32 == ("pn_fused" if m == "pn" or not strict else got)
            assert P.tv1_route(m, lam, B, n, strict) == got  # the CPU's


def test_tv1_batched_float64_card_route_matches_jax(card_route):
    """Every name through tv1_batched on the card's float64 route (the
    direct engines' and B2's plain versions on the CPU): the kernel each
    call would launch in float64, and the result against the JAX package's
    float64 tv1_batched (1e-12 the direct engines, the DP's names on D2
    among them; 5e-4 tv1_pn)."""
    _, Y = _signals(7, 3, 50)
    for m in METHODS:
        for strict in (False, True):
            card_route.clear()
            engine = P.tv1_route(m, 0.6, 3, 50, strict, is_cuda=True,
                                 dtype=F64)
            x = P.tv1_batched(torch.from_numpy(Y), 0.6, method=m,
                              strict=strict)
            kids = {c[0] for c in card_route}
            assert kids == {F64_KERNEL[engine]}, (m, strict, card_route)
            assert all(c[1] == F64 for c in card_route)
            ref = np.asarray(J.tv1_batched(jnp.asarray(Y), 0.6, method=m,
                                           strict=strict))
            np.testing.assert_allclose(x.numpy(), ref,
                                       atol=5e-4 if m == "pn" else 1e-12,
                                       rtol=0, err_msg=m)


def test_tv1_pn_float64_card_route_matches_jax(card_route):
    """tv1_pn on a float64 batch: its dual start and Newton systems on B2
    in float64 (the plain version here), scalar and per-edge weights,
    against the JAX package's float64 tv1_pn within 5e-4."""
    rng, Y = _signals(11, 4, 300)
    W = rng.rand(4, 299) * 1.5
    for lam in (0.8, W):
        card_route.clear()
        x, info = P.tv1_pn(torch.from_numpy(Y), torch.as_tensor(lam))
        assert card_route and {c for c in card_route} == {("B2", F64)}
        xj, _ = J.tv1_pn(jnp.asarray(Y), jnp.asarray(lam))
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=5e-4,
                                   rtol=0)
        assert (info.rc.numpy() == 0).all()


def test_classic_ts_float64_walk_matches_jax_condat():
    """D4's float64 route (its plain version) on a walk drawn as the
    n = 11621 walk of ROADMAP C is drawn (seed 15, lam 1.3), at n = 2000,
    the longest the test's time allows (the plain version runs ~5 n
    lock-step events): within 1e-9 of the JAX package's float64 Condat;
    float32 lands ~1e-6 relative to the prefix sums' size here and 8.97e-3
    at 11621.  The card holds the n = 11621 walk (chip_smoke.py, and
    tests/test_torch_cuda.py)."""
    n = 2000
    rng = np.random.RandomState(15)
    y = np.cumsum(rng.randn(n)) * 0.3 + rng.randn(n)
    x = P.tv1_classic_ts(torch.from_numpy(y[None]), 1.3).numpy()
    ref = np.asarray(J.tv1_condat(jnp.asarray(y[None]), 1.3))
    np.testing.assert_allclose(x, ref, atol=1e-9, rtol=0)


def test_tv2d_float64_route_matches_jax():
    """The 2D combiners' float64 route: the JAX package's fused predicates
    are false for a float64 image (fibers by tv1_pn, the primal-dual
    methods by _run_pdhg), and the port's gate says the same for a float64
    CUDA image at any size."""
    Y64 = jnp.zeros((1, 64, 64), jnp.float64)
    assert not J2._fused_ok(Y64[0], 1.0, "pn")
    for v in ("condat", "cp", "cp-acc"):
        assert not J2._pdhg_fused_ok(Y64, v)
    for n in (2, 64, 8192, 9000):
        assert gating.decide("pn", True, F64, n) is False
        assert gating.decide("pdhg2d", True, F64, n) is False


@pytest.mark.parametrize("method", METHODS_2D)
def test_tv1_2d_batched_float64_card_route_matches_jax(method, card_route):
    """Each 2D method on the card's float64 route: the fiber methods launch
    B2 in float64 and never B1, the primal-dual methods run _run_pdhg (no
    kernel); within 1e-6 of the JAX package's float64 run of the same
    method (equal iteration counts), and within 1e-3 of the port's dr on
    the same route."""
    rng = np.random.RandomState(0)
    Y = rng.randn(2, 12, 10)
    lam = 0.35
    cap = 300 if method in ("condat", "chambolle-pock") else 0
    x, info = P2.tv1_2d_batched(torch.from_numpy(Y), lam, method=method,
                                max_iters=cap)
    kids = {c[0] for c in card_route}
    if method in ("dr", "pd", "yang", "kolmogorov"):
        assert kids == {"B2"}, card_route
    else:
        assert kids == {"_run_pdhg"}, card_route
    assert all(c[1] == F64 for c in card_route)
    xj, ij = J2.tv1_2d_batched(jnp.asarray(Y), lam, method=method,
                               max_iters=cap)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(info.iters.numpy(), np.asarray(ij.iters))
    # The cross-method bar at tests/test_tv2d.py's caps.
    caps = {m: 1000 if m in ("dr", "pd", "yang") else 2500
            for m in METHODS_2D}
    xdr, _ = P2.tv1_2d_batched(torch.from_numpy(Y), lam, method="dr",
                               max_iters=caps["dr"])
    xm, _ = P2.tv1_2d_batched(torch.from_numpy(Y), lam, method=method,
                              max_iters=caps[method])
    np.testing.assert_allclose(xm.numpy(), xdr.numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("method", ["dr", "kolmogorov", "chambolle-pock-acc"])
def test_tv1w_2d_batched_float64_card_route_matches_jax(method, card_route):
    """The weighted 2D combiner on the card's float64 route: dr and
    kolmogorov launch B2 in float64 (per-edge fibers by tv1_pn) within
    1e-6 of the JAX package's float64 run; the weighted primal-dual
    methods raise in both packages (no fused path for float64)."""
    rng = np.random.RandomState(5)
    B, M, N = 2, 9, 8
    Y = rng.randn(B, M, N)
    Wc = 0.3 * (0.5 + rng.rand(B, M - 1, N))
    Wr = 0.3 * (0.5 + rng.rand(B, M, N - 1))
    if method == "chambolle-pock-acc":
        with pytest.raises(ValueError):
            P2.tv1w_2d_batched(torch.from_numpy(Y), torch.from_numpy(Wc),
                               torch.from_numpy(Wr), method=method)
        with pytest.raises(ValueError):
            J2.tv1w_2d_batched(jnp.asarray(Y), jnp.asarray(Wc),
                               jnp.asarray(Wr), method=method)
        assert card_route == []
        return
    x, info = P2.tv1w_2d_batched(torch.from_numpy(Y), torch.from_numpy(Wc),
                                 torch.from_numpy(Wr), method=method)
    assert {c for c in card_route} == {("B2", F64)}
    xj, ij = J2.tv1w_2d_batched(jnp.asarray(Y), jnp.asarray(Wc),
                                jnp.asarray(Wr), method=method)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(info.iters.numpy(), np.asarray(ij.iters))


def test_queued_float64_routes_raise_on_the_card(card_route):
    """What refuses float64 on the card, as the JAX package does: the ND
    primal-dual methods raise the JAX package's own ValueError (it has no
    float64 primal-dual ND route; the port's gate says "not this kernel"
    for pdhg3d, as the JAX gate does), before any kernel or composition
    runs; the banded 2D and 3D drivers raise naming kernels B3 and B6
    before any exchange (the JAX package's banded drivers take float32
    only: their kernels write float32).  The routes
    that raised before this slice (D2, TV-L2, TV-Lp, the long windows) are
    held in tests/test_torch_float64_layers.py."""
    from proxtv_tpu.models import tvnd as JN
    from proxtv_tpu_torch.models import tvnd
    from proxtv_tpu_torch.parallel import sharded
    from proxtv_tpu_torch.parallel.comm import Mesh

    V = np.zeros((1, 3, 4, 5))
    for method in ("condat", "chambolle-pock", "chambolle-pock-acc"):
        with pytest.raises(ValueError, match="primal-dual ND methods need"
                           ) as e:
            tvnd.tv_nd_batched(torch.from_numpy(V), (0.3,) * 3, (1, 2, 3),
                               (1.0,) * 3, method=method)
        with pytest.raises(ValueError, match="primal-dual ND methods need"
                           ) as ej:
            JN.tv_nd_batched(jnp.asarray(V), (0.3,) * 3, (1, 2, 3),
                             (1.0,) * 3, method=method)
        assert "method='pd', 'pdr' or 'yang'" in str(e.value)
        assert "method='pd', 'pdr' or 'yang'" in str(ej.value)
    assert card_route == []
    # The mesh is never asked for its rank: the refusal comes first.
    mesh = Mesh(group=None, axis="x", device=torch.device("cuda"))
    cases = {
        "B3": lambda: sharded.tv1_2d_banded(np.zeros((8, 9)), 0.3, mesh),
        "B3w": lambda: sharded.tv1w_2d_banded(
            np.zeros((8, 9)), np.ones((7, 9)), np.ones((8, 8)), mesh),
        "B6": lambda: sharded.tv1_3d_banded(np.zeros((4, 5, 6)), 0.3, mesh),
    }
    for kid, fn in cases.items():
        with pytest.raises(ValueError, match="banded driver takes float32 "
                           "only") as e:
            fn()
        assert kid[:2] in str(e.value)
    # float32 passes the refusal (its geometry then needs a process group).
    gating.refuse_banded_f64("tv1_2d_banded", "pdhg2d", "cuda",
                             torch.float32)
    gating.refuse_banded_f64("tv1_2d_banded", "pdhg2d", "cpu", F64)
