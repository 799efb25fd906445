"""Port vs JAX package: the numpy API in float64 on the card, and the layers
below it independent of torch's default dtype.

The JAX package's API computes in JAX's default float: with
``jax_enable_x64`` every entry point runs float64 on its accelerator, and
``tv1_2d`` auto picks dr there (the fused primal-dual only for float32,
``proxtv_tpu/api.py:241-244``).  The port's counterpart of that switch is
torch's default dtype: under ``torch.set_default_dtype(torch.float64)``
every entry point solves on the card in float64 (``api._dtype``), on the
float64 route of the batched layers (the kernels' double instantiations).
With ``device="cpu"`` it solves in float64 whatever the default.

Here, without a card: the dtype rule; the route each entry point takes on
the card in float64, with ``gating.gate`` answering as it does for a CUDA
tensor and each kernel wrapper recording its kernel and dtype before
running (on the CPU tensor) its plain version, held within
``chip_smoke.py``'s ``TOL64`` bar for the call's family of the same call
with ``device="cpu"``; the ``device="cpu"`` API bit for bit under both
defaults and against the JAX package's API (x64) at the bars of
tests/test_torch_api.py; and float32 batches through the batched layers bit
for bit under both defaults, on the CPU's route and on the card's (the
wrappers' argument handling included).  Inputs are made from seeds with
numpy.
"""
import numpy as np
import pytest
import torch

import proxtv_tpu as jptv
import proxtv_tpu_torch as ptv
from proxtv_tpu_torch import api
from proxtv_tpu_torch.models import tv2d, tvnd
from proxtv_tpu_torch.ops import diffprox, tv1d_l1, tv1d_l2, tv1d_long
from proxtv_tpu_torch.ops import tv1d_lp
from proxtv_tpu_torch.ops.kernels import classic_ts as CTK
from proxtv_tpu_torch.ops.kernels import condat as CDK
from proxtv_tpu_torch.ops.kernels import dp as DPK
from proxtv_tpu_torch.ops.kernels import gating
from proxtv_tpu_torch.ops.kernels import labels as LK
from proxtv_tpu_torch.ops.kernels import lp_fused as LPK
from proxtv_tpu_torch.ops.kernels import ms_fused as MSK
from proxtv_tpu_torch.ops.kernels import pcr as PK
from proxtv_tpu_torch.ops.kernels import pdhg3d_fused as P3K
from proxtv_tpu_torch.ops.kernels import pdhg_fused as PPK
from proxtv_tpu_torch.ops.kernels import pn_fused as PNK
from proxtv_tpu_torch.ops.kernels import tautstring as TSK

# Tier-1 runs several test processes on the machine's cores at once: one
# intra-op thread each, or every process's spinning thread pool slows the
# others' many small tensor ops (by ~20x under load).
torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
WRAPPERS = (("B1", PNK, "pn_tv1_fused"), ("B2", PK, "pcr_spd_solve"),
            ("B3", PPK, "pdhg_chunk"), ("B4", MSK, "ms_tv2_fused"),
            ("B5", LPK, "gpfw_fused"), ("B6", P3K, "pdhg3d_chunk"),
            ("D1", TSK, "tautstring"), ("D2", DPK, "dp"),
            ("D3", CDK, "condat"), ("D4", CTK, "classic_ts"),
            ("L1", LK, "component_labels"))
# chip_smoke.py's TOL64 bars, by family, for a float64 call on the card
# against the same call with device="cpu": the direct engines 1e-12 of the
# data's size (bit for bit but where the degenerate guards sum in another
# order), tv1_pn 5e-4 (tests/test_tv1d_l1.py's oracle bar), the 2D calls
# 1e-6 (dr at 256^2), TV-L2 / TV-Lp 1e-8, the ND combiners and the long
# route 1e-6, all relative to max|y|.
TOL64 = {"direct": 1e-12, "pn": 5e-4, "2d": 1e-6, "route": 1e-8,
         "combiner": 1e-6}


@pytest.fixture
def default64():
    """torch's default dtype set to float64 for the test, and restored."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


def _record(monkeypatch, as_card):
    """Each kernel wrapper records (kernel, dtype) before running its plain
    version on the CPU tensor; with ``as_card``, ``gating.gate`` answers as
    it does for a CUDA tensor of the same dtype and length."""
    if as_card:
        monkeypatch.setattr(gating, "gate", lambda y, kind: gating.decide(
            kind, True, y.dtype, y.shape[-1]))
    calls = []
    for kid, mod, fn in WRAPPERS:
        orig = getattr(mod, fn)

        def rec(y, *a, kid_=kid, orig_=orig, **k):
            calls.append((kid_, y.dtype))
            return orig_(y, *a, **k)

        monkeypatch.setattr(mod, fn, rec)
    return calls


class _On:
    """The entry points of ``module`` with ``kw`` added to every call."""

    def __init__(self, module, **kw):
        self.module, self.kw = module, kw

    def __getattr__(self, name):
        fn = getattr(self.module, name)
        return lambda *a, **k: fn(*a, **{**k, **self.kw})


def _data():
    rng = np.random.RandomState(40)
    return dict(
        y=np.cumsum(rng.randn(300)) * 0.3 + 0.2 * rng.randn(300),
        w=rng.rand(299) * 1.5,
        ylong=np.cumsum(rng.randn(20000)) * 0.3 + rng.randn(20000),
        y9=np.cumsum(rng.randn(9000)) * 0.05 + rng.randn(9000),
        X=rng.randn(24, 20), Wc=0.3 * (0.5 + rng.rand(23, 20)),
        Wr=0.3 * (0.5 + rng.rand(24, 19)), V=rng.randn(4, 8, 8),
        X8=np.random.RandomState(8).randn(2, 9, 8)[0])


# Every entry point at a small size: name -> (call(api module, data, b),
# the kernels of its float64 route on the card, its TOL64 family, its bar
# against the JAX API on the CPU (tests/test_torch_api.py's)).  ``b``: the
# keywords a taut-string call takes to stay on the device route with
# device="cpu" (backend="cuda"; the card's auto never takes the host).
API_CASES = {
    "tv1_1d auto": (lambda m, d, b: m.tv1_1d(d["y"], 2.0, **b), {"D1"},
                    "direct", 1e-12),
    "tv1_1d auto long": (lambda m, d, b: m.tv1_1d(d["ylong"], 2.0),
                         {"B2"}, "combiner", 1e-8),
    "tv1_1d pn": (lambda m, d, b: m.tv1_1d(d["y"], 2.0, method="pn"),
                  {"B2"}, "pn", 1e-8),
    "tv1_1d condat": (lambda m, d, b: m.tv1_1d(d["y"], 2.0, method="condat",
                                               **b), {"D3"}, "direct",
                      1e-12),
    "tv1_1d classictautstring": (
        lambda m, d, b: m.tv1_1d(d["y"], 2.0, method="classictautstring",
                                 **b), {"D4"}, "direct", 1e-12),
    "tv1_1d dp": (lambda m, d, b: m.tv1_1d(d["y"], 2.0, method="dp"),
                  {"D2"}, "direct", 1e-12),
    "tv1w_1d auto": (lambda m, d, b: m.tv1w_1d(d["y"], d["w"], **b), {"D1"},
                     "direct", 1e-12),
    "tv1w_1d dp": (lambda m, d, b: m.tv1w_1d(d["y"], d["w"], method="dp"),
                   {"D2"}, "direct", 1e-12),
    "tv1w_1d pn": (lambda m, d, b: m.tv1w_1d(d["y"], d["w"], method="pn"),
                   {"B2"}, "pn", 1e-8),
    "tv2_1d": (lambda m, d, b: m.tv2_1d(d["y"], 2.0), {"B2"}, "route",
               1e-8),
    "tv2_1d ms spectral": (lambda m, d, b: m.tv2_1d(d["y9"], 50.0,
                                                    method="ms"), set(),
                           "route", 1e-8),
    "tvp_1d": (lambda m, d, b: m.tvp_1d(d["y"], 2.0, 1.5), {"B2"}, "route",
               1e-8),
    "tv1_2d auto": (lambda m, d, b: m.tv1_2d(d["X"], 0.3), {"B2"}, "2d",
                    1e-8),
    "tv1w_2d": (lambda m, d, b: m.tv1w_2d(d["X"], d["Wc"], d["Wr"]), {"B2"},
                "2d", 1e-8),
    "tvp_2d p2": (lambda m, d, b: m.tvp_2d(d["X"], 0.3, 0.3, 2, 2), {"B2"},
                  "2d", 1e-8),
    # tests/test_torch_tvnd.py's TV-Lp 2D case: there the JAX package's
    # NaN multiplier (ROADMAP C) sends the two packages to the optimum by
    # different paths, held at the cross-method bar (1e-3).
    "tvp_2d p1.5": (lambda m, d, b: m.tvp_2d(d["X8"], 0.2, 0.15, 1.5, 1.5),
                    {"B2"}, "2d", 1e-3),
    "tvgen": (lambda m, d, b: m.tvgen(d["V"], [0.3] * 3, [1, 2, 3], [1] * 3,
                                      max_iters=35), {"B2"}, "combiner",
              1e-8),
    "tvgen_nd pd": (lambda m, d, b: m.tvgen_nd(d["V"], [0.3] * 3, [1, 2, 3],
                                               [1.0] * 3, max_iters=35),
                    {"B2"}, "combiner", 1e-8),
    "tv_value": (lambda m, d, b: m.tv_value(d["V"], [0.3, 0.2, 0.4],
                                            [1, 2, 3], [1.0, 2.0, 1.5]),
                 set(), "route", 1e-12),
}


def test_dtype_helper_follows_the_default_dtype(monkeypatch):
    """api._dtype: the card float32 under a float32 default and float64
    under a float64 default, the CPU float64 under both; _device and
    _host_route (the host engine's result dtype) and the layers' weight
    take it."""
    from proxtv_tpu_torch.models.layers import TVDenoise1D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    before = torch.get_default_dtype()
    try:
        for default in (F32, F64):
            torch.set_default_dtype(default)
            assert api._dtype(cuda) == default
            assert api._dtype(cpu) == F64
            assert api._device(None) == (cuda, default)
            assert api._device("cuda") == (cuda, default)
            assert api._device("cpu") == (cpu, F64)
            for dev, want in ((None, default), ("cpu", F64)):
                take, dt = api._host_route("host", dev, "hybridtautstring",
                                           api._TAUTSTRING_METHODS, False,
                                           True, 300)
                assert take and dt == (np.float64 if want == F64
                                       else np.float32)
            assert TVDenoise1D(device="cpu").raw_lam.dtype == F64
    finally:
        torch.set_default_dtype(before)
    with pytest.raises(ValueError, match="unsupported device"):
        api._device("meta")


def test_tv1_2d_auto_picks_dr_in_float64():
    """tv1_2d's auto: the fused accelerated primal-dual only on the card in
    float32 (the JAX package's accelerator rule), dr in float64 on the card
    and on the CPU."""
    assert api._tv1_2d_auto(True, F32) == "chambolle-pock-acc"
    assert api._tv1_2d_auto(True, F64) == "dr"
    assert api._tv1_2d_auto(False, F64) == "dr"
    assert api._tv1_2d_auto(False, F32) == "dr"


def test_api_1d_routes_asked_without_a_card():
    """The engines the 1D entry points reach on the card in float64,
    asked of tv1_route and gating.decide: tv1_1d auto (tv1_batched, not
    strict) the taut string (D1.f64) where float32 takes B1, the named
    engines their own kernels in double, pn and the long route's windows
    tv1_pn with its systems on B2.f64 (B1 never)."""
    n = 1000
    for method, strict, f64, f32 in (
            ("hybridtautstring", False, "tautstring", "pn_fused"),
            ("linearizedtautstring", True, "tautstring", "tautstring"),
            ("condat", True, "condat", "condat"),
            ("classictautstring", True, "classic_ts", "classic_ts"),
            ("dp", True, "dp", "dp"), ("kolmogorov", True, "dp", "dp")):
        assert tv1d_l1.tv1_route(method, 2.0, 1, n, strict, is_cuda=True,
                                 dtype=F64) == f64, method
        assert tv1d_l1.tv1_route(method, 2.0, 1, n, strict, is_cuda=True,
                                 dtype=F32) == f32, method
    w = np.ones(n - 1)
    assert tv1d_l1.tv1_route("tautstring", w, 1, n, True, is_cuda=True,
                             dtype=F64) == "tautstring"
    assert tv1d_l1.tv1_route("dp", w, 1, n, True, is_cuda=True,
                             dtype=F64) == "dp"
    for kind, n_, want in (("pn", n, False), ("pn_window", 6400, False),
                           ("pcr", n - 1, True), ("pcr", 6399, True),
                           ("ms", n, False), ("lp", n, False),
                           ("tautstring", n, True), ("dp", n, True),
                           ("condat", n, True), ("classic", n, True)):
        assert gating.decide(kind, True, F64, n_) is want, kind


@pytest.mark.parametrize("entry", sorted(API_CASES))
def test_api_float64_card_route(entry, default64, monkeypatch):
    """Each entry point under a float64 default on the card's float64
    route (the gate answering as for a CUDA tensor, the wrappers' plain
    versions running on the CPU): only its kernels' float64 forms, a
    float64 result (and SolverInfo), within chip_smoke.py's TOL64 bar of
    the same call with device="cpu"."""
    call, kernels, family, _ = API_CASES[entry]
    d = _data()
    ref = call(_On(ptv, device="cpu"), d, {})
    calls = _record(monkeypatch, as_card=True)
    # device="cpu" with the card's gate: the card's route on CPU tensors
    # (backend="cuda": a CPU call would otherwise take the host engine,
    # which the card's auto never takes).
    monkeypatch.setattr(api, "_device", lambda device: (
        torch.device("cpu"), api._dtype(torch.device("cuda"))))
    out = call(ptv, d, dict(backend="cuda"))
    assert {c[0] for c in calls} == kernels, calls
    assert all(c[1] == F64 for c in calls), calls
    if entry == "tv_value":
        assert isinstance(out, float)
        assert abs(out - ref) <= TOL64[family] * abs(ref)
        return
    assert out.dtype == np.float64 and out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= TOL64[family] * scale, err


@pytest.mark.parametrize("entry", ["tv1_1d pn", "tv1_2d auto", "tvgen_nd pd",
                                   "tv1_1d auto long"])
def test_api_float64_solver_info(entry, default64, monkeypatch):
    """The SolverInfo of a float64 call on the card's route is float64
    (the gap) with int32 iterations and return codes."""
    call, _, _, _ = API_CASES[entry]
    _record(monkeypatch, as_card=True)
    monkeypatch.setattr(api, "_device", lambda device: (
        torch.device("cpu"), api._dtype(torch.device("cuda"))))
    out, info = call(_On(ptv, return_info=True), _data(), {})
    assert out.dtype == np.float64
    assert info.gap.dtype == F64
    assert info.iters.dtype == info.rc.dtype == torch.int32


def test_api_tvgen_nd_primal_dual_raises_in_float64(default64, monkeypatch):
    """tvgen_nd with a primal-dual ND method raises the JAX package's own
    error in float64, on the card's route and on the CPU, before any
    kernel runs; the JAX API (x64) raises the same."""
    V = _data()["V"]
    for method in ("condat", "chambolle-pock", "chambolle-pock-acc"):
        with pytest.raises(ValueError, match="primal-dual ND methods need"):
            jptv.tvgen_nd(V, [0.3] * 3, [1, 2, 3], [1.0] * 3, method=method)
        with pytest.raises(ValueError, match="primal-dual ND methods need"):
            ptv.tvgen_nd(V, [0.3] * 3, [1, 2, 3], [1.0] * 3, method=method,
                         device="cpu")
    calls = _record(monkeypatch, as_card=True)
    monkeypatch.setattr(api, "_device", lambda device: (
        torch.device("cpu"), api._dtype(torch.device("cuda"))))
    with pytest.raises(ValueError, match="primal-dual ND methods need"):
        ptv.tvgen_nd(V, [0.3] * 3, [1, 2, 3], [1.0] * 3,
                     method="chambolle-pock-acc")
    assert calls == []


def test_api_host_backend_takes_the_default_dtype():
    """backend="host" returns the device route's dtype: float32 under a
    float32 default, float64 under a float64 default (no card needed), the
    native engine's float64 result unrounded there."""
    from proxtv_tpu_torch.runtime import native

    if not native.available():
        pytest.skip("no C++ compiler here")
    rng = np.random.RandomState(41)
    x, w = np.cumsum(rng.randn(300)), rng.rand(299)
    ref, refw = native.tv1_host(x, 1.0), native.tv1w_host(x, w)
    before = torch.get_default_dtype()
    try:
        for default, np_dt in ((F32, np.float32), (F64, np.float64)):
            torch.set_default_dtype(default)
            o = ptv.tv1_1d(x, 1.0, backend="host")
            ow = ptv.tv1w_1d(x, w, backend="host")
            assert o.dtype == ow.dtype == np_dt
            np.testing.assert_array_equal(o, ref.astype(np_dt))
            np.testing.assert_array_equal(ow, refw.astype(np_dt))
    finally:
        torch.set_default_dtype(before)


@pytest.mark.parametrize("entry", sorted(API_CASES))
def test_api_cpu_ignores_the_default_dtype(entry):
    """device="cpu": bit for bit the same result under a float32 and a
    float64 default, float64, and within tests/test_torch_api.py's bars of
    the JAX package's API under x64."""
    call, _, _, jbar = API_CASES[entry]
    d = _data()
    before = torch.get_default_dtype()
    outs = []
    try:
        for default in (F32, F64):
            torch.set_default_dtype(default)
            outs.append(call(_On(ptv, device="cpu"), d, {}))
    finally:
        torch.set_default_dtype(before)
    ref = call(jptv, d, {})
    if entry == "tv_value":
        assert outs[0] == outs[1]
        assert abs(outs[0] - float(ref)) <= jbar * abs(float(ref))
        return
    assert outs[0].dtype == outs[1].dtype == np.float64
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], np.asarray(ref), atol=jbar, rtol=0)


def _f32_batches():
    rng = np.random.RandomState(42)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    Y = f(rng.randn(6, 120) + np.cumsum(rng.randn(6, 120), axis=1) * 0.2)
    return dict(Y=Y, W=f(rng.rand(6, 119) * 1.2), lams=[0.5, 1.0, 1.5,
                                                        2.0, 0.7, 0.9],
                img=f(rng.randn(2, 20, 18)), vol=f(rng.randn(1, 4, 8, 8)),
                walk=f(np.cumsum(rng.randn(1, 20000)) * 0.05
                       + rng.randn(1, 20000)),
                g=f(rng.randn(2, 20, 18)))


def _backward(b):
    X = b["img"].clone().requires_grad_(True)
    x = diffprox.tv2d_prox(X, 0.3, "dr", 20)
    (gX,) = torch.autograd.grad((x * b["g"]).sum(), X)
    return x.detach(), gX


# The batched layers on float32 batches: name -> call(batches) returning a
# tensor or a tuple whose first item is the tensor.  Per-row and per-edge
# penalties come as Python lists and float32 tensors, the constructors
# that take a default dtype.
F32_CASES = {
    "tv1_batched pn": lambda b: tv1d_l1.tv1_batched(b["Y"], 0.7,
                                                    method="pn"),
    "tv1_batched pn per-edge": lambda b: tv1d_l1.tv1_batched(
        b["Y"], b["W"], method="pn"),
    "tv1_batched auto": lambda b: tv1d_l1.tv1_batched(b["Y"], 0.7),
    "tv1_batched tautstring per-edge": lambda b: tv1d_l1.tv1_batched(
        b["Y"], b["W"], method="tautstring", strict=True),
    "tv1_batched condat": lambda b: tv1d_l1.tv1_batched(
        b["Y"], 0.7, method="condat", strict=True),
    "tv1_batched classictautstring": lambda b: tv1d_l1.tv1_batched(
        b["Y"], 0.7, method="classictautstring", strict=True),
    "tv1_batched dp": lambda b: tv1d_l1.tv1_batched(b["Y"], 0.7,
                                                    method="dp", strict=True),
    "tv1_2d_batched dr": lambda b: tv2d.tv1_2d_batched(b["img"], 0.3,
                                                       method="dr"),
    "tv1_2d_batched cp-acc": lambda b: tv2d.tv1_2d_batched(
        b["img"], 0.3, method="chambolle-pock-acc"),
    "tv2_batched": lambda b: tv1d_l2.tv2_batched(b["Y"], 1.0),
    "tv2_batched ms per-row list": lambda b: tv1d_l2.tv2_batched(
        b["Y"], b["lams"], method="ms"),
    "tvp_batched": lambda b: tv1d_lp.tvp_batched(b["Y"], 0.7, 1.5),
    "tvp_batched per-row list": lambda b: tv1d_lp.tvp_batched(
        b["Y"], b["lams"], 3.0),
    "tv_nd_batched pd": lambda b: tvnd.tv_nd_batched(
        b["vol"], (0.3,) * 3, (1, 2, 3), (1.0, 2.0, 1.5), max_iters=10),
    "tv1_long": lambda b: tv1d_long.tv1_long(b["walk"], 0.7),
    "tv2d_prox backward": _backward,
}


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_float32_batches_ignore_the_default_dtype(case, route, monkeypatch):
    """A float32 batch through the batched layers gives bit for bit the
    same float32 output under a float64 default as under a float32 one,
    through the same kernels (the same wrapper calls, all float32): on the
    CPU's route, and on the card's (the gate answering as for a CUDA
    tensor, so the wrappers prepare the kernels' arguments and run their
    plain versions)."""
    calls = _record(monkeypatch, as_card=route == "card")
    before = torch.get_default_dtype()
    outs, seen = [], []
    try:
        for default in (F32, F64):
            torch.set_default_dtype(default)
            calls.clear()
            out = F32_CASES[case](_f32_batches())
            outs.append(out if isinstance(out, tuple) else (out,))
            seen.append(list(calls))
    finally:
        torch.set_default_dtype(before)
    assert seen[0] == seen[1]
    assert all(c[1] == F32 for c in seen[0]), seen[0]
    if route == "card":
        assert seen[0], "the card's route launched no kernel"
    for a, b in zip(*outs):
        if not torch.is_tensor(a):  # a SolverInfo
            a, b = a.gap, b.gap
        assert a.dtype == b.dtype
        assert a.dtype == F32 or not a.is_floating_point()
        assert torch.equal(a, b), case
