"""The port's auxiliary modules against the JAX package's: the checkpoint
(``utils.checkpoint``), the CLI (``python -m proxtv_tpu_torch``), the native
host batch entry point and workspace pool (``runtime.native``), and the two
demos added beside the other three, on the CPU in float64."""
import numpy as np
import pytest
import torch

import jax

from proxtv_tpu import __main__ as jcli
from proxtv_tpu.runtime import native as jnative
from proxtv_tpu_torch import __main__ as tcli
from proxtv_tpu_torch.runtime import native
from proxtv_tpu_torch.utils import checkpoint as ckpt


@pytest.mark.parametrize("tree", ["dict", "nested"])
def test_checkpoint_roundtrip_and_leaf_order(tree, tmp_path):
    """save / restore(like=) round trip on like's dtypes, and the leaves of
    restore without like in jax.tree_util.tree_flatten's order."""
    rng = np.random.RandomState(0)
    if tree == "dict":
        state = {"x": rng.randn(3), "w": rng.randn(4, 7)}
    else:
        state = {"u0": (rng.randn(2, 5, 4), rng.randn(2, 4, 5)),
                 "b": [rng.randn(6), None, {"z": rng.randn(2), "a": 1.5}],
                 "a": rng.randn(1)}
    like = jax.tree_util.tree_map(lambda a: torch.tensor(a), state)
    path = ckpt.save(str(tmp_path / "st"), like)
    assert path.endswith(".npz")
    out = ckpt.restore(path, like=like)
    flat_like, td_like = jax.tree_util.tree_flatten(like)
    flat_out, td_out = jax.tree_util.tree_flatten(out)
    assert td_like == td_out
    for a, b in zip(flat_out, flat_like):
        assert a.dtype == b.dtype and a.device == b.device
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    leaves = ckpt.restore(path)
    ref = jax.tree_util.tree_leaves(state)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cmd", ["denoise1d", "denoise2d", "tv_scalar",
                                 "tv_weights1d", "tv_p2"])
def test_cli_matches_jax(cmd, tmp_path):
    """The port's CLI with --device cpu against proxtv_tpu.__main__.main on
    the same .npy, to 1e-10."""
    rng = np.random.RandomState(0)
    xin = tmp_path / "in.npy"
    shape = (8, 9) if cmd == "denoise2d" else (40,)
    np.save(xin, rng.randn(*shape))
    if cmd in ("denoise1d", "denoise2d"):
        args = [cmd, str(xin), "OUT", "--lam", "0.5"]
    else:
        lam = "0.5"
        if cmd == "tv_weights1d":
            lam = str(tmp_path / "w.npy")
            np.save(lam, 0.5 + rng.rand(39))
        args = ["tv", str(xin), "OUT", "--lam", lam]
        if cmd == "tv_p2":
            args += ["--p", "2"]
    outs = []
    for main, extra, name in ((jcli.main, [], "j.npy"),
                              (tcli.main, ["--device", "cpu"], "t.npy")):
        a = [str(tmp_path / name) if v == "OUT" else v for v in args]
        assert main(a + extra) == 0
        outs.append(np.load(tmp_path / name))
    assert outs[1].shape == shape and outs[1].dtype == np.float64
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-10)


@pytest.mark.parametrize("entry", ["batch", "workspace"])
def test_native_batch_and_workspace_match_jax(entry):
    """tv1_batch_host and the HostWorkspace pool against the JAX package's
    runtime.native, to 1e-12 (tests/test_native.py's test_batch_host and
    test_host_workspace_pool)."""
    if not native.available() or not jnative.available():
        pytest.skip("no C++ compiler for the native host engine")
    rng = np.random.RandomState(0)
    if entry == "batch":
        Y = rng.randn(16, 50)
        X = native.tv1_batch_host(Y, 0.5, n_threads=2)
        np.testing.assert_allclose(X, jnative.tv1_batch_host(Y, 0.5),
                                   atol=1e-12)
        for b in range(Y.shape[0]):
            np.testing.assert_array_equal(X[b], native.tv1_host(Y[b], 0.5))
        return
    y1, y2 = rng.randn(64), rng.randn(64)
    with native.HostWorkspace() as ws:
        x1 = native.tv1_host(y1, 0.5, ws=ws)
        np.testing.assert_allclose(x1, jnative.tv1_host(y1, 0.5), atol=1e-12)
        p1 = x1.ctypes.data
        x2 = native.tv1_host(y2, 0.5, ws=ws)
        assert x2.ctypes.data == p1          # same pool memory reused
        np.testing.assert_allclose(x2, jnative.tv1_host(y2, 0.5), atol=1e-12)
    with pytest.raises(ValueError):
        ws.out_buffer(4)


@pytest.mark.parametrize("which", ["batched", "color"])
def test_new_demos_run_on_cpu(which, monkeypatch):
    """demo_filter_image_batched and demo_filter_image_color on the CPU at a
    small size: the batched demo reports each batch, the color demo
    denoises (the JAX demo's synthetic image, 24 x 24)."""
    if which == "batched":
        from proxtv_tpu_torch.demos import demo_filter_image_batched as demo

        res = demo.main(device="cpu", n=16, batches=(1, 2))
        assert sorted(res) == [1, 2]
        assert all(ms > 0 and rate > 0 for ms, rate in res.values())
        return
    from proxtv_tpu_torch.demos import demo_filter_image_color as demo

    monkeypatch.setattr(demo, "load_image",
                        lambda: (demo.make_image(24), "synthetic"))
    res = demo.main(device="cpu")
    for noisy, den in res.values():
        assert den < noisy
