"""Port vs JAX package: the batch-split entry points, the fiber-parallel 2D
combiner and the distributed segmented scans of ``proxtv_tpu_torch.parallel``.

The port runs in a spawned gloo world of 3 ranks on the CPU
(``tests/torch_dist_worker.py``, JAX-free); each test holds its outputs
against the JAX package on a 3-device mesh of the virtual CPU mesh (or,
where the JAX test itself does, against the unsharded JAX engine), at the
tolerances of ``tests/test_sharding.py`` and ``tests/test_segscan.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import torch_dist_worker as W
from proxtv_tpu import parallel as JP
from proxtv_tpu.models import tv2d as J2
from proxtv_tpu.models import tvnd as JND
from proxtv_tpu.ops import tv1d_l1 as J1
from proxtv_tpu.ops import tv1d_l2 as JL2
from proxtv_tpu.ops import tv1d_lp as JLP
from proxtv_tpu_torch import parallel as P

WORLD = 3


def _inputs():
    rng = np.random.RandomState(0)
    return dict(
        Y1=rng.randn(16, 20),                    # uneven over 3 ranks
        Y4=rng.randn(7, 6, 5, 4),
        Y2=rng.randn(8, 12, 10),
        Yc=rng.randn(1, 16, 24),                 # 24 columns over 3 ranks
        Yf=rng.randn(6, 16, 14).astype(np.float32),
        Yw=rng.randn(6, 12, 10).astype(np.float32),
        Wc=(0.5 + rng.rand(6, 11, 10)).astype(np.float32),
        Wr=(0.5 + rng.rand(6, 12, 9)).astype(np.float32),
        Yc2=rng.randn(2, 16, 24),                # two images, 24 columns
        lam_pi=np.array([0.2, 0.5]))


@pytest.fixture(scope="module")
def batch_world(tmp_path_factory):
    inp = _inputs()
    res = W.run("batch", WORLD, str(tmp_path_factory.mktemp("batch")), **inp)
    for key in res[0]:  # every rank gets the whole result
        for other in res[1:]:
            np.testing.assert_array_equal(other[key], res[0][key], key)
    return inp, res[0]


def test_make_mesh_needs_a_card_or_the_cpu():
    """Without a card the default (CUDA) mesh raises instead of moving the
    solve to the CPU; a CPU mesh needs the process group first; a mesh of
    another size than the group raises (in the spawned world)."""
    with pytest.raises(RuntimeError, match="needs a card"):
        P.make_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        P.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        P.make_mesh(device="meta")


def test_batch_split_entry_points_match_jax(batch_world):
    inp, out = batch_world
    Y1 = jnp.asarray(inp["Y1"])
    np.testing.assert_allclose(out["tv1"], np.asarray(J1.tv1_batched(Y1, 0.7)),
                               atol=1e-12)
    x2, _ = JL2.tv2_mspg(Y1, 0.8)
    np.testing.assert_allclose(out["tv2"], np.asarray(x2), atol=1e-10)
    assert out["tv2_rc"].shape == (16,)
    xp, _ = JLP.tvp_gpfw(Y1, 0.5, 1.5)
    np.testing.assert_allclose(out["tvp"], np.asarray(xp), atol=1e-5)
    xn, _ = JND.tv_nd_batched(jnp.asarray(inp["Y4"]), (0.3, 0.3, 0.3),
                              (1, 2, 3), (1.0, 1.0, 1.0), max_iters=20)
    np.testing.assert_allclose(out["nd"], np.asarray(xn), atol=1e-10)
    xb, ib = J2.tv1_2d_batched(jnp.asarray(inp["Y2"]), 0.4, max_iters=40)
    np.testing.assert_allclose(out["b2d"], np.asarray(xb), atol=1e-10)
    np.testing.assert_array_equal(out["b2d_iters"], np.asarray(ib.iters))
    assert "n_devices=4" in str(out["n_devices_error"])


def test_fused_batch_split_matches_jax_and_moves_nothing_until_the_gather(
        batch_world):
    """Each rank solves its own sub-batch: no exchange and no all-reduce
    during the solve, one all-gather per output (x and the three info
    fields)."""
    inp, out = batch_world
    mesh = JP.make_mesh(WORLD)
    xj, ij = JP.tv1_2d_sharded_fused(inp["Yf"], 0.4, mesh,
                                     method="chambolle-pock", max_iters=200)
    np.testing.assert_allclose(out["fused"], np.asarray(xj), atol=1e-5)
    assert out["fused_iters"].shape == (6,)
    np.testing.assert_array_equal(out["fused_counts"], [0, 0, 4])
    xw, iw = JP.tv1w_2d_sharded_fused(inp["Yw"], inp["Wc"], inp["Wr"], mesh,
                                      method="dr", max_iters=40)
    np.testing.assert_allclose(out["fusedw"], np.asarray(xw), atol=1e-5)
    assert out["fusedw_rc"].shape == (6,)
    assert "divisible" in str(out["divisible_error"])


def test_fiber_split_2d_matches_jax(batch_world):
    """One image, its columns over the ranks, the row pass behind an
    all-to-all: the JAX package's GSPMD column sharding, to 1e-10."""
    inp, out = batch_world
    xj, ij = JP.tv1_2d_sharded(inp["Yc"], 0.4, JP.make_mesh(WORLD),
                               max_iters=40, shard_axis="cols")
    np.testing.assert_allclose(out["cols"], np.asarray(xj), atol=1e-10)
    np.testing.assert_array_equal(out["cols_iters"], np.asarray(ij.iters))


@pytest.mark.parametrize("method", W.COLS_METHODS)
def test_fiber_split_2d_every_method_matches_jax(batch_world, method):
    """Every method under column sharding, the JAX package's GSPMD run of
    the same engine, to 1e-10 with equal sweep counts: the splitting
    methods behind the all-to-all, the primal-dual methods (unfused, as
    JAX runs them sharded) and kolmogorov with one-column halo exchanges
    between the ranks each sweep."""
    inp, out = batch_world
    xj, ij = JP.tv1_2d_sharded(inp["Yc2"], 0.4, JP.make_mesh(WORLD),
                               method=method, max_iters=40,
                               shard_axis="cols")
    np.testing.assert_allclose(out["cols_" + method], np.asarray(xj),
                               atol=1e-10)
    np.testing.assert_array_equal(out[f"cols_{method}_iters"],
                                  np.asarray(ij.iters))
    halos = int(out[f"cols_{method}_exchanges"])
    assert (halos > 0) == (method not in W.COLS_PER_IMAGE), halos


@pytest.mark.parametrize("method", W.COLS_PER_IMAGE)
def test_fiber_split_2d_per_image_lam_matches_jax(batch_world, method):
    """A (B,) lam under column sharding: uniform per-edge weight fields,
    the column pass on the rank's (B, M-1, N_r) block and the row pass on
    its (B, M_r, N-1) block, against the JAX package to 1e-10."""
    inp, out = batch_world
    xj, ij = JP.tv1_2d_sharded(inp["Yc2"], inp["lam_pi"],
                               JP.make_mesh(WORLD), method=method,
                               max_iters=40, shard_axis="cols")
    np.testing.assert_allclose(out["cols_pi_" + method], np.asarray(xj),
                               atol=1e-10)
    np.testing.assert_array_equal(out[f"cols_pi_{method}_iters"],
                                  np.asarray(ij.iters))


@pytest.mark.parametrize("method", W.COLS_PER_IMAGE_RAISE)
def test_fiber_split_2d_per_image_lam_raises_where_jax_raises(batch_world,
                                                              method):
    """A per-image lam with a primal-dual method or kolmogorov raises
    ValueError under column sharding, in both packages."""
    inp, out = batch_world
    assert str(out["cols_pi_error_" + method]), method
    with pytest.raises(ValueError):
        JP.tv1_2d_sharded(inp["Yc2"], inp["lam_pi"], JP.make_mesh(WORLD),
                          method=method, max_iters=40, shard_axis="cols")


def _oracle(x, starts, op):
    out = np.empty_like(x)
    idx = np.where(starts)[0].tolist() + [x.shape[0]]
    for a, b in zip(idx[:-1], idx[1:]):
        out[a:b] = op(x[a:b])
    return out


def test_segment_scans_match_the_oracle(tmp_path):
    """Segment mean (1e-12) and minimum (exact) across rank boundaries, for
    no, sparse, dense and all flags and one segment spanning every rank
    (the oracle of tests/test_segscan.py)."""
    rng = np.random.RandomState(0)
    n = 24 * WORLD
    x = rng.randn(n)
    starts = [rng.rand(n) < d for d in (0.0, 0.08, 0.5, 1.0)]
    starts.append(np.zeros(n, bool))
    for s in starts:
        s[0] = True
    res = W.run("segscan", WORLD, str(tmp_path), x=x, starts=np.array(starts))
    for out in res:
        for i, s in enumerate(starts):
            np.testing.assert_allclose(out[f"mean{i}"],
                                       _oracle(x, s, np.mean), atol=1e-12)
            np.testing.assert_allclose(out[f"min{i}"], _oracle(x, s, np.min),
                                       atol=0)
