"""Solver-state checkpoint/resume, the port's counterpart of
``proxtv_tpu.utils.checkpoint``.

Solver state — the dual vectors that the combiners thread across
iterations, or a layer's ``state_dict`` — is a tree of tensors (dicts, lists
and tuples), so a long solve can be checkpointed to disk and resumed.  The
file is a numpy ``.npz`` (no orbax): the leaves as ``leaf_0``, ``leaf_1``,
... in ``jax.tree_util``'s leaf order (dict keys sorted, lists and tuples in
order, ``None`` holding no leaf), plus one ``treedef`` entry, the layout of
the JAX package's own ``.npz`` fallback (whose ``restore`` counts the
leaves as the entries less that one).

Usage::

    from proxtv_tpu_torch.utils import checkpoint as ckpt
    path = ckpt.save("state", {"w_col": w_col, "w_row": w_row, "x": x})
    state = ckpt.restore(path, like=template)   # tensors on like's devices
    leaves = ckpt.restore(path)                 # the leaves, on the CPU
"""
from __future__ import annotations

import numpy as np
import torch


def _leaves(tree):
    """The leaves of a tree of dicts, lists and tuples in jax.tree_util's
    order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _leaf_numpy(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save(path: str, state) -> str:
    """Persist a tree of tensors / arrays as ``path`` (``.npz`` appended if
    missing).  Returns the written path."""
    path = path if path.endswith(".npz") else path + ".npz"
    leaves = _leaves(state)
    np.savez(path, treedef=np.frombuffer(b"jax.tree_util leaf order",
                                         dtype=np.uint8),
             **{f"leaf_{i}": _leaf_numpy(v) for i, v in enumerate(leaves)})
    return path


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from the leaves (consumed in order), each
    a tensor on the device and of the dtype of ``like``'s leaf there."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return type(like)(out) if isinstance(like, tuple) else out
    arr = leaves.pop(0)
    if torch.is_tensor(like):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return torch.from_numpy(np.asarray(arr))


def restore(path: str, like=None):
    """Load a tree saved by :func:`save` (or by the JAX package's ``.npz``
    fallback).

    Without ``like`` the leaves come back as a list of CPU tensors, in the
    saved (jax.tree_util) order, as the JAX package's ``restore`` returns
    them.  With ``like`` (a tree of the same structure) the tree is rebuilt,
    each leaf a tensor on the device and in the dtype of ``like``'s leaf.
    """
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    if like is None:
        return [torch.from_numpy(a) for a in leaves]
    expect = len(_leaves(like))
    if expect != len(leaves):
        raise ValueError(f"{npz} holds {len(leaves)} leaves; like has "
                         f"{expect}")
    return _unflatten(like, list(leaves))
