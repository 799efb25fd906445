"""The device mesh of the parallel path and its collectives, on
``torch.distributed``.

The JAX package runs its multi-chip paths as ``shard_map`` programs over a
1D ``jax.sharding.Mesh``; here every rank of a process group runs the same
Python program (SPMD) and the collectives are explicit:

=====================  ==============================================
JAX primitive          here
=====================  ==============================================
``lax.ppermute``       :func:`permute` (both directions, any hop, in
                       one ``dist.batch_isend_irecv``; a rank with no
                       source receives zeros, as ppermute gives)
``psum`` / ``pmax``    :func:`all_reduce`, :func:`reduce_host`
``all_gather``         :func:`all_gather` (``all_gather_into_tensor``)
``axis_index``         ``mesh.rank``
=====================  ==============================================

Transport follows the group's backend: NCCL moves the card's tensors
directly; gloo is a host transport, so a CUDA tensor is copied to a host
buffer and back explicitly, and each copy is counted in
``debug.STAGING_COPIES``.  The solve itself stays on the mesh's device.
Every collective is counted (``debug.EXCHANGES``, ``ALL_REDUCES``,
``GATHERS``, ``BYTES_MOVED``: the bytes this rank sent).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..utils import debug


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1D mesh: the process group, its axis name and this rank's device.

    Not ``torch.distributed.device_mesh.DeviceMesh``: a DeviceMesh records a
    device type, not a device, and picks the rank's card itself when it is
    built (``LOCAL_RANK``, else the rank modulo the card count).  Under
    ``torchrun`` with two ranks on a one-card host it sets rank 1 to
    ``cuda:1`` and fails, where this mesh puts both ranks on ``cuda:0``.
    """

    group: Any
    axis: str
    device: torch.device

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def staged(self) -> bool:
        """True where CUDA tensors travel through host buffers (gloo)."""
        return (self.device.type == "cuda"
                and dist.get_backend(self.group) != "nccl")


def make_mesh(n_devices: Optional[int] = None, axis: str = "d",
              device=None) -> Mesh:
    """The 1D mesh over the initialised default process group (the
    counterpart of the JAX package's ``make_mesh``).

    The caller starts the group first, as PyTorch programs do (``torchrun``
    or ``dist.init_process_group``).  This rank's device is
    ``cuda:<local rank mod card count>`` (``LOCAL_RANK``, else the rank),
    and becomes the current CUDA device; ``device="cpu"`` asks for the CPU.
    A CUDA mesh without a card raises.  ``n_devices``, if given, must equal
    the world size: every rank of the group runs the solve (a JAX mesh may
    leave devices out; an SPMD rank cannot sit out).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA mesh needs a card and none is "
                           "available; pass device='cpu' for a CPU mesh")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {dev}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(torchrun, or torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{world} ranks: every rank takes part")
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, axis, dev)


def _out(mesh, t):
    """A CUDA tensor moved to a host buffer when the mesh stages."""
    if mesh.staged and t.is_cuda:
        debug.STAGING_COPIES.value += 1
        return t.cpu()
    return t


def _back(mesh, t):
    """A staged host buffer moved back to the mesh's device."""
    if mesh.staged and not t.is_cuda:
        debug.STAGING_COPIES.value += 1
        return t.to(mesh.device)
    return t


def permute(mesh: Mesh, sends):
    """``lax.ppermute`` along the mesh, every shift in one batch.

    ``sends`` is a list of ``(tensor, hop)``: this rank sends ``tensor`` to
    rank ``rank + hop`` and receives, in its place, the tensor that rank
    ``rank - hop`` sent (zeros where that rank does not exist).  Every rank
    passes the same list of shapes and hops.  Returns the received tensors,
    in order, on the mesh's device.
    """
    rank, size = mesh.rank, mesh.size
    ops, recv, nbytes = [], [], 0
    for tag, (t, hop) in enumerate(sends):
        t = t.contiguous()
        if hop == 0:
            recv.append(t)
            continue
        dst, src = rank + hop, rank - hop
        if 0 <= dst < size and t.numel():
            ops.append(dist.P2POp(dist.isend, _out(mesh, t), dst, mesh.group,
                                  tag))
            nbytes += t.numel() * t.element_size()
        buf = torch.zeros(t.shape, dtype=t.dtype,
                          device="cpu" if mesh.staged else t.device)
        if 0 <= src < size and t.numel():
            ops.append(dist.P2POp(dist.irecv, buf, src, mesh.group, tag))
        recv.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        debug.EXCHANGES.value += 1
        debug.BYTES_MOVED.value += nbytes
    return [_back(mesh, b) for b in recv]


def halo_exchange(mesh: Mesh, fields, halo: int, local: int):
    """Refresh, in place, the halos of banded fields from the neighbours'
    cores: each field is ``(halo + local + halo, ...)`` along dim 0, its
    first ``halo`` rows take the rank above's last core rows, its last
    ``halo`` rows the rank below's first core rows (zeros at the mesh's
    ends).  All fields travel in one exchange, two messages a neighbour;
    a one-rank mesh has no neighbour and its halos lie outside the image,
    where the kernels' masks pin them, so nothing moves."""
    if mesh.size == 1:
        return fields
    top = torch.stack([f[halo:2 * halo] for f in fields])
    bot = torch.stack([f[local:local + halo] for f in fields])
    from_below, from_above = permute(mesh, [(top, -1), (bot, 1)])
    for f, a, b in zip(fields, from_above, from_below):
        f[:halo] = a
        f[halo + local:] = b
    return fields


def column_halo(mesh: Mesh, col, hop: int):
    """The one-column halo of a column-split field: this rank sends ``col``
    (a (..., 1) slice) to rank ``rank + hop`` and returns the slice that
    rank ``rank - hop`` sent, zeros at the mesh's ends.  ``hop = -1`` brings
    the first column of the rank to the right, ``hop = 1`` the last column
    of the rank to the left.  Every rank passes the same shape; a one-rank
    mesh has no neighbour, and nothing moves."""
    if mesh.size == 1:
        return torch.zeros_like(col)
    return permute(mesh, [(col, hop)])[0]


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _reduced(mesh, t, op):
    buf = _out(mesh, t).clone()
    dist.all_reduce(buf, _OPS[op], group=mesh.group)
    debug.ALL_REDUCES.value += 1
    debug.BYTES_MOVED.value += buf.numel() * buf.element_size()
    return buf


def all_reduce(mesh: Mesh, t, op: str = "sum"):
    """``psum`` (``op="sum"``) or ``pmax`` (``"max"``) of ``t`` over the
    mesh: a new tensor on ``t``'s device."""
    return _back(mesh, _reduced(mesh, t, op))


def reduce_host(mesh: Mesh, t, op: str = "sum"):
    """:func:`all_reduce` read to the host as a list (one host sync).  Every
    rank gets the same values, so a branch on them is taken by every rank
    alike.  On a staged mesh the copy out is the only copy."""
    return debug.host(_reduced(mesh, t, op))


def all_gather(mesh: Mesh, t):
    """The ranks' equally shaped ``t`` concatenated along dim 0, in rank
    order, on ``t``'s device."""
    t = _out(mesh, t).contiguous()
    out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; the card's torch does not
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=mesh.group)
    debug.GATHERS.value += 1
    debug.BYTES_MOVED.value += t.numel() * t.element_size()
    return _back(mesh, out)


def all_to_all(mesh: Mesh, sends, recv_shapes):
    """Each rank sends ``sends[j]`` to rank j and receives from rank i a
    tensor of shape ``recv_shapes[i]`` (one ``all_to_all_single``).  All
    tensors share a dtype; returns the received list on the mesh's
    device."""
    flat = torch.cat([s.reshape(-1) for s in sends])
    flat = _out(mesh, flat)
    sizes_in = [s.numel() for s in sends]
    sizes_out = [int(torch.Size(s).numel()) for s in recv_shapes]
    out = torch.empty(sum(sizes_out), dtype=flat.dtype, device=flat.device)
    dist.all_to_all_single(out, flat, sizes_out, sizes_in, group=mesh.group)
    debug.GATHERS.value += 1
    debug.BYTES_MOVED.value += flat.numel() * flat.element_size()
    out = _back(mesh, out)
    return [p.reshape(s) for p, s in zip(torch.split(out, sizes_out),
                                         recv_shapes)]
