"""Observability: runtime-switchable instrumentation (reference compile-time
DEBUG / TIMING, src/general.h:36-46), the port's counterpart of
``proxtv_tpu.utils.debug``.

* ``PROXTV_TPU_DEBUG=1``  — solvers print per-outer-iteration traces on the
  host.  The port's loops are Python loops, so the values are already on the
  host when printed; with the variable unset nothing is formatted.
* ``PROXTV_TPU_PROFILE=<dir>`` — :func:`profile_ctx` wraps a block in a
  ``torch.profiler`` run and writes a Chrome trace to ``<dir>/<name>.json``.

:data:`HOST_SYNCS` counts the device-to-host reads the solver loops make (one
per combiner sweep, per PDHG chunk and per projected-Newton iteration): every
such read waits for the card, so the count says how often a solve stalls the
launch queue.
"""
from __future__ import annotations

import contextlib
import os


class Counter:
    """A plain integer counter (``value``), reset with :meth:`reset`."""

    def __init__(self):
        self.value = 0

    def reset(self):
        self.value = 0


HOST_SYNCS = Counter()


def host(t):
    """Read a tensor to the host (``.tolist()``), counting one sync."""
    HOST_SYNCS.value += 1
    return t.tolist()


def debug_enabled() -> bool:
    return os.environ.get("PROXTV_TPU_DEBUG", "0") not in ("", "0", "false")


def dprint(fmt: str, **kwargs):
    """Iteration-trace print; no-op unless PROXTV_TPU_DEBUG is set.
    Tensor kwargs are read to the host only when printing."""
    if debug_enabled():
        vals = {k: (v.tolist() if hasattr(v, "tolist") else v)
                for k, v in kwargs.items()}
        print(fmt.format(**vals))


@contextlib.contextmanager
def profile_ctx(name: str = "proxtv"):
    """Profile a block into $PROXTV_TPU_PROFILE/<name>.json if set, else no-op."""
    base = os.environ.get("PROXTV_TPU_PROFILE", "")
    if not base:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(base, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(base, f"{name}.json"))
