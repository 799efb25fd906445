"""proxtv_tpu_torch — the PyTorch / CUDA port of ``proxtv_tpu``.

Total-variation proximity operators on an NVIDIA Hopper card: the same
method strings, defaults, ``SolverInfo`` and warm-start state as the JAX
package, with the TPU's Pallas kernels rewritten as hand-written CUDA
(``csrc/``: projected Newton, PCR tridiagonal solve, 2D PDHG chunk,
More-Sorensen TV-L2, GPFW TV-Lp, 3D PDHG chunk), and the direct 1D engines
of its XLA scans (taut string, message-passing DP) as CUDA kernels too,
built by ``nvcc`` at first use.  This package imports neither JAX nor ``proxtv_tpu``.

Public API: ``tv1_1d``, ``tv1w_1d`` (every method string; the native host
engine when the caller asks for the host), ``tv2_1d``, ``tvp_1d``, ``tv1_2d`` (all
seven 2D TV-L1 methods, scalar or per-image lam), ``tv1w_2d``, ``tvp_2d``,
``tvgen``, ``tvgen_nd``, ``tv`` and ``tv_value``; the batched layers live in
:mod:`proxtv_tpu_torch.ops` and :mod:`proxtv_tpu_torch.models`.
"""

from .api import (tv, tv1_1d, tv1_2d, tv1w_1d, tv1w_2d,  # noqa: F401
                  tv2_1d, tv_value, tvgen, tvgen_nd, tvp_1d, tvp_2d)
from .utils.info import RC_ERROR, RC_ITERS, RC_OK, RC_STUCK, SolverInfo  # noqa: F401

__version__ = "0.1.0"
