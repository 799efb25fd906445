"""proxtv_tpu_torch — the PyTorch / CUDA port of ``proxtv_tpu``.

Total-variation proximity operators on an NVIDIA Hopper card: the same
method strings, defaults, ``SolverInfo`` and warm-start state as the JAX
package, with the TPU's Pallas kernels rewritten as hand-written CUDA
(``csrc/``: projected Newton, PCR tridiagonal solve, PDHG chunk), built by
``nvcc`` at first use.  This package imports neither JAX nor ``proxtv_tpu``.

Public API (this slice): ``tv1_1d`` (projected Newton) and ``tv1_2d`` (all
seven 2D TV-L1 methods); the batched layers live in
:mod:`proxtv_tpu_torch.ops` and :mod:`proxtv_tpu_torch.models`.
"""

from .api import tv1_1d, tv1_2d  # noqa: F401
from .utils.info import RC_ERROR, RC_ITERS, RC_OK, RC_STUCK, SolverInfo  # noqa: F401

__version__ = "0.1.0"
