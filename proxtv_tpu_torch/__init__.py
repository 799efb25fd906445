"""proxtv_tpu_torch — the PyTorch / CUDA port of ``proxtv_tpu``.

Total-variation proximity operators on an NVIDIA Hopper card: the same
method strings, defaults, ``SolverInfo`` and warm-start state as the JAX
package, with the TPU's Pallas kernels rewritten as hand-written CUDA
(``csrc/``: projected Newton, PCR tridiagonal solve, 2D PDHG chunk,
More-Sorensen TV-L2, GPFW TV-Lp, 3D PDHG chunk), built by ``nvcc`` at first
use.  This package imports neither JAX nor ``proxtv_tpu``.

Public API: ``tv1_1d`` (projected Newton), ``tv2_1d``, ``tvp_1d``,
``tv1_2d`` (all seven 2D TV-L1 methods), ``tvp_2d``, ``tvgen``,
``tvgen_nd``, ``tv`` (scalar lam) and ``tv_value``; the batched layers live
in :mod:`proxtv_tpu_torch.ops` and :mod:`proxtv_tpu_torch.models`.
"""

from .api import (tv, tv1_1d, tv1_2d, tv2_1d, tv_value, tvgen,  # noqa: F401
                  tvgen_nd, tvp_1d, tvp_2d)
from .utils.info import RC_ERROR, RC_ITERS, RC_OK, RC_STUCK, SolverInfo  # noqa: F401

__version__ = "0.1.0"
