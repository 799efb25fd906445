"""Multi-card entry points on a ``torch.distributed`` mesh (the port of
``proxtv_tpu.parallel``): batch-split solves, the fiber-parallel 2D
combiner, and the banded 2D / 3D PDHG and long-1D solves that span the
mesh.  Start the process group first (``torchrun`` or
``torch.distributed.init_process_group``), then build the mesh with
:func:`make_mesh`."""
from .sharded import (  # noqa: F401
    make_mesh,
    tv1_1d_sharded,
    tv2_1d_sharded,
    tvp_1d_sharded,
    tv1_2d_sharded,
    tv1_1d_banded,
    tv1_2d_banded,
    tv1w_2d_banded,
    tv1_3d_banded,
    tv1_2d_sharded_fused,
    tv1w_2d_sharded_fused,
    tv_nd_sharded,
)
