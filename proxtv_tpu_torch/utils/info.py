"""Solver diagnostics: the port's equivalent of the reference ``info`` array.

The reference library reports a 3-slot ``double info[]`` per solve —
``[INFO_ITERS, INFO_GAP, INFO_RC]`` (reference ``src/general.h:58-61``).  Here the
diagnostics are a dataclass of tensors, one entry per *batch element*, so a
batched solve reports convergence of every fiber (the JAX package's pytree,
``proxtv_tpu.utils.info``).

Return codes mirror ``src/general.h:70-73``:
    RC_OK = 0      converged below tolerance
    RC_ITERS = 1   stopped at max iterations (possibly suboptimal)
    RC_STUCK = 2   no further improvement possible
    RC_ERROR = 3   error during the solve
"""
from __future__ import annotations

import dataclasses

import torch

RC_OK = 0
RC_ITERS = 1
RC_STUCK = 2
RC_ERROR = 3


@dataclasses.dataclass(frozen=True)
class SolverInfo:
    """Per-solve diagnostics.

    Attributes:
        iters: number of outer iterations run (int32 tensor, batched).
        gap: final duality gap / stopping criterion value (dtype of the solve).
        rc: return code, one of RC_* (int32 tensor, batched).
    """

    iters: torch.Tensor
    gap: torch.Tensor
    rc: torch.Tensor

    @staticmethod
    def single(iters=0, gap=0.0, rc=RC_OK, dtype=torch.float32,
               device=None) -> "SolverInfo":
        """(1,)-shaped info of one solve, as the batched engines report it
        (the direct engines use this: exact, no iteration count)."""
        return SolverInfo(
            iters=torch.tensor([iters], dtype=torch.int32, device=device),
            gap=torch.tensor([gap], dtype=dtype, device=device),
            rc=torch.tensor([rc], dtype=torch.int32, device=device),
        )


def make_info(iters, gap, rc) -> SolverInfo:
    return SolverInfo(
        iters=torch.as_tensor(iters).to(torch.int32),
        gap=gap,
        rc=torch.as_tensor(rc).to(torch.int32),
    )
