"""Level-1 BLAS reductions (reference acg/vector.c:561-620).

Ordinary torch ops: in the JAX package XLA fused these into the solver
loop and nothing was hand-written for them.  ``nexclude`` drops that many
trailing (ghost) entries, as in ``acg_tpu.ops.blas1``.
"""

from __future__ import annotations

import torch


def ddot(x: torch.Tensor, y: torch.Tensor, nexclude: int = 0) -> torch.Tensor:
    """dot(x, y) as a 0-d tensor, excluding ``nexclude`` trailing entries."""
    n = x.shape[-1] - nexclude
    return torch.dot(x[:n], y[:n])


def dnrm2(x: torch.Tensor, nexclude: int = 0) -> torch.Tensor:
    """|x|_2 as a 0-d tensor, excluding ``nexclude`` trailing entries."""
    return torch.sqrt(ddot(x, x, nexclude))
