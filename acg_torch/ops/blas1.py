"""Level-1 BLAS reductions (reference acg/vector.c:561-620) and the
pipelined-CG vector update.

Ordinary torch ops: in the JAX package XLA fused these into the solver
loop and nothing was hand-written for them.  ``nexclude`` drops that many
trailing (ghost) entries, as in ``acg_tpu.ops.blas1``.  Every reduction
runs over the last axis, so a ``(B, n)`` batch of systems reduces per
system to a ``(B,)`` tensor.
"""

from __future__ import annotations

import torch


def batched_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-system dot over the last axis: exactly ``torch.dot`` for 1-D
    operands (a 0-d tensor), one ``torch.dot`` per row for ``(B, n)``
    operands (a ``(B,)`` tensor).  A row's dot is thus the very reduction
    its one-system solve takes, so a batched solve gives every system the
    bits of its own solve (``acg_tpu.ops.blas1.batched_dot`` sums over the
    axis instead; the values agree to rounding)."""
    if x.dim() == 1:
        return torch.dot(x, y)
    return torch.stack([torch.dot(a, b) for a, b in zip(x, y)])


def ddot(x: torch.Tensor, y: torch.Tensor, nexclude: int = 0) -> torch.Tensor:
    """dot(x, y) over the last axis, excluding ``nexclude`` trailing
    entries: a 0-d tensor, or ``(B,)`` for ``(B, n)`` operands."""
    n = x.shape[-1] - nexclude
    return batched_dot(x[..., :n], y[..., :n])


def dnrm2(x: torch.Tensor, nexclude: int = 0) -> torch.Tensor:
    """|x|_2 over the last axis, excluding ``nexclude`` trailing
    entries."""
    return torch.sqrt(ddot(x, x, nexclude))


def pipelined_update(q, w, z, r, p, s, x, alpha, beta):
    """The pipelined-CG 6-vector update (Ghysels/Vanroose; ref
    acg/cg-kernels-cuda.cu:187-269) given q = A w, as new tensors:

        z' = q + beta z;  p' = r + beta p;  s' = w + beta s
        x' = x + alpha p';  r' = r - alpha s';  w' = w - alpha z'

    Returns ``(z', p', s', x', r', w')``, one ``addcmul`` each;
    ``alpha``/``beta`` are 0-d tensors, or ``(B,)`` per-system
    coefficients of ``(B, n)`` vectors (broadcast as ``[:, None]``)."""
    if alpha.dim() == 1:
        alpha, beta = alpha[:, None], beta[:, None]
    z2 = torch.addcmul(q, beta, z)
    p2 = torch.addcmul(r, beta, p)
    s2 = torch.addcmul(w, beta, s)
    x2 = torch.addcmul(x, alpha, p2)
    r2 = torch.addcmul(r, alpha, s2, value=-1)
    w2 = torch.addcmul(w, alpha, z2, value=-1)
    return z2, p2, s2, x2, r2, w2
