"""Level-1 BLAS reductions (reference acg/vector.c:561-620), the
pipelined-CG vector update, and the block products of the s-step and
deep-pipelined loops (:func:`gram`, :func:`block_dot`, :func:`combine`).

Ordinary torch ops: in the JAX package XLA fused these into the solver
loop and nothing was hand-written for them.  ``nexclude`` drops that many
trailing (ghost) entries, as in ``acg_tpu.ops.blas1``.  Every reduction
runs over the last axis, so a ``(B, n)`` batch of systems reduces per
system to a ``(B,)`` tensor.
"""

from __future__ import annotations

import contextlib

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


def pipelined_update_(q, w, z, r, p, s, x, alpha, beta) -> None:
    """:func:`pipelined_update` in place: each vector takes its new value
    in its own buffer, in the order z, p, s, x, r, w, in which every
    operand read is not yet overwritten (x' reads p', r' reads the old r
    and s', w' the old w and z'), so the bits are those of the new
    tensors.  ``q`` must not share memory with the six vectors.  The
    vectors may be per-shard vectors (``ShardVec``), updated shard by
    shard."""
    if alpha.dim() == 1:
        alpha, beta = alpha[:, None], beta[:, None]
    torch.addcmul(q, beta, z, out=z)
    torch.addcmul(r, beta, p, out=p)
    torch.addcmul(w, beta, s, out=s)
    torch.addcmul(x, alpha, p, out=x)
    torch.addcmul(r, alpha, s, value=-1, out=r)
    torch.addcmul(w, alpha, z, value=-1, out=w)


@contextlib.contextmanager
def _full_precision_matmul():
    """f32 products at f32, never TF32, whatever the global setting: the
    s-step decisions stand on the Gram entries (``acg_tpu.ops.blas1``
    forces ``Precision.HIGHEST`` for the same reason), and a TF32 Gram
    carries ~1e-3 relative error."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gram(V: torch.Tensor) -> torch.Tensor:
    """All m² inner products of an m-vector basis block in one
    tall-skinny product (``acg_tpu.ops.blas1.gram``, the s-step
    reduction): ``V`` of shape (m, n) gives (m, m).  A batch ``V`` of
    shape (m, B, n) gives the per-system stack (B, m, m), one product per
    system, so a system's Gram is the one its one-system solve forms."""
    with _full_precision_matmul():
        if V.dim() == 3:
            return torch.stack([V[:, s] @ V[:, s].T
                                for s in range(V.shape[1])])
        return V @ V.T


def block_dot(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The m inner products <V_i, w> in one matrix-vector product
    (``acg_tpu.ops.blas1.block_dot``): (m, n) against (n,) gives (m,);
    a batch (m, B, n) against (B, n) gives (B, m)."""
    with _full_precision_matmul():
        if V.dim() == 3:
            return torch.stack([V[:, s] @ w[s] for s in range(V.shape[1])])
        return V @ w


def combine(c: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The basis combination sum_i c_i V_i in one product: (m,) against
    (m, n) gives (n,), k combinations (k, m) give (k, n) from one read of
    V; per system, (B, m) against (m, B, n) gives (B, n)."""
    with _full_precision_matmul():
        if V.dim() == 3:
            return torch.stack([c[s] @ V[:, s] for s in range(V.shape[1])])
        return c @ V
