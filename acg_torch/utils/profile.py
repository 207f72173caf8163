"""Per-op timing (``--per-op-stats``, the reference's ACG_ENABLE_PROFILING
tier; the port of ``acg_tpu.utils.profile``).

The reference fills its per-op counters from event pairs around every
gemv / dot / axpy / allreduce / halo call (acg/cgcuda.c:583-605).  The
port's loop fuses those ops into a few kernels and replays its blocks as
CUDA graphs, so an op class cannot be timed inside it.  As in the JAX
package, each op class is timed ALONE on the kernels the loop runs
(:func:`acg_torch.utils.stats.time_op`: CUDA events on the card,
``perf_counter`` on the CPU), after warm-up, and the same
:class:`~acg_torch.solvers.base.OpCounters` table is filled with the
algorithm's count cadence (classic CG: 1 gemv, 2 dots, 3 axpys an
iteration; pipelined: 1 gemv, 2 dots, 6 axpys, ref acg/cgcuda.c:845-1020,
1676-1788) and the reference's byte and flop models (2 flops a nonzero,
ref :885).  The counts, bytes and flops are the JAX package's; only the
times are the port's own.
"""

from __future__ import annotations

import numpy as np
import torch

from acg_torch.solvers.base import SolveStats
from acg_torch.utils.stats import time_op


def _fill(c, t_once: float, n: int, bytes_once: int, flops_once: int):
    c.t += t_once * n
    c.n += n
    c.bytes += bytes_once * n
    c.flops += flops_once * n


def _cadence(k: int, pipelined: bool, replace_every: int) -> tuple:
    """(gemv, dot, axpy) calls of a solve of ``k`` iterations: one SpMV
    and one dot for the initial residual, and 4 SpMVs a residual
    replacement of the pipelined loop."""
    ngemv = k + 1 + (4 * (k // replace_every)
                     if pipelined and replace_every else 0)
    return ngemv, 2 * k + 1, (6 if pipelined else 3) * k + 1


def _gemv_bytes(dev, n: int, vb: int) -> int:
    """The SpMV's stream (the JAX package's model): DIA bands + x + y;
    sgell values, lane indices, one segment fetch a value + y; ELL values
    and columns + the gathered x (3 streams with y); the matrix-free
    stencil x + y (its operator is its spec)."""
    mb = dev.mat_itemsize
    if hasattr(dev, "bands"):
        return dev.bands.numel() * mb + 2 * n * vb
    if hasattr(dev, "seg"):
        return (dev.vals.numel() * mb
                + dev.idx.numel() * dev.idx.element_size()
                + dev.vals.numel() * vb + n * vb)
    if hasattr(dev, "colidx"):
        return (dev.vals.numel() * (mb + dev.colidx.element_size())
                + 3 * n * vb)
    return 2 * n * vb


def profile_ops(dev, stats: SolveStats, niterations: int,
                pipelined: bool = False,
                replace_every: int = 0) -> SolveStats:
    """Fill ``stats``' per-op counters for a single-device solve of
    ``niterations`` iterations on the built operator ``dev``: its planned
    SpMV, ``torch.dot``, the axpy, the 2-norm and the copy, each timed
    alone on ``dev``'s device."""
    from acg_torch.ops.blas1 import ddot, dnrm2

    n = int(dev.nrows_padded)
    vdt = getattr(torch, str(dev.vec_dtype))
    vb = torch.empty((), dtype=vdt).element_size()
    k = max(int(niterations), 1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(n)).to(vdt).to(dev.device)
    y = torch.from_numpy(rng.standard_normal(n)).to(vdt).to(dev.device)

    t_gemv = time_op(dev.matvec, x)
    t_dot = time_op(ddot, x, y)
    t_axpy = time_op(lambda u, v: torch.add(v, u, alpha=1.5), x, y)
    t_nrm2 = time_op(dnrm2, x)
    t_copy = time_op(torch.clone, x)

    ngemv, ndots, naxpy = _cadence(k, pipelined, replace_every)
    _fill(stats.gemv, t_gemv, ngemv, _gemv_bytes(dev, n, vb),
          2 * int(dev.nnz))
    _fill(stats.dot, t_dot, ndots, 2 * n * vb, 2 * n)
    _fill(stats.axpy, t_axpy, naxpy, 3 * n * vb, 2 * n)
    _fill(stats.nrm2, t_nrm2, 1, n * vb, 2 * n)
    _fill(stats.copy, t_copy, 2, 2 * n * vb, 0)
    return stats


def _local_bytes(ss) -> int:
    """The shards' local operator streams: DIA bands (the JAX package's
    model), every other tier's stored layout (``operator_stream_bytes``)."""
    if ss.local_fmt == "dia":
        return sum(op.bands.numel() * op.mat_itemsize
                   for op in ss.local_ops)
    return sum(int(op.operator_stream_bytes()) for op in ss.local_ops)


def profile_dist_ops(ss, stats: SolveStats, niterations: int,
                     pipelined: bool = False,
                     replace_every: int = 0) -> SolveStats:
    """Fill ``stats``' per-op counters for a sharded solve of
    ``niterations`` iterations: the halo under the system's transport
    (``ss.exchange``), the shard-ordered sum of one partial a shard (the
    reduction), the local and interface SpMV of every shard (ghosts 0:
    the same work), the shards' local dots and axpys, each timed alone
    (ref acg/halo.h:343-351, acg/cgcuda.c:583-605)."""
    from acg_torch.ops.blas1 import batched_dot
    from acg_torch.parallel.sharded import ShardVec, sum_in_order

    k = max(int(niterations), 1)
    vdt = getattr(torch, str(ss.vec_dtype))
    vb = torch.empty((), dtype=vdt).element_size()
    dev0 = ss.devices[0]
    xs = ShardVec(torch.zeros(op.nrows_padded, dtype=vdt, device=d)
                  for op, d in zip(ss.local_ops, ss.devices))
    ghosts = [torch.zeros(g, dtype=vdt, device=d)
              for g, d in zip(ss.tables.nghost, ss.devices)]
    parts = [torch.dot(x, x) for x in xs]

    def gemv(xs):
        out = []
        for i, (op, x) in enumerate(zip(ss.local_ops, xs)):
            y = op.matvec(x)
            ss.add_iface(i, y, ghosts[i])
            out.append(y)
        return out

    t_halo = time_op(ss.exchange, xs)
    t_allreduce = time_op(sum_in_order, parts, dev0)
    t_gemv = time_op(gemv, xs)
    t_dot = time_op(lambda a, c: [batched_dot(u, v) for u, v in zip(a, c)],
                    xs, xs)
    t_axpy = time_op(lambda a, c: [torch.add(v, u, alpha=1.5)
                                   for u, v in zip(a, c)], xs, xs)

    n_tot = sum(int(x.numel()) for x in xs)
    iface = sum(int(it[0].stream_bytes()) for it in ss.iface
                if it is not None)
    gemv_bytes = _local_bytes(ss) + iface + 3 * n_tot * vb
    ngemv, ndots, naxpy = _cadence(k, pipelined, replace_every)
    _fill(stats.gemv, t_gemv, ngemv, gemv_bytes, 2 * int(ss.nnz))
    _fill(stats.dot, t_dot, ndots, 2 * n_tot * vb, 2 * n_tot)
    _fill(stats.axpy, t_axpy, naxpy, 3 * n_tot * vb, 2 * n_tot)

    nmsgs = sum(len(p.neighbors) for p in ss.ps.parts)
    nred = k + 1 if pipelined else 2 * k + 1
    _fill(stats.halo, t_halo, k + 1, ss.halo.total_send_values * vb, 0)
    _fill(stats.allreduce, t_allreduce, nred,
          (16 if pipelined else 8) * ss.nparts, 0)
    stats.nhalomsgs += nmsgs * (k + 1)
    return stats
