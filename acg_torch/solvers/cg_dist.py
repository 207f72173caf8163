"""Distributed classic CG over shards: halo + local SpMV + fixed-order
sums.

The port of the classic branch of ``acg_tpu/solvers/cg_dist.py``
(reference acg/cgcuda.c:398-1109 ``acgsolvercuda_solvempi``).  The rows
are split into parts (``acg_torch/partition/``), each part a shard on its
mesh device (``acg_torch/parallel/sharded.py``), and the classic loop
(``acg_torch.solvers.loops.cg_while``) runs over per-shard vectors:

- the operator application is the halo exchange, each shard's local SpMV
  (a single-device kernel) and its interface product ``A_iface ·
  ghosts`` on its border rows through the rectangular ``ell_spmv`` (the
  reference's begin / local / end / interface schedule,
  acg/cgcuda.c:847-883, in stream order);
- on the stencil and DIA tiers the beta-first step fuses p'Ap into the
  local kernel (``matvec_dot``), and the interface correction
  ``<p, A_iface ghosts>`` is added to each shard's partial (the JAX
  package's fused ``coupled`` step, ``cg_dist.py:329-349``); on ELL and
  sgell the step is the SpMV and then the dot;
- every dot is one partial a shard, added in shard order on the first
  shard's device (the psum of the JAX package, ref acgcomm_allreduce).

:func:`cg_dist` takes a host CsrMatrix and ``nparts`` (or a part
vector, a :class:`PartitionedSystem` or a prebuilt
:class:`ShardedSystem`) and a global right-hand side, and returns a
global :class:`SolveResult` whose ``kernel`` names the local tier and the
halo (``cuda-stencil-fused+rdma``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from acg_torch.config import HaloMethod, SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.parallel.halo import check_wire
from acg_torch.parallel.mesh import make_mesh
from acg_torch.parallel.sharded import (ShardedSystem, ShardVec,
                                        resolve_local_fmt, sum_in_order)
from acg_torch.partition.graph import PartitionedSystem, partition_system
from acg_torch.partition.partitioner import partition_graph
from acg_torch.solvers.base import (SolveStats, kernel_disengagement_note,
                                    path_names)
from acg_torch.solvers.cg import _finish
from acg_torch.solvers.loops import cg_while
from acg_torch.utils.timing import host_step


def build_sharded(A, nparts: int | None = None, part=None,
                  devices=None, dtype=None, method=HaloMethod.PPERMUTE,
                  partition_method: str = "auto", seed: int = 0,
                  mat_dtype="auto", fmt: str = "auto",
                  timings: dict | None = None) -> ShardedSystem:
    """Partition and upload: the init phase (ref acgsolvercuda_init,
    acg/cgcuda.c:138-328, and the driver's partition pipeline,
    cuda/acg-cuda.c:1485-1800).

    ``A`` is a host CsrMatrix (partitioned into ``nparts`` by
    :func:`partition_graph` unless a ``part`` vector is given), a
    :class:`PartitionedSystem`, or a built :class:`ShardedSystem`
    (returned as it is).  The shards go onto ``make_mesh(P, devices)``:
    the visible CUDA devices by default (``ERR_MESH`` when fewer than
    P), or an explicit list that may repeat a device
    (``["cuda:0"] * 4`` puts four shards on one card, ``["cpu"] * P``
    runs the plain versions).  ``method="rdma"`` needs CUDA devices and
    raises ``ERR_NOT_SUPPORTED`` otherwise.  The local format is resolved
    with the per-part RCM pass (:func:`resolve_local_fmt`).  ``timings``
    gathers host seconds: ``partition``, ``partition_system``,
    ``resolve``, ``halo_tables``, ``shards``."""
    if isinstance(A, ShardedSystem):
        return A
    method = HaloMethod(method)
    if isinstance(A, PartitionedSystem):
        P = A.nparts
    elif part is not None:
        P = int(np.max(part)) + 1
    elif nparts is not None:
        P = int(nparts)
    else:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "need nparts or a part vector")
    devices = make_mesh(P, devices)
    if method == HaloMethod.RDMA and any(d.type != "cuda" for d in devices):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "--halo rdma is the device-initiated put+signal "
                       "kernel and needs every shard on a CUDA device; "
                       "use ppermute or allgather here")
    if isinstance(A, PartitionedSystem):
        ps = A
    else:
        if part is None:
            with host_step(timings, "partition"):
                part = partition_graph(A, P, method=partition_method,
                                       seed=seed)
        with host_step(timings, "partition_system"):
            ps = partition_system(A, np.asarray(part), local_order="band")
    solve_dtype = np.dtype(dtype) if dtype is not None else np.float64
    with host_step(timings, "resolve"):
        ps, local_fmt, extra = resolve_local_fmt(ps, fmt, try_rcm=True,
                                                 vec_dtype=solve_dtype)
    return ShardedSystem.build(
        ps, local_fmt, extra, devices=devices, dtype=solve_dtype,
        method=method, mat_dtype=mat_dtype, forced=fmt != "auto",
        timings=timings)


def _dist_fused_plan(ss: ShardedSystem):
    """The plan of the DIA shards' one-vector SpMV kernel ("resident",
    "hbm-ring" or "hbm"; each shard's operator made it with
    ``ops/dia_plan.fused_plan_for`` on its device's budgets, and the
    longest shard names it), or None off the DIA tier (the JAX package's
    ``_dist_fused_plan``)."""
    if ss.local_fmt != "dia":
        return None
    op = max(ss.local_ops, key=lambda o: o.nrows_padded)
    return op.kind


def _describe_path(ss: ShardedSystem) -> tuple:
    """(operator_format, kernel, note): the local tier's names, the halo
    appended to the kernel (``cuda-stencil-fused+rdma``), the note naming
    a format the system's builder was forced to."""
    body = "spmv"
    if ss.local_fmt in ("stencil", "dia"):
        body = "fused"
        plan = _dist_fused_plan(ss)
        if plan not in (None, "resident"):
            body = plan
    name, kernel = path_names(ss.local_fmt, ss.devices[0].type, body,
                              rcm=ss.ps.rcm_localized)
    note = kernel_disengagement_note(False, True, 0,
                                     forced_fmt=ss.forced_fmt,
                                     has_pipe=False)
    return name, f"{kernel}+{ss.method.value}", note


def _fused_step(ss: ShardedSystem, dev0: torch.device):
    """The beta-first step of the stencil and DIA tiers: p = r + beta p,
    the halo of p, each shard's t = A_local p with p'A_local p from the
    kernel, the interface product added to t and its <p, A_iface ghosts>
    to the shard's partial; the partials summed in shard order."""
    def coupled(r, p, beta):
        for rp, pp in zip(r, p):
            torch.addcmul(rp, pp, beta.to(pp.device), out=pp)
        ghosts = ss.exchange(p)
        t, parts = ShardVec(), []
        for i, (op, pp) in enumerate(zip(ss.local_ops, p)):
            ti, d = op.matvec_dot(pp)
            iface = ss.add_iface(i, ti, ghosts[i])
            if iface is not None:
                rows, ti_iface = iface
                d = d + torch.dot(pp.index_select(0, rows), ti_iface)
            t.append(ti)
            parts.append(d)
        return p, t, sum_in_order(parts, dev0)

    return coupled


def _split_step(ss: ShardedSystem, dot):
    """The beta-first step of the ELL and sgell tiers: p = r + beta p,
    t = A p through the halo, local SpMV and interface product, then
    <p, t> (the JAX package's generic split)."""
    def coupled(r, p, beta):
        for rp, pp in zip(r, p):
            torch.addcmul(rp, pp, beta.to(pp.device), out=pp)
        t = ss.matvec(p)
        return p, t, dot(p, t)

    return coupled


def _sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def cg_dist(A, b, x0=None, options: SolverOptions = SolverOptions(),
            stats: SolveStats | None = None, **build_kw):
    """Distributed classic CG (``acg_tpu.solvers.cg_dist.cg_dist``): one
    halo exchange and two shard-ordered sums per iteration.  ``A`` and
    ``build_kw`` as :func:`build_sharded` (a built system is taken as it
    is); ``b``, ``x0`` and ``x`` are global host vectors.  A failed
    put+signal exchange raises after the loop
    (:meth:`ShardedSystem.check_transport`).  Raises as :func:`acg_torch.solvers.cg.cg` does
    (``.result`` attached on breakdown or non-convergence), and
    ``ERR_NOT_SUPPORTED`` for what is not yet ported here: a (B, n)
    ``b``, ``segment_iters``, ``monitor_every`` and a compressed
    ``halo_wire``."""
    o = options
    if o.segment_iters or o.monitor_every:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "segment_iters / monitor_every: not yet ported")
    check_wire(o.halo_wire)
    b = np.asarray(b)
    if b.ndim != 1:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"distributed multi-RHS solves (b of shape "
                       f"{b.shape}): not yet ported")
    ss = build_sharded(A, **build_kw)
    if b.shape[0] != ss.nrows or (x0 is not None
                                  and np.shape(x0) != b.shape):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"vectors of shape {b.shape} / "
                       f"{None if x0 is None else np.shape(x0)} for an "
                       f"operator of {ss.nrows} rows")
    dev0 = ss.devices[0]
    vdt = getattr(torch, ss.vec_dtype)
    b_sh = ss.to_sharded(b)
    x0_sh = (ss.to_sharded(x0) if x0 is not None
             else ShardVec(torch.zeros_like(v) for v in b_sh))

    def scalar(v):
        return torch.tensor(v, dtype=vdt, device=dev0)

    def dot(a, c):
        return sum_in_order([torch.dot(u, v) for u, v in zip(a, c)], dev0)

    stop2 = (scalar(o.residual_atol ** 2), scalar(o.residual_rtol ** 2))
    track_diff = o.diffatol > 0 or o.diffrtol > 0
    diffstop = o.diffatol ** 2
    if o.diffrtol > 0:
        x0n = float(np.linalg.norm(np.asarray(x0, dtype=np.float64))) \
            if x0 is not None else 0.0
        diffstop = max(diffstop, (o.diffrtol * x0n) ** 2)
    coupled = (_fused_step(ss, dev0) if ss.local_fmt in ("stencil", "dia")
               else _split_step(ss, dot))
    _sync(ss.devices)
    t0 = time.perf_counter()
    x, k, rr, dxx, flag, rr0, hist = cg_while(
        ss.matvec, dot, b_sh, x0_sh, stop2, diffstop, maxits=o.maxits,
        track_diff=track_diff, check_every=o.check_every,
        coupled_step=coupled, guard=o.guard_nonfinite)
    _sync(ss.devices)
    tsolve = time.perf_counter() - t0
    ss.check_transport()

    class _Meta:  # the flop model's inputs, for _finish
        nrows = ss.nrows
        nnz = ss.nnz

    x_global = torch.from_numpy(ss.from_sharded(x))
    return _finish(_Meta, x_global, k, rr, flag, rr0, o, tsolve,
                   float(np.linalg.norm(b)),
                   dxx=dxx if track_diff else None, stats=stats,
                   path=_describe_path(ss),
                   hist=hist)

