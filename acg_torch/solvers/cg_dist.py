"""Distributed classic and pipelined CG over shards: halo + local SpMV +
fixed-order sums.

The port of the classic and pipelined branches of
``acg_tpu/solvers/cg_dist.py`` (reference acg/cgcuda.c:398-1109
``acgsolvercuda_solvempi`` and its pipelined variant).  The rows are split
into parts (``acg_torch/partition/``), each part a shard on its mesh
device (``acg_torch/parallel/sharded.py``), and the loops of
``acg_torch.solvers.loops`` run over per-shard vectors:

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
- pipelined CG (:func:`cg_pipelined_dist`) on the stencil and DIA tiers
  runs, per iteration, one halo of w and each shard's single-kernel
  pipelined iteration, then folds the interface product I = A_iface ·
  ghosts(w) into the shard's border rows (z' += I, w' -= alpha I, delta
  -= alpha <I, r'>; the JAX package's ``cg_dist.py:351-376``); with
  ``replace_every`` or on ELL and sgell the body is open-coded (the
  distributed SpMV, the six torch updates and the dots);
- every dot is one partial a shard, added in shard order on the first
  shard's device (the psum of the JAX package, ref acgcomm_allreduce);
  the pipelined loop's two scalars are its one reduction point;
- a (B, n) right-hand side solves B systems in one loop: every shard
  holds (B, n) blocks, the halo moves (B, S) messages in the same rounds,
  the stencil and DIA shards run their multi-RHS kernels with per-system
  p'Ap, ELL and sgell their one-system kernel once per system;
- ``options.halo_wire`` ("bf16", "int16-delta") compresses the messages
  of the ppermute and allgather halos (``parallel/halo.py``).

:func:`cg_dist` and :func:`cg_pipelined_dist` take a host CsrMatrix and
``nparts`` (or a part vector, a :class:`PartitionedSystem` or a prebuilt
:class:`ShardedSystem`) and a global right-hand side, and return a global
:class:`SolveResult` whose ``kernel`` names the local tier's loop kernel
and the halo (``cuda-stencil-fused+rdma``, ``cuda-dia-pipe+ppermute``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from acg_torch.config import HaloMethod, SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot
from acg_torch.parallel.halo import check_wire, on_device
from acg_torch.parallel.mesh import make_mesh
from acg_torch.parallel.sharded import (ShardedSystem, ShardVec,
                                        resolve_local_fmt, sum_in_order)
from acg_torch.partition.graph import PartitionedSystem, partition_system
from acg_torch.partition.partitioner import partition_graph
from acg_torch.solvers.base import (SolveStats, conform_x0_batch,
                                    kernel_disengagement_note, path_names)
from acg_torch.solvers.cg import _deflate_x0, _finish
from acg_torch.solvers.loops import cg_pipelined_while, cg_while
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


def _describe_path(ss: ShardedSystem, pipelined: bool = False,
                   replace_every: int = 0, batch: int = 0) -> tuple:
    """(operator_format, kernel, note): the local tier's loop kernel with
    the halo appended (``cuda-stencil-fused+rdma``), and the note naming a
    format the system's builder was forced to and a single-kernel
    pipelined iteration that does not run, as the single-device
    ``_describe_path`` words them.  On the stencil and DIA tiers the
    classic loop runs the fused SpMV, the pipelined loop the single-kernel
    iteration (``pipe``) unless ``replace_every`` or a (batch, n) solve
    disengages it (``spmv``), a batch the multi-RHS SpMV (``batched``); a
    DIA loop on a one-vector SpMV names the kernel of the shards' plan."""
    has_pipe = ss.local_fmt in ("stencil", "dia")
    engaged = pipelined and has_pipe and replace_every == 0 and not batch
    body = ("spmv" if not has_pipe else "batched" if batch
            else "fused" if not pipelined else "pipe" if engaged
            else "spmv")
    if ss.local_fmt == "dia" and body in ("fused", "spmv"):
        plan = _dist_fused_plan(ss)
        if plan != "resident":
            body = plan
    name, kernel = path_names(ss.local_fmt, ss.devices[0].type, body,
                              rcm=ss.ps.rcm_localized)
    note = kernel_disengagement_note(pipelined, engaged, replace_every,
                                     forced_fmt=ss.forced_fmt,
                                     stencil=ss.local_fmt == "stencil",
                                     batch=batch, has_pipe=has_pipe)
    return name, f"{kernel}+{ss.method.value}", note


def _beta_first(r, p, beta) -> None:
    """p = r + beta p in place, shard by shard (beta per system in a
    batch)."""
    for rp, pp in zip(r, p):
        bb = on_device(beta, pp.device)
        torch.addcmul(rp, pp, bb[:, None] if pp.dim() == 2 else bb, out=pp)


def _fused_step(ss: ShardedSystem, dev0: torch.device, wire: str):
    """The beta-first step of the stencil and DIA tiers: p = r + beta p,
    the halo of p, each shard's t = A_local p with p'A_local p from the
    kernel (per system from the multi-RHS kernel for a batch), the
    interface product added to t and its <p, A_iface ghosts> to the
    shard's partial; the partials summed in shard order."""
    def coupled(r, p, beta):
        _beta_first(r, p, beta)
        ghosts = ss.exchange(p, wire)
        t, parts = ShardVec(), []
        for i, (op, pp) in enumerate(zip(ss.local_ops, p)):
            ti, d = op.matvec_dot(pp)
            iface = ss.add_iface(i, ti, ghosts[i])
            if iface is not None:
                rows, ti_iface = iface
                d = d + batched_dot(pp.index_select(pp.dim() - 1, rows),
                                    ti_iface)
            t.append(ti)
            parts.append(d)
        return p, t, sum_in_order(parts, dev0)

    return coupled


def _split_step(ss: ShardedSystem, dot, wire: str):
    """The beta-first step of the ELL and sgell tiers: p = r + beta p,
    t = A p through the halo, local SpMV and interface product, then
    <p, t> (the JAX package's generic split)."""
    def coupled(r, p, beta):
        _beta_first(r, p, beta)
        t = ss.matvec(p, wire)
        return p, t, dot(p, t)

    return coupled


def _pipe_step(ss: ShardedSystem, dev0: torch.device, wire: str):
    """The pipelined loop's ``iter_step`` on stencil and DIA shards: the
    halo of w, then on each shard its single-kernel pipelined iteration
    (q = A_local w, the 6-vector update, gamma and delta) and the
    interface product I = A_iface ghosts(w) folded into its border rows,
    which is exact since the update is linear in q: z' += I, w' -=
    alpha I, delta -= alpha <I, r'> (p', s', x', r' and gamma do not
    depend on q).  The partials of gamma and delta are summed in shard
    order.  The kernel writes w' beside w, so each shard's two w buffers
    alternate (``cg.py``'s ``_pipe_step``)."""
    spare = [None] * ss.nparts

    def step(z, r, p, w, s, x, alpha, beta):
        ghosts = ss.exchange(w, wire)
        outs = tuple(ShardVec() for _ in range(6))
        gammas, deltas = [], []
        for i, op in enumerate(ss.local_ops):
            dev = w[i].device
            a = on_device(alpha, dev)
            *vecs, g, d = op.pipelined_iter(
                w[i], z[i], r[i], p[i], s[i], x[i], a,
                on_device(beta, dev), w_out=spare[i])
            spare[i] = w[i]
            iface = ss.iface_product(i, ghosts[i])
            if iface is not None:
                rows, q = iface
                zi, ri, wi = vecs[0], vecs[4], vecs[5]
                zi.index_add_(0, rows, q)
                wi.index_add_(0, rows, q * a, alpha=-1)
                d = torch.addcmul(d, a, torch.dot(q, ri.index_select(
                    0, rows)), value=-1)
            for o, v in zip(outs, vecs):
                o.append(v)
            gammas.append(g)
            deltas.append(d)
        return outs + (sum_in_order(gammas, dev0),
                       sum_in_order(deltas, dev0))

    return step


def _sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _solve_dist(pipelined: bool, A, b, x0, options: SolverOptions,
                stats: SolveStats | None, build_kw: dict):
    """The driver of both solvers (``acg_tpu``'s ``_solve_dist``): the
    refusals, the shards, the loop and the result."""
    o = options
    if o.segment_iters or o.monitor_every:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "segment_iters / monitor_every: not yet ported")
    if pipelined and (o.diffatol > 0 or o.diffrtol > 0):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "pipelined CG supports residual-based stopping only")
    check_wire(o.halo_wire)
    b = np.asarray(b)
    if b.ndim not in (1, 2) or b.size == 0:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"vectors are (n,), or (B, n) for B right-hand "
                       f"sides; got shape {b.shape}")
    batch = b.shape[0] if b.ndim == 2 else 0
    # refused before the shards are built, as the JAX package refuses
    # them before its program is traced
    method = (A.method if isinstance(A, ShardedSystem)
              else HaloMethod(build_kw.get("method", HaloMethod.PPERMUTE)))
    if batch and method == HaloMethod.RDMA:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "multi-RHS solves support the ppermute/allgather "
                       "halo tiers (the rdma halo, a put+signal kernel, "
                       "moves 1-D packs)")
    if o.halo_wire != "f32" and method == HaloMethod.RDMA:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "halo_wire compression applies to the ppermute/"
                       "allgather halo tiers (the rdma halo, a put+signal "
                       "kernel, writes raw vector words)")
    ss = build_sharded(A, **build_kw)
    if b.shape[-1] != ss.nrows:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"vectors of shape {b.shape} for an operator of "
                       f"{ss.nrows} rows")
    if x0 is not None:
        # a 1-D x0 is shared by every system of a batch
        x0 = conform_x0_batch(np.asarray(x0), b.shape,
                              lambda v: np.tile(v[None, :], (batch, 1)))
        if x0.shape != b.shape:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"initial guess of {x0.shape[-1]} entries for "
                           f"an operator of {ss.nrows} rows")
    dev0 = ss.devices[0]
    vdt = getattr(torch, ss.vec_dtype)
    wire = o.halo_wire
    b_sh = ss.to_sharded(b)
    x0_sh = (ss.to_sharded(x0) if x0 is not None
             else ShardVec(torch.zeros_like(v) for v in b_sh))

    def scalar(v):
        return torch.tensor(v, dtype=vdt, device=dev0)

    def dot(a, c):
        return sum_in_order([batched_dot(u, v) for u, v in zip(a, c)], dev0)

    def matvec(v):
        return ss.matvec(v, wire)

    stop2 = (scalar(o.residual_atol ** 2), scalar(o.residual_rtol ** 2))
    on_pipe = ss.local_fmt in ("stencil", "dia")
    track_diff = o.diffatol > 0 or o.diffrtol > 0
    _sync(ss.devices)
    t0 = time.perf_counter()
    if pipelined:
        def dot2(a1, b1, a2, b2):
            return dot(a1, b1), dot(a2, b2)

        iter_step = (_pipe_step(ss, dev0, wire)
                     if on_pipe and o.replace_every == 0 and not batch
                     else None)
        x, k, rr, flag, rr0, hist = cg_pipelined_while(
            matvec, dot2, b_sh, x0_sh, stop2, maxits=o.maxits,
            check_every=o.check_every, replace_every=o.replace_every,
            certify=o.residual_atol > 0 or o.residual_rtol > 0,
            iter_step=iter_step, guard=o.guard_nonfinite)
        dxx = None
    else:
        diffstop = o.diffatol ** 2
        if o.diffrtol > 0:
            # |x0| per system: a per-system threshold for a batch
            x0n = np.linalg.norm(np.zeros(b.shape) if x0 is None
                                 else x0.astype(np.float64), axis=-1)
            diffstop = (torch.clamp((o.diffrtol * scalar(x0n)) ** 2,
                                    min=diffstop) if batch
                        else max(diffstop, (o.diffrtol * float(x0n)) ** 2))
        coupled = (_fused_step(ss, dev0, wire) if on_pipe
                   else _split_step(ss, dot, wire))
        x, k, rr, dxx, flag, rr0, hist = cg_while(
            matvec, dot, b_sh, x0_sh, stop2, diffstop, maxits=o.maxits,
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
                   np.linalg.norm(b, axis=-1),
                   dxx=dxx if track_diff else None, stats=stats,
                   path=_describe_path(ss, pipelined,
                                       o.replace_every if pipelined else 0,
                                       batch),
                   hist=hist, pipelined=pipelined)


def cg_dist(A, b, x0=None, options: SolverOptions = SolverOptions(),
            stats: SolveStats | None = None, **build_kw):
    """Distributed classic CG (``acg_tpu.solvers.cg_dist.cg_dist``): one
    halo exchange and two shard-ordered sums per iteration.  ``A`` and
    ``build_kw`` as :func:`build_sharded` (a built system is taken as it
    is); ``b``, ``x0`` and ``x`` are global host vectors, ``b`` of shape
    (B, n) for B systems in one loop (``x0`` then (B, n), or (n,) shared
    by every system; the result carries per-system counts and
    residuals).  A failed put+signal exchange raises after the loop
    (:meth:`ShardedSystem.check_transport`).  Raises as
    :func:`acg_torch.solvers.cg.cg` does (``.result`` attached on
    breakdown or non-convergence), and ``ERR_NOT_SUPPORTED`` for a batch
    or a compressed ``halo_wire`` under the rdma halo and for what is not
    yet ported here: ``segment_iters`` and ``monitor_every``."""
    return _solve_dist(False, A, b, x0, options, stats, build_kw)


def cg_pipelined_dist(A, b, x0=None,
                      options: SolverOptions = SolverOptions(),
                      stats: SolveStats | None = None, **build_kw):
    """Distributed pipelined CG (``acg_tpu.solvers.cg_dist``
    ``cg_pipelined_dist``): one halo exchange and ONE reduction point (the
    two shard-ordered sums of gamma and delta) per iteration.  On stencil
    and DIA shards each iteration is one single-kernel pipelined iteration
    a shard with the interface folded in (``cuda-stencil-pipe+<halo>``,
    ``cuda-dia-pipe+<halo>``); ``options.replace_every`` > 0, a (B, n)
    ``b`` or ELL and sgell shards run the open-coded body.  Arguments,
    results and errors as :func:`cg_dist`; residual criteria only (the
    diff criteria raise ``ERR_NOT_SUPPORTED``)."""
    return _solve_dist(True, A, b, x0, options, stats, build_kw)


def cg_recycled_dist(A, b, x0=None,
                     options: SolverOptions = SolverOptions(),
                     stats: SolveStats | None = None, W=None, WtAW=None,
                     recycle=None, matvec=None, **build_kw):
    """Distributed deflated CG (``acg_tpu.solvers.cg_dist``
    ``cg_recycled_dist``): project the retained basis ``W`` (with
    ``WtAW`` = W'AW) out of the initial residual on the host at set-up,
    then run :func:`cg_dist` unchanged.  With no basis, or no host
    product (``matvec``, else ``A.matvec``), it IS :func:`cg_dist`;
    ``recycle`` (the serve stack's retained basis) is not yet ported."""
    if recycle is not None:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "recycle (a RecycleState): not yet ported")
    mv = matvec if matvec is not None else getattr(A, "matvec", None)
    if W is not None and WtAW is not None and mv is not None:
        x0 = _deflate_x0(mv, b, x0, W, WtAW)
    return cg_dist(A, b, x0, options, stats, **build_kw)
