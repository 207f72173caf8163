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

import dataclasses
import time

import numpy as np
import torch

from acg_torch.config import HaloMethod, SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.obs.monitor import LoopMonitor
from acg_torch.ops.blas1 import batched_dot, block_dot, combine, gram
from acg_torch.ops.cg_update import cg_update
from acg_torch.parallel.deep import build_deep_device
from acg_torch.parallel.halo import check_wire, on_device
from acg_torch.parallel.mesh import make_mesh
from acg_torch.parallel.sharded import (ShardedSystem, ShardStack,
                                        ShardVec, resolve_local_fmt,
                                        sum_in_order)
from acg_torch.partition.graph import PartitionedSystem, partition_system
from acg_torch.partition.partitioner import partition_graph
from acg_torch.solvers.base import (SolveStats, cg_flops_per_iter,
                                    conform_x0_batch,
                                    kernel_disengagement_note, path_names)
from acg_torch.solvers.cg import (AotSolve, _aot_kind, _any_crit,
                                  _certifies, _cheb_leja_nodes,
                                  _deep_dispatches, _deep_validate,
                                  _deflate_x0, _finish, _host, _join_note,
                                  _power_lmax, _sstep_certify,
                                  _sstep_fallback, _sstep_fallback_stop,
                                  _sstep_fallback_x0, _sstep_validate,
                                  open_loop_note, resolve_loop)
from acg_torch.solvers.loops import (_GRAM_BAD, _keep, cg_loop,
                                     cg_pipelined_deep_while,
                                     cg_pipelined_loop, cg_sstep_while,
                                     deep_buffers)

# reduction points so far, for the counted CommAudit
# (``acg_torch/obs/audit.py``): one a :func:`_reduce`, however many
# scalars it adds (the JAX package's one psum of a stacked payload), and
# the bytes of one shard's partials.  The loops' graph runner replays them
# with the launch counters (``solvers/graphs.py``).
reductions = 0
reduction_bytes = 0


def _reduce(dev0: torch.device, *partials):
    """One reduction point: each list of per-shard partials added in
    shard order on ``dev0`` (one sum a list; a tuple for several)."""
    global reductions, reduction_bytes
    reductions += 1
    reduction_bytes += sum(int(p[0].nbytes) for p in partials)
    out = tuple(sum_in_order(p, dev0) for p in partials)
    return out if len(out) > 1 else out[0]
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
                   replace_every: int = 0, batch: int = 0,
                   deep=None) -> tuple:
    """(operator_format, kernel, note): the local tier's loop kernel with
    the halo appended (``cuda-stencil-fused+rdma``), and the note naming a
    format the system's builder was forced to and a single-kernel
    pipelined iteration that does not run, as the single-device
    ``_describe_path`` words them.  On the stencil and DIA tiers the
    classic loop runs the fused SpMV, the pipelined loop the single-kernel
    iteration (``pipe``) unless ``replace_every`` or a (batch, n) solve
    disengages it (``spmv``), a batch the multi-RHS SpMV (``batched``); a
    DIA loop on a one-vector SpMV names the kernel of the shards' plan.
    ``deep`` (the s-step and deep-pipelined solvers' :class:`DeepDevice`)
    names the loop's SpMV without the dot (``spmv``, or ``batched``) and
    adds the deep ghost zones to the note: their depth and the rounds of
    their exchange."""
    has_pipe = ss.local_fmt in ("stencil", "dia")
    engaged = pipelined and has_pipe and replace_every == 0 and not batch
    body = ("spmv" if not has_pipe else "batched" if batch
            else "spmv" if deep is not None
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
    if deep is not None:
        note = "; ".join(filter(None, (
            f"deep ghost zones depth {deep.depth} ({deep.nrounds} "
            "exchange rounds, interface and skin on ell_spmv)", note)))
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
        return p, t, _reduce(dev0, parts)

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


def _update_step(dev0: torch.device, want_pp: bool):
    """The classic loop's ``update`` over shards: each shard's one-pass
    x += alpha p, r -= alpha t with its |r|² (and |p|²) partials
    (``acg_torch/ops/cg_update.py``), the partials summed in shard
    order."""
    def update(x, r, p, t, alpha):
        rrs, pps = [], []
        for xi, ri, pi, ti in zip(x, r, p, t):
            rr, pp = cg_update(xi, ri, pi, ti, on_device(alpha, xi.device),
                               want_pp)
            rrs.append(rr)
            pps.append(pp)
        if want_pp:
            return _reduce(dev0, rrs, pps)
        return _reduce(dev0, rrs), None

    return update


def _pipe_step(ss: ShardedSystem, dev0: torch.device, wire: str):
    """The pipelined loop's ``iter_step`` on stencil and DIA shards: the
    halo of w, then on each shard its single-kernel pipelined iteration
    (q = A_local w, the 6-vector update, gamma and delta) and the
    interface product I = A_iface ghosts(w) folded into its border rows,
    which is exact since the update is linear in q: z' += I, w' -=
    alpha I, delta -= alpha <I, r'> (p', s', x', r' and gamma do not
    depend on q).  The partials of gamma and delta are summed in shard
    order.  The kernel writes w' beside w, into the shards of ``w_out``
    (the loop alternates two, ``cg.py``'s ``_pipe_step``; None: new
    ones)."""
    def step(z, r, p, w, s, x, alpha, beta, w_out=None):
        ghosts = ss.exchange(w, wire)
        outs = tuple(ShardVec() for _ in range(6))
        gammas, deltas = [], []
        for i, op in enumerate(ss.local_ops):
            dev = w[i].device
            a = on_device(alpha, dev)
            *vecs, g, d = op.pipelined_iter(
                w[i], z[i], r[i], p[i], s[i], x[i], a,
                on_device(beta, dev),
                w_out=None if w_out is None else w_out[i])
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
        return outs + _reduce(dev0, gammas, deltas)

    return step


def _sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _shard_dot(dev0: torch.device):
    """The distributed dot: per-shard partials (per system for a batch)
    added in shard order on ``dev0``."""
    def dot(a, c):
        return _reduce(dev0, [batched_dot(u, v) for u, v in zip(a, c)])

    return dot


def _seed_shifts_dist(matvec, dot, b, n: int, hdt) -> np.ndarray:
    """The first block's (or the fill chain's) Newton shifts, ([B,] n)
    on the host: the Leja-ordered Chebyshev nodes scaled by the power
    iteration's estimate through the distributed operator, as
    ``cg.py``'s ``_seed_shifts`` forms them on one device."""
    lam = _host(_power_lmax(matvec, dot, b))
    return (lam[..., None] * _cheb_leja_nodes(n).astype(hdt)).astype(hdt)


def _sstep_block_dist(ss: ShardedSystem, deep, b, s: int, wire: str,
                      dev0: torch.device):
    """The s-step basis over shards (``acg_tpu``'s distributed
    ``block_fn``, ``cg_dist.py:435-490``): ONE deep exchange of the
    stacked (x, p) seeds, then on each shard, in the extended domain
    [owned | deep ghosts], the replaced residual b - A x and the 2s - 1
    Newton-shifted applications (:meth:`DeepDevice.ext_shifted`), with
    no further exchange; the per-shard Gram of the owned rows added in
    shard order (the block's ONE reduction).  ``b``'s deep ghosts are
    exchanged once, here.  Each shard's extended basis is allocated once
    and rewritten every block; the basis handed to the loop is its owned
    part (a :class:`ShardStack` of views).  The shifts are the loop's
    device tensor on ``dev0`` (a host array is uploaded)."""
    batched = b.dim() == 2
    m = 2 * s + 1
    b_ext = [torch.cat([bb, g], dim=-1)
             for bb, g in zip(b, deep.exchange(ss, b, wire))]
    Ve = [torch.empty((m,) + tuple(e.shape), dtype=e.dtype,
                      device=e.device) for e in b_ext]
    xe = [torch.empty_like(e) for e in b_ext]
    V = ShardStack(v[..., :n] for v, n in zip(Ve, deep.nown))

    def block_fn(x, p, shifts):
        th = torch.as_tensor(shifts, device=dev0)
        if batched:
            th = th[:, None, :]
        gh = deep.exchange(ss, [torch.stack([xi, pi]) for xi, pi in
                                zip(x, p)], wire)
        for i, n in enumerate(deep.nown):
            v, e = Ve[i], xe[i]
            e[..., :n].copy_(x[i])
            e[..., n:].copy_(gh[i][0])
            v[0][..., :n].copy_(p[i])
            v[0][..., n:].copy_(gh[i][1])
            deep.ext_shifted(ss, i, e, v[s + 1], minuend=b_ext[i])
            for j in range(s):
                deep.ext_shifted(ss, i, v[j], v[j + 1], th[..., j])
            for j in range(s - 1):
                deep.ext_shifted(ss, i, v[s + 1 + j], v[s + 2 + j],
                                 th[..., j])
        return V, _reduce(dev0, [gram(t) for t in V.shards])

    return block_fn


def _combine_shards(c, V: ShardStack) -> ShardVec:
    """The basis combination over shards: each shard's ``combine``."""
    return ShardVec(combine(on_device(c, t.device), t) for t in V.shards)


def _block_dot_shards(dev0: torch.device):
    """The deep loop's dot block over shards: each shard's ``block_dot``
    of its ring against its vector, added in shard order (the body's
    ONE reduction)."""
    def dots(Z: ShardStack, v):
        return _reduce(dev0, [block_dot(t, u) for t, u in zip(Z.shards, v)])

    return dots


def _deep_fill(ss: ShardedSystem, deep, shifts, wire: str):
    """The deep-pipelined fill chain over shards (``acg_tpu``'s
    ``cg_dist.py:843-856``): ONE depth-l exchange of z_0, then on each
    shard the l shifted extended applications z_{j+1} = (A - sigma_j)
    z_j in the skin, their owned rows written into the ring slots."""
    batched = shifts.dim() == 2
    l = deep.depth

    def fill(zs):
        gh = deep.exchange(ss, zs[0], wire)
        for i, n in enumerate(deep.nown):
            cur = torch.cat([zs[0][i], gh[i]], dim=-1)
            nxt = torch.empty_like(cur)
            sh = on_device(shifts, cur.device)
            for j in range(l):
                deep.ext_shifted(ss, i, cur, nxt,
                                 sh[:, j, None] if batched else sh[j])
                zs[j + 1][i].copy_(nxt[..., :n])
                cur, nxt = nxt, cur

    return fill


def _refuse_rdma(kind: str, method: HaloMethod, batch: int,
                 wire: str) -> None:
    """What the rdma halo (a put+signal kernel moving 1-D distance-1
    packs of raw vector words) does not carry: the deep ghost exchange,
    a batch, a compressed wire."""
    if method != HaloMethod.RDMA:
        return
    if kind in ("cg-sstep", "cg-pipelined-deep"):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"{'s-step' if kind == 'cg-sstep' else 'deep-pipelined'}"
                       " solves support the ppermute/allgather halo tiers "
                       "(the rdma halo, a put+signal kernel, moves 1-D "
                       "distance-1 packs, not the deep ghost exchange)")
    if batch:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "multi-RHS solves support the ppermute/allgather "
                       "halo tiers (the rdma halo, a put+signal kernel, "
                       "moves 1-D packs)")
    if wire != "f32":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "halo_wire compression applies to the ppermute/"
                       "allgather halo tiers (the rdma halo, a put+signal "
                       "kernel, writes raw vector words)")


def _solve_dist(kind: str, A, b, x0, options: SolverOptions,
                stats: SolveStats | None, build_kw: dict,
                atol2_floor=None, loop: str | None = None):
    """What every distributed solver runs (``acg_tpu``'s
    ``_solve_dist``): ``kind`` "cg", "cg-pipelined", "cg-sstep" or
    "cg-pipelined-deep"; the refusals, the shards (and for the last two
    their deep ghost zones), the loop and the result.  ``atol2_floor``
    (the s-step and deep fallbacks) is a squared absolute threshold, a
    scalar or per system, folded into the atol term.  ``loop`` as
    :func:`acg_torch.solvers.cg.cg`: the graph loop where every shard is
    on one card; shards on several cards run the open loop, with the
    s-step and deep coefficient kernels on the first shard's card."""
    o = options
    pipelined = kind in ("cg-pipelined", "cg-pipelined-deep")
    if kind == "cg-sstep":
        s = _sstep_validate(o)
    elif kind == "cg-pipelined-deep":
        l = _deep_validate(o)
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
    _refuse_rdma(kind, method, batch, o.halo_wire)
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
    graph = resolve_loop(loop, ss.devices)
    mon = (LoopMonitor(o.monitor_every, o.maxits, vdt, dev0)
           if o.monitor_every > 0 else None)
    deep = (build_deep_device(ss, s if kind == "cg-sstep" else l)
            if kind in ("cg-sstep", "cg-pipelined-deep") else None)
    b_sh = ss.to_sharded(b)
    x0_sh = (ss.to_sharded(x0) if x0 is not None
             else ShardVec(torch.zeros_like(v) for v in b_sh))

    def scalar(v):
        return torch.tensor(v, dtype=vdt, device=dev0)

    dot = _shard_dot(dev0)

    def matvec(v):
        return ss.matvec(v, wire)

    atol2 = (o.residual_atol ** 2 if atol2_floor is None
             else np.maximum(o.residual_atol ** 2, atol2_floor))
    stop2 = (scalar(atol2), scalar(o.residual_rtol ** 2))
    st = stats if stats is not None else SolveStats()
    certify = _certifies(o)
    sstep = 0
    ndisp = why = None
    _sync(ss.devices)
    t0 = time.perf_counter()
    if kind == "cg-sstep":
        sstep = s
        hdt = np.dtype(ss.vec_dtype)
        r0 = b_sh - matvec(x0_sh)
        rr0 = np.atleast_1d(_host(dot(r0, r0)))
        shifts0 = _seed_shifts_dist(matvec, dot, b_sh, s, hdt).reshape(
            batch or 1, s)
        hstop2 = (hdt.type(o.residual_atol ** 2),
                  hdt.type(o.residual_rtol ** 2))
        x, k, _rr, flag, hist, _ = cg_sstep_while(
            _sstep_block_dist(ss, deep, b_sh, s, wire, dev0),
            _combine_shards, b_sh, x0_sh, r0, rr0, shifts0, hstop2, s,
            o.maxits, stats=st, monitor_every=o.monitor_every, graph=graph)
        # every exit certified by a fresh |b - A x|² through the
        # ordinary distributed operator
        rT = b_sh - matvec(x)
        rr = np.atleast_1d(_host(dot(rT, rT)))
        flag, hist = _sstep_certify(rr, k, flag, hist, hstop2, rr0)
        if not batch:
            k, rr, flag, rr0, hist = (int(k[0]), rr[0], int(flag[0]),
                                      rr0[0], hist[0])
        dxx = None
    elif kind == "cg-pipelined-deep":
        shifts = torch.from_numpy(_seed_shifts_dist(
            matvec, dot, b_sh, l, np.dtype(ss.vec_dtype))).to(dev0)
        cert = (lambda v: ss.matvec(v, "f32")) if wire != "f32" else None
        fill = _deep_fill(ss, deep, shifts, wire)
        dots = _block_dot_shards(dev0)
        bufs = deep_buffers(b_sh, l, o.maxits, graph, st)
        (x, k, rr, flag, rr0, hist, kall, ndisp,
         why) = _deep_dispatches(
            lambda xx, *restart: cg_pipelined_deep_while(
                matvec, dots, _combine_shards, dot, b_sh, xx, stop2, l,
                shifts, o.maxits, o.check_every, o.replace_every, certify,
                *restart, guard=o.guard_nonfinite, fill=fill,
                cert_matvec=cert, monitor=mon, graph=graph, buffers=bufs,
                stats=st), x0_sh, bool(batch),
            o.maxits)
        if not batch:
            flag = int(flag)
        dxx = None
    else:
        return _dist_solve(_dist_loop(kind, ss, b_sh, o, graph), kind, ss,
                           b, x0, x0_sh, o, st, graph, atol2_floor, t0)
    _sync(ss.devices)
    tsolve = time.perf_counter() - t0
    ss.check_transport()
    x_global = torch.from_numpy(ss.from_sharded(x))
    if why is not None or (kind == "cg-sstep"
                           and np.any(np.atleast_1d(flag) == _GRAM_BAD)):
        # classic distributed CG re-solves from the last good iterate,
        # under each system's own criterion (and re-diagnoses a truly
        # indefinite operator); the deep fallback at the full-width wire,
        # since a compressed exchange may be why the basis drifted
        kdone = int(np.max(_host(k))) if kind == "cg-sstep" else kall
        rr_h, rr0_h = _host(rr), _host(rr0)
        x_part = _sstep_fallback_x0(x_global.numpy(), x0, rr_h, rr0_h)
        o2 = dataclasses.replace(
            o, maxits=max(o.maxits - kdone, 0),
            **(dict(sstep=0) if kind == "cg-sstep"
               else dict(pipeline_depth=1, halo_wire="f32")))
        return _sstep_fallback(
            lambda: _solve_dist("cg", ss, b, x_part, o2, st, {},
                                atol2_floor=_sstep_fallback_stop(o, rr0_h),
                                loop=loop),
            kdone, _host(k) if batch else None, sstep or l,
            why or "indefinite/non-finite Gram matrix",
            spent_flops=kdone * cg_flops_per_iter(
                ss.nnz, ss.nrows, pipelined=kind != "cg-sstep",
                sstep=sstep),
            label=None if kind == "cg-sstep"
            else f"cg-pipelined-deep(l={l})")
    return _dist_finish(ss, kind, x_global, k, rr, dxx, flag, rr0, hist, o,
                        st, tsolve, b, graph, deep=deep, ndisp=ndisp,
                        sstep=sstep)


def _dist_finish(ss, kind: str, x_global, k, rr, dxx, flag, rr0, hist,
                 o: SolverOptions, st, tsolve: float, b, graph: bool,
                 deep=None, ndisp=None, sstep: int = 0):
    """The distributed solve's result: its path report (the local tier's
    loop kernel and the halo, the deep zones, the dispatches, an open
    loop) and :func:`acg_torch.solvers.cg._finish` on the gathered x."""
    pipelined = kind in ("cg-pipelined", "cg-pipelined-deep")
    batch = b.shape[0] if b.ndim == 2 else 0
    name, kernel, note = _describe_path(
        ss, pipelined and deep is None,
        o.replace_every if pipelined else 0, batch, deep)
    if ndisp is not None:
        note = (f"deep pipeline depth {o.pipeline_depth}, {ndisp} "
                f"dispatch(es), wire={o.halo_wire}; " + note)
    if not graph:
        ncards = len({d for d in ss.devices if d.type == "cuda"})
        note = _join_note(note, open_loop_note(
            f"shards on {ncards} cards" if ncards > 1 else "asked",
            ss.devices[0].type))

    class _Meta:  # the flop model's inputs, for _finish
        nrows = ss.nrows
        nnz = ss.nnz

    track_diff = o.diffatol > 0 or o.diffrtol > 0
    return _finish(_Meta, x_global, k, rr, flag, rr0, o, tsolve,
                   np.linalg.norm(b, axis=-1),
                   dxx=dxx if track_diff else None, stats=st,
                   path=(name, kernel, note), hist=hist,
                   pipelined=pipelined, sstep=sstep,
                   solver=kind if deep is not None else None,
                   loop="graph" if graph else "open")


def _dist_loop(kind: str, ss: ShardedSystem, b_sh, o: SolverOptions,
               graph: bool, capture_first: bool = False):
    """The classic or pipelined loop over ``ss``'s shards for right-hand
    sides shaped like ``b_sh`` (its buffer, per-shard vectors): the fused
    beta-first step and the per-shard one-pass update on stencil and DIA
    shards (the split step elsewhere); pipelined, the folded per-shard
    iteration where it runs."""
    dev0 = ss.devices[0]
    wire = o.halo_wire
    dot = _shard_dot(dev0)
    on_pipe = ss.local_fmt in ("stencil", "dia")
    batch = b_sh.dim() == 2

    def matvec(v):
        return ss.matvec(v, wire)

    if kind == "cg-pipelined":
        def dot2(a1, b1, a2, b2):
            # the pipelined loop's one reduction point: both dots' sums
            return _reduce(dev0,
                           [batched_dot(u, v) for u, v in zip(a1, b1)],
                           [batched_dot(u, v) for u, v in zip(a2, b2)])

        iter_step = (_pipe_step(ss, dev0, wire)
                     if on_pipe and o.replace_every == 0 and not batch
                     else None)
        return cg_pipelined_loop(
            matvec, dot2, b_sh, o.maxits, check_every=o.check_every,
            replace_every=o.replace_every, certify=_certifies(o),
            iter_step=iter_step, guard=o.guard_nonfinite,
            segment=o.segment_iters, monitor_every=o.monitor_every,
            graph=graph, any_crit=_any_crit(o, b_sh.dtype),
            capture_first=capture_first)
    track_diff = o.diffatol > 0 or o.diffrtol > 0
    coupled = (_fused_step(ss, dev0, wire) if on_pipe
               else _split_step(ss, dot, wire))
    return cg_loop(matvec, dot, b_sh, o.maxits, track_diff,
                   check_every=o.check_every, coupled_step=coupled,
                   guard=o.guard_nonfinite,
                   update=_update_step(dev0, track_diff),
                   segment=o.segment_iters, monitor_every=o.monitor_every,
                   graph=graph, capture_first=capture_first)


def _dist_solve(L, kind: str, ss: ShardedSystem, b, x0, x0_sh,
                o: SolverOptions, st, graph: bool, atol2_floor=None,
                t0=None):
    """One classic or pipelined solve on the loop ``L``
    (:func:`_dist_loop`) from the right-hand side in ``L.b`` (``b`` the
    global host array it holds, ``x0`` the conformed host x0 or None):
    the tolerances and the diff threshold of this solve, the loop, the
    transport check, the result.  ``t0``: when the timed solve began
    (None: here)."""
    dev0 = ss.devices[0]
    vdt = getattr(torch, ss.vec_dtype)
    batch = b.shape[0] if b.ndim == 2 else 0

    def scalar(v):
        return torch.tensor(v, dtype=vdt, device=dev0)

    atol2 = (o.residual_atol ** 2 if atol2_floor is None
             else np.maximum(o.residual_atol ** 2, atol2_floor))
    stop2 = (scalar(atol2), scalar(o.residual_rtol ** 2))
    if t0 is None:
        _sync(ss.devices)
        t0 = time.perf_counter()
    if kind == "cg-pipelined":
        x, k, rr, flag, rr0, hist = L.run(x0_sh, stop2, st)
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
        x, k, rr, dxx, flag, rr0, hist = L.run(x0_sh, stop2, diffstop, st)
    _sync(ss.devices)
    tsolve = time.perf_counter() - t0
    ss.check_transport()
    return _dist_finish(ss, kind, torch.from_numpy(ss.from_sharded(x)), k,
                        rr, dxx, flag, rr0, hist, o, st, tsolve, b, graph)


def aot_step(A, b=None, x0=None, options: SolverOptions = SolverOptions(),
             pipelined: bool = False, solver: str | None = None,
             loop: str | None = None, **build_kw) -> AotSolve:
    """Distributed twin of :func:`acg_torch.solvers.cg.aot_step`
    (``acg_tpu.solvers.cg_dist.aot_step``): the resident classic or
    pipelined solve over the shards of ``A`` (a built
    :class:`ShardedSystem`, or what :func:`build_sharded` takes) for b's
    shape, its per-shard buffers made once and on one card its block
    runner capturing each block at its first run; a dispatch copies the
    new b (and x0) into them, results bit for bit :func:`cg_dist` /
    :func:`cg_pipelined_dist`'s.  The deep-pipelined kind over shards is
    not resident in this port (``ERR_NOT_SUPPORTED``: the Session runs
    it through :func:`cg_pipelined_deep_dist`); other refusals as the
    one-device ``aot_step`` and :func:`cg_dist`."""
    o = options
    kind = _aot_kind(solver, pipelined, o)
    if kind == "cg-pipelined-deep":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "the deep-pipelined loop over shards has no resident "
                       "solve; use cg_pipelined_deep_dist")
    check_wire(o.halo_wire)
    ss = build_sharded(A, **build_kw)
    b = np.zeros(ss.nrows) if b is None else np.asarray(b)
    shape = tuple(b.shape)
    batch = shape[0] if len(shape) == 2 else 0
    _refuse_rdma(kind, ss.method, batch, o.halo_wire)
    if shape[-1] != ss.nrows:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"vectors of shape {shape} for an operator of "
                       f"{ss.nrows} rows")
    graph = resolve_loop(loop, ss.devices)
    b_own = ss.to_sharded(b)
    L = _dist_loop(kind, ss, b_own, o, graph, capture_first=True)
    crit = _any_crit(o, b_own.dtype)

    def dispatch(b, x0, stats, oo):
        b = np.asarray(b)
        if b.shape != shape:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"AOT signature mismatch: executable was built "
                           f"for shape {shape}, got {b.shape}")
        if kind != "cg" and _any_crit(oo, b_own.dtype) != crit:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "AOT signature mismatch: the squared tolerances' "
                           "non-zero-ness in the vector dtype differs from "
                           "the executable's")
        if x0 is not None:
            x0 = conform_x0_batch(np.asarray(x0), b.shape,
                                  lambda v: np.tile(v[None, :], (batch, 1)))
            if x0.shape != b.shape:
                raise AcgError(Status.ERR_INVALID_VALUE,
                               f"initial guess of {x0.shape[-1]} entries "
                               f"for an operator of {ss.nrows} rows")
        _keep(b_own, ss.to_sharded(b))
        x0_sh = (ss.to_sharded(x0) if x0 is not None
                 else ShardVec(torch.zeros_like(v) for v in b_own))
        st = stats if stats is not None else SolveStats()
        return _dist_solve(L, kind, ss, b, x0, x0_sh, oo, st, graph)

    return AotSolve(dispatch, kind=kind, shape=shape,
                    vec_dtype=b_own.dtype,
                    path=_describe_path(ss, kind == "cg-pipelined",
                                        o.replace_every, batch),
                    options=o, runners=(L.runner,))


def cg_dist(A, b, x0=None, options: SolverOptions = SolverOptions(),
            stats: SolveStats | None = None, loop: str | None = None,
            **build_kw):
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
    or a compressed ``halo_wire`` under the rdma halo.  Every shard's x
    and r updates and |r|² partial are one kernel pass
    (``ops/cg_update.py``).  With every shard on one card the loop's
    blocks run as CUDA graphs (``loop`` as :func:`acg_torch.solvers.cg.cg`);
    shards on several cards run the open loop, which ``kernel_note``
    says.  ``options.segment_iters`` and ``options.monitor_every`` as in
    :func:`acg_torch.solvers.cg.cg` (one monitor stream for the whole
    mesh)."""
    return _solve_dist("cg", A, b, x0, options, stats, build_kw, loop=loop)


def cg_pipelined_dist(A, b, x0=None,
                      options: SolverOptions = SolverOptions(),
                      stats: SolveStats | None = None,
                      loop: str | None = None, **build_kw):
    """Distributed pipelined CG (``acg_tpu.solvers.cg_dist``
    ``cg_pipelined_dist``): one halo exchange and ONE reduction point (the
    two shard-ordered sums of gamma and delta) per iteration.  On stencil
    and DIA shards each iteration is one single-kernel pipelined iteration
    a shard with the interface folded in (``cuda-stencil-pipe+<halo>``,
    ``cuda-dia-pipe+<halo>``); ``options.replace_every`` > 0, a (B, n)
    ``b`` or ELL and sgell shards run the open-coded body.  Arguments,
    results and errors as :func:`cg_dist` (``loop`` too); residual
    criteria only (the diff criteria raise ``ERR_NOT_SUPPORTED``)."""
    return _solve_dist("cg-pipelined", A, b, x0, options, stats, build_kw,
                       loop=loop)


def cg_sstep_dist(A, b, x0=None, options: SolverOptions = SolverOptions(),
                  stats: SolveStats | None = None, recycle=None,
                  loop: str | None = None, **build_kw):
    """Distributed s-step CG (``acg_tpu.solvers.cg_dist.cg_sstep_dist``):
    per ``options.sstep`` iterations ONE deep exchange (the stacked x and
    p seeds, depth s) and ONE reduction (the shards' Gram matrices added
    in shard order); the 2s basis applications run on each shard in its
    deep ghost zones (``acg_torch/parallel/deep.py``, built once and
    cached on the system), through the local tier's SpMV kernel without
    the dot and ``ell_spmv`` on the deep interface and the skin.  The
    loop is :func:`acg_torch.solvers.loops.cg_sstep_while`; every exit is
    certified through the ordinary distributed operator, and an
    indefinite or non-finite Gram falls back to classic :func:`cg_dist`
    from the last good iterate under each system's own criterion (said in
    ``kernel_note``).  The Gram sum stays in shard order and the
    coefficient kernel (``ops/sstep_coeffs.py``) runs on the first
    shard's card; with every shard on one card a block replays as one
    CUDA graph (``loop`` as :func:`cg_dist`).  The rdma halo raises
    ``ERR_NOT_SUPPORTED``; so does ``recycle`` (not yet ported).
    Arguments, results and other errors as :func:`cg_dist`; residual
    criteria only."""
    if recycle is not None:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "recycle (a RecycleState): not yet ported")
    return _solve_dist("cg-sstep", A, b, x0, options, stats, build_kw,
                       loop=loop)


def cg_pipelined_deep_dist(A, b, x0=None,
                           options: SolverOptions = SolverOptions(),
                           stats: SolveStats | None = None,
                           loop: str | None = None, **build_kw):
    """Distributed depth-l pipelined CG, l = ``options.pipeline_depth``
    (``acg_tpu.solvers.cg_dist.cg_pipelined_deep_dist``): one halo and
    ONE reduction a body (the shards' (2l+1)-dot partials added in shard
    order), l reductions in flight.  Each dispatch's fill chain is one
    depth-l deep exchange feeding l extended applications in the skin;
    the entry residual and the certifier run the distributed operator at
    the full-width wire when ``options.halo_wire`` compresses the loop's.
    The host re-dispatches as :func:`acg_torch.solvers.cg.cg_pipelined_deep`
    does, and ``_DEEP_MAX_BAD`` bad dispatches fall back to classic
    :func:`cg_dist` at the full-width wire.  Depth 1 IS
    :func:`cg_pipelined_dist`.  A body's scalar chain is one launch of
    ``ops/deep_coeffs.py`` on the first shard's card; with every shard on
    one card the bodies between two host reads replay as CUDA graphs,
    one set of captures for every dispatch (``loop`` as :func:`cg_dist`).
    The rdma halo raises ``ERR_NOT_SUPPORTED``.  Arguments, results and
    other errors as :func:`cg_dist`; residual criteria only."""
    if options.pipeline_depth <= 1:
        return cg_pipelined_dist(A, b, x0, options, stats, loop=loop,
                                 **build_kw)
    return _solve_dist("cg-pipelined-deep", A, b, x0, options, stats,
                       build_kw, loop=loop)


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
