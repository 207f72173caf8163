"""Device-resident sharded system: one local operator per shard.

The port of ``acg_tpu/parallel/sharded.py``.  The JAX package pads every
shard to one length and stacks them on a mesh axis, because one SPMD
program runs them all; here each shard is a list entry of its own length
on its own device (``devices[p]``), and results are compared in
global order.  Per shard:

- the local operator ``A_local`` (owned rows × owned columns) is one of
  the single-device tiers: the matrix-free stencil when every part's
  block is one uniform verified stencil (:func:`recognize_parts`), DIA
  over the union of the parts' diagonal offsets when the stacked bands
  are dense enough (bf16 or two-value int8 storage when exact, decided
  over all shards as the JAX package decides over its stack), the
  segmented-gather ELL of the RCM-relabelled parts at f32, else padded
  ELL (:func:`resolve_local_fmt`);
- the interface operator ``A_iface`` (owned rows × ghost slots) is
  the sliced layout (``ops/sliced.py``) of the padded ELL over the
  shard's border rows only (those with an interface entry), applied by
  the rectangular ``ell_spmv`` and added into those rows; its columns
  are checked against the ghost count when it is sliced, once.  The
  JAX package's uniform SPMD layout keeps a zero interface row for every
  owned row, which on one card streams the whole shard a second time per
  SpMV for a surface's worth of entries;
- the halo moves ghosts by the system's :class:`HaloMethod`.

A shard vector has its local operator's padded length (``nrows_padded``);
padding entries stay zero through every CG update, as on one device.
:class:`ShardVec` carries the per-shard vectors, one system or a (B, n)
batch, through the classic and pipelined loops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_torch.config import HaloMethod
from acg_torch.errors import AcgError, Status
from acg_torch.ops.dia import (DeviceDia, DiaMatrix, lossless_cast,
                               resolve_mat_dtype, torch_dtype,
                               two_value_scales)
from acg_torch.ops.sgell import (MIN_FILL, TILE, device_sgell_from_pack,
                                 pack_csr, sgell_require_available,
                                 sgell_supported)
from acg_torch.ops.sliced import slice_ell
from acg_torch.ops.spmv import DeviceEll, ell_spmv
from acg_torch.ops.stencil import DeviceStencil, recognize_stencil
from acg_torch.parallel.halo import (HaloTables, ShardTables,
                                     build_halo_tables, halo_allgather,
                                     halo_ppermute, on_device,
                                     shard_tables)
from acg_torch.parallel.mesh import make_mesh
from acg_torch.parallel.rdma_halo import RdmaState, halo_rdma
from acg_torch.partition.graph import PartitionedSystem, rcm_localize
from acg_torch.sparse.ell import EllMatrix
from acg_torch.utils.timing import host_step


def _pad8(n: int) -> int:
    return max(-(-n // 8) * 8, 8)


def per_part_offsets(ps: PartitionedSystem) -> list:
    """Each part's sorted unique diagonal offsets (one O(nnz) sweep,
    shared by the stencil, DIA and tier decisions)."""
    out = []
    for p in ps.parts:
        A = p.A_local
        if not A.nnz:
            out.append(np.empty(0, dtype=np.int64))
            continue
        rowids = np.repeat(np.arange(A.nrows, dtype=np.int64), A.rowlens)
        out.append(np.unique(A.colidx.astype(np.int64) - rowids))
    return out


def local_dia_offsets(ps: PartitionedSystem, per_part=None) -> tuple:
    """Union of the nonzero-diagonal offsets of every part's local
    block."""
    if per_part is None:
        per_part = per_part_offsets(ps)
    offs: set = set()
    for po in per_part:
        offs.update(po.tolist())
    return tuple(sorted(int(o) for o in offs))


def local_dia_efficiency(ps: PartitionedSystem, offsets=None) -> float:
    """Fraction of the stacked (P, D_union, max nown) band storage that is
    real nonzeros: DIA against ELL for the local operator, at the
    single-device break-even 0.25."""
    D = len(offsets if offsets is not None else local_dia_offsets(ps))
    nown_max = max((p.nown for p in ps.parts), default=0)
    if D == 0 or nown_max == 0:
        return 0.0
    lnnz = sum(p.A_local.nnz for p in ps.parts)
    return lnnz / (D * nown_max * ps.nparts)


def _sgell_nown(maxnown: int) -> int:
    """The packs' common padded length: whole 1024-row tiles, as the JAX
    package's uniform shards have (its fill gate sees that length)."""
    return max(-(-maxnown // TILE) * TILE, TILE)


def _try_local_sgell(ps: PartitionedSystem, vec_dtype,
                     min_fill: float | None = None):
    """Every part's sgell pack at the common padded length, or None when
    the tier does not apply (vector dtype, or a part's fill below the
    gate; ``min_fill`` overrides the gate, 0.0 for a forced tier)."""
    if vec_dtype is None or not sgell_supported(vec_dtype):
        return None
    fill = MIN_FILL if min_fill is None else min_fill
    nown = _sgell_nown(max((p.nown for p in ps.parts), default=1))
    packs = []
    for p in ps.parts:
        pk = pack_csr(p.A_local, vec_dtype, nrows=nown,
                      min_fill=fill if p.A_local.nnz else 0.0)
        if pk["vals"] is None:
            return None
        packs.append(pk)
    return packs


def recognize_parts(ps: PartitionedSystem, vec_dtype=None, per_part=None):
    """(StencilSpec, "") when EVERY part's local block is the same
    verified constant-coefficient stencil (equal boxes of a natural-order
    grid), else (None, reason)."""
    vdt = np.dtype(vec_dtype) if vec_dtype is not None else None
    spec0 = None
    for i, p in enumerate(ps.parts):
        spec, why = recognize_stencil(
            p.A_local, dtype=vdt,
            offsets=per_part[i] if per_part is not None else None)
        if spec is None:
            return None, f"part {i}: {why}"
        if spec0 is None:
            spec0 = spec
        elif spec != spec0:
            return None, (f"part {i} recognizes a different stencil (grid "
                          f"{spec.grid} vs {spec0.grid}): the shards need "
                          "one uniform spec")
    if spec0 is None:
        return None, "no parts"
    return spec0, ""


def resolve_local_fmt(ps: PartitionedSystem, fmt: str = "auto",
                      try_rcm: bool = True, vec_dtype=None):
    """The ``fmt="auto"`` decision of the distributed path: ``(ps, fmt,
    extra)`` with fmt "stencil" (extra the spec), "dia" (the union
    offsets), "sgell" (the packs) or "ell" (None); ``ps`` may come back
    RCM-relabelled.  The stencil when every part recognizes one uniform
    stencil; DIA when the stacked bands are dense enough
    (:func:`local_dia_efficiency` >= 0.25); else, with ``try_rcm``, the
    same test after a per-part RCM pass; else the sgell packs of the
    best ordering at f32 vectors; else ELL on the original ordering.
    A forced format is taken or raises: ``"stencil"`` recognizes,
    ``"sgell"`` packs at any fill, ``"dia"`` takes the union offsets,
    ``"ell"`` is always possible.  The result is what
    :meth:`ShardedSystem.build` takes."""
    if fmt not in ("auto", "stencil", "dia", "sgell", "ell"):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"unknown operator format {fmt!r} "
                       "(auto|dia|ell|sgell|stencil)")
    if fmt == "sgell":
        # a forced tier packs or raises, never runs another
        sgell_require_available(vec_dtype)
        packs = _try_local_sgell(ps, vec_dtype, min_fill=0.0)
        if packs is None:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "format 'sgell' forced but the local blocks "
                           "did not pack (degenerate geometry)")
        return ps, fmt, packs
    if fmt == "stencil":
        spec, why = recognize_parts(ps, vec_dtype)
        if spec is None:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "format 'stencil' forced but the local blocks "
                           "are not one uniform recognized "
                           f"constant-coefficient stencil: {why}")
        return ps, "stencil", spec
    if fmt == "dia":
        return ps, fmt, local_dia_offsets(ps)
    if fmt != "auto":
        return ps, fmt, None
    ppo = per_part_offsets(ps)
    spec, _why = recognize_parts(ps, vec_dtype, per_part=ppo)
    if spec is not None:
        return ps, "stencil", spec
    offs = local_dia_offsets(ps, per_part=ppo)
    if local_dia_efficiency(ps, offs) >= 0.25:
        return ps, "dia", offs
    best = ps
    if try_rcm:
        ps_rcm = rcm_localize(ps)
        offs_rcm = local_dia_offsets(ps_rcm)
        if local_dia_efficiency(ps_rcm, offs_rcm) >= 0.25:
            return ps_rcm, "dia", offs_rcm
        best = ps_rcm
    packs = _try_local_sgell(best, vec_dtype)
    if packs is not None:
        return best, "sgell", packs
    return ps, "ell", None


def _shard_arg(a, i: int, dev: torch.device):
    """Shard ``i``'s part of one operand: its tensor for per-shard vectors,
    a loop scalar moved to ``dev``, anything else as it is."""
    if isinstance(a, ShardVec):
        return a[i]
    return on_device(a, dev) if isinstance(a, torch.Tensor) else a


class ShardVec(list):
    """Per-shard vectors, one tensor a shard, carried through the CG loops
    (``acg_torch.solvers.loops``) in place of one tensor: each shard is
    (n,), or (B, n) for B systems, and the vector operations the loops
    use (``-``, ``/`` by a scalar, ``clone``, ``select``, ``copy_``,
    ``add_``, ``mul_``, ``addcmul_``, ``window``, ``torch.zeros_like``,
    ``torch.addcmul``, ``torch.where``, ``torch.mul``, ``torch.sub``, the
    last three also with ``out=``) apply shard by shard.  A scalar of the
    loop (0-d, or per system (B,) and (B, 1)) lives on the first shard's
    device and is moved to a shard's device where it differs."""

    def dim(self) -> int:
        return self[0].dim()

    @property
    def device(self) -> torch.device:
        return self[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    def clone(self) -> "ShardVec":
        return ShardVec(t.clone() for t in self)

    def select(self, dim: int, i: int) -> "ShardVec":
        """Every shard's ``select(dim, i)`` (system i of a batch), as
        views."""
        return ShardVec(t.select(dim, i) for t in self)

    def window(self, w: int) -> "ShardStack":
        """w zero vectors shaped like these, one (w, [B,] n) stack a
        shard."""
        return ShardStack(torch.zeros((w,) + tuple(t.shape), dtype=t.dtype,
                                      device=t.device) for t in self)

    def __sub__(self, other) -> "ShardVec":
        return ShardVec(a - b for a, b in zip(self, other))

    def __truediv__(self, scalar) -> "ShardVec":
        return ShardVec(a / on_device(scalar, a.device) for a in self)

    def copy_(self, other) -> "ShardVec":
        for a, b in zip(self, other):
            a.copy_(b)
        return self

    def add_(self, other) -> "ShardVec":
        for a, b in zip(self, other):
            a.add_(b)
        return self

    def mul_(self, scalar) -> "ShardVec":
        for a in self:
            a.mul_(on_device(scalar, a.device))
        return self

    def addcmul_(self, t1, t2, value=1) -> "ShardVec":
        """self += value · t1 · t2, each factor a ShardVec or a loop
        scalar."""
        for i, a in enumerate(self):
            a.addcmul_(_shard_arg(t1, i, a.device),
                       _shard_arg(t2, i, a.device), value=value)
        return self

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.zeros_like and not kwargs:
            return cls(torch.zeros_like(t) for t in args[0])
        if func not in (torch.addcmul, torch.where, torch.mul, torch.sub):
            return NotImplemented
        out = kwargs.pop("out", None)
        shards = next(a for a in args if isinstance(a, ShardVec))
        res = cls()
        for i, t in enumerate(shards):
            a_i = [_shard_arg(a, i, t.device) for a in args]
            if out is not None:
                kwargs["out"] = out[i]
            res.append(func(*a_i, **kwargs))
        return res


class ShardStack:
    """Per-shard stacks of vectors, one (m, [B,] n) tensor a shard (its
    ``shards``): the s-step basis and the deep-pipelined rings over
    shards.  ``S[j]`` is row j of every shard, a :class:`ShardVec` of
    views; ``select(dim, i)`` selects in every shard."""

    def __init__(self, shards):
        self.shards = tuple(shards)

    def __getitem__(self, j: int) -> ShardVec:
        return ShardVec(t[j] for t in self.shards)

    def select(self, dim: int, i: int) -> "ShardStack":
        return ShardStack(t.select(dim, i) for t in self.shards)


def sum_in_order(parts, dev: torch.device) -> torch.Tensor:
    """Per-shard partial scalars added in shard order on ``dev``."""
    s = on_device(parts[0], dev)
    for q in parts[1:]:
        s = s + on_device(q, dev)
    return s


@dataclasses.dataclass
class ShardedSystem:
    """The distributed operator: per-shard local and interface operators
    on their devices (shard p on ``devices[p]``), and the halo
    schedule."""

    devices: tuple
    ps: PartitionedSystem
    local_fmt: str                  # "stencil" | "dia" | "sgell" | "ell"
    local_ops: tuple                # per shard: a single-device operator
    iface: tuple                    # per shard: (SlicedEll, rows) or None
    halo: HaloTables
    tables: ShardTables
    method: HaloMethod
    nnz: int
    nrows: int
    vec_dtype: str
    loffsets: tuple = ()
    rdma: RdmaState | None = None
    forced_fmt: str | None = None   # the format a caller forced, if any
    # the deep ghost zones built for the shards, by depth
    # (``parallel/deep.py``); they do not depend on the halo, so every
    # copy of the system shares them
    deep_cache: dict = dataclasses.field(default_factory=dict,
                                         compare=False, repr=False)

    @property
    def nparts(self) -> int:
        return self.ps.nparts

    @classmethod
    def build(cls, ps: PartitionedSystem, fmt: str, extra, devices=None,
              dtype=None, method=HaloMethod.PPERMUTE, mat_dtype="auto",
              forced: bool = False,
              timings: dict | None = None) -> "ShardedSystem":
        """Upload a host partition (the analog of solver init's device
        upload, reference acg/cgcuda.c:138-328) onto ``make_mesh(P,
        devices)``, its local operators of the resolved format ``fmt``
        with its ``extra`` (what :func:`resolve_local_fmt` returns: the
        stencil spec, the DIA offsets, the sgell packs, or None for ELL).
        ``forced`` records that a caller forced the format (the solve
        report's note).  ``timings`` gathers the host seconds of
        ``halo_tables`` and ``shards`` (build and upload), and of the
        parts of ``shards`` spent uploading (``upload``: the sgell and
        ELL shards) and slicing (``slice``: those and the interface
        operators) on the devices."""
        vdt = np.dtype(dtype if dtype is not None else np.float64)
        method = HaloMethod(method)
        if fmt not in ("stencil", "dia", "sgell", "ell") or (
                extra is None) != (fmt == "ell"):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"build takes a resolved format and its data, "
                           f"not {fmt!r} with {type(extra).__name__}")
        devs = make_mesh(ps.nparts, devices)
        tdt = torch_dtype(vdt)
        with host_step(timings, "halo_tables"):
            tables = build_halo_tables(
                ps, nghost_max=_pad8(max(max((p.nghost for p in ps.parts),
                                             default=1), 1)))
            st = shard_tables(tables, ps, devs)
        with host_step(timings, "shards"):
            ops, mdt = _local_operators(ps, devs, fmt, vdt, mat_dtype,
                                        extra, timings)
            iface = _iface_operators(ps, devs, vdt, mat_dtype,
                                     mdt if fmt == "ell" else None, timings)
        ss = cls(devices=devs, ps=ps, local_fmt=fmt, local_ops=tuple(ops),
                 iface=tuple(iface), halo=tables, tables=st,
                 method=HaloMethod.PPERMUTE,
                 nnz=sum(p.A_local.nnz + p.A_iface.nnz for p in ps.parts),
                 nrows=ps.nrows, vec_dtype=str(tdt).removeprefix("torch."),
                 loffsets=tuple(extra) if fmt == "dia" else (),
                 forced_fmt=fmt if forced else None)
        return ss.with_halo(method)

    def with_halo(self, method) -> "ShardedSystem":
        """The same shards with the halo exchanged by ``method``; the
        put+signal transport (RDMA) needs every shard on a CUDA device
        and raises ``ERR_NOT_SUPPORTED`` otherwise, as the JAX package's
        does off its chips.  The deep ghost zones built for the shards
        (``parallel/deep.py``) do not depend on the halo and are shared."""
        method = HaloMethod(method)
        state = None
        if method == HaloMethod.RDMA:
            if any(d.type != "cuda" for d in self.devices):
                raise AcgError(Status.ERR_NOT_SUPPORTED,
                               "--halo rdma is the device-initiated "
                               "put+signal kernel and needs every shard on "
                               "a CUDA device; use ppermute or allgather "
                               "here")
            state = (self.rdma if self.rdma is not None else
                     RdmaState(self.tables.partner, self.tables.max_msg,
                               torch_dtype(self.vec_dtype), self.devices,
                               tables=self.tables))
        return dataclasses.replace(self, method=method, rdma=state)

    def check_transport(self) -> None:
        """Raise if an exchange of the put+signal halo failed (a launch
        error, or a wait that timed out on the card); nothing to check
        for the other halos."""
        if self.rdma is not None:
            self.rdma.check()

    # -- vectors (ref acgvector scatter/gather, acg/vector.c:938+) --

    def to_sharded(self, x_global) -> ShardVec:
        """Global host vector (n,) or batch (B, n) -> per-shard owned
        vectors on their devices, (nrows_padded,) or (B, nrows_padded),
        zero-padded to each local operator's padded length."""
        x_global = np.asarray(x_global)
        vdt = np.dtype(self.vec_dtype)
        out = ShardVec()
        for op, p, dev in zip(self.local_ops, self.ps.parts, self.devices):
            v = np.zeros(x_global.shape[:-1] + (op.nrows_padded,),
                         dtype=vdt)
            v[..., : p.nown] = x_global[..., p.owned_global]
            out.append(torch.from_numpy(v).to(dev))
        return out

    def from_sharded(self, xs) -> np.ndarray:
        """Per-shard vectors -> the global host vector, (n,) or (B, n)
        (the reference's solution gather, cuda/acg-cuda.c:2388-2425)."""
        locs = [x.cpu().numpy() for x in xs]
        out = np.zeros(locs[0].shape[:-1] + (self.nrows,),
                       dtype=locs[0].dtype)
        for p, xl in zip(self.ps.parts, locs):
            out[..., p.owned_global] = xl[..., : p.nown]
        return out

    # -- the operator --

    def exchange(self, xs, wire: str = "f32") -> list:
        """Every shard's ghost values by the system's halo method, the
        messages sent in ``wire``'s encoding (the put+signal halo sends
        one-system vectors at full width only; the solvers refuse the
        rest before they start)."""
        if self.method == HaloMethod.RDMA:
            return halo_rdma(xs, self.tables, self.rdma)
        if self.method == HaloMethod.ALLGATHER:
            return halo_allgather(xs, self.tables, wire)
        return halo_ppermute(xs, self.tables, wire)

    def iface_product(self, i: int, ghosts: torch.Tensor):
        """(border rows, A_iface ghosts) of shard ``i``: one ``ell_spmv``
        launch, once per system for ([B,] nghost) ghosts of a batch, the
        products ([B,] nrows_iface); None for a shard without ghosts."""
        if self.iface[i] is None:
            return None
        op, rows = self.iface[i]
        if ghosts.dim() == 2:
            return rows, torch.stack([ell_spmv(op, g) for g in ghosts])
        return rows, ell_spmv(op, ghosts)

    def add_iface(self, i: int, y: torch.Tensor, ghosts: torch.Tensor):
        """y += A_iface ghosts for shard ``i`` (in place, on its border
        rows of every system); returns :meth:`iface_product`."""
        iface = self.iface_product(i, ghosts)
        if iface is not None:
            # rows are distinct: one add each
            y.index_add_(y.dim() - 1, *iface)
        return iface

    def matvec(self, xs, wire: str = "f32") -> ShardVec:
        """y = A x, shard by shard, for one system or a (B, n) batch: the
        halo, the local SpMV, and the interface product added to the owned
        rows."""
        ghosts = self.exchange(xs, wire)
        out = ShardVec()
        for i, (op, x) in enumerate(zip(self.local_ops, xs)):
            y = op.matvec(x)
            self.add_iface(i, y, ghosts[i])
            out.append(y)
        return out


def _local_operators(ps, devs, fmt, vdt, mat_dtype, extra, timings=None):
    """(per-shard local operators, their storage dtype); ``extra`` as
    :meth:`ShardedSystem.build` takes it; ``timings`` gathers the seconds
    of the sgell and ELL shards' steps ``"upload"`` and ``"slice"``."""
    tdt = torch_dtype(vdt)
    if fmt == "stencil":
        return [DeviceStencil.from_spec(extra, dtype=vdt, device=d)
                for d in devs], None
    if fmt == "sgell":
        vstack = np.concatenate([pk["vals"].reshape(-1) for pk in extra])
        mdt = resolve_mat_dtype(vstack, mat_dtype, vdt)
        return [device_sgell_from_pack(pk, p.nown, p.nown, p.A_local.nnz,
                                       vdt, mdt, d, timings=timings)
                for pk, p, d in zip(extra, ps.parts, devs)], mdt
    if fmt == "dia":
        offs = np.asarray(extra, dtype=np.int64)
        D = max(len(offs), 1)
        stacks = []
        for p in ps.parts:
            dm = DiaMatrix.from_csr(p.A_local)
            st = np.zeros((D, dm.nrows_padded), dtype=vdt)
            if p.A_local.nnz:
                st[np.searchsorted(offs, dm.offsets)] = dm.bands
            stacks.append(st)
        # the storage tiers of DeviceDia.from_dia, decided over every
        # shard: lossless bf16, then the exact two-value int8 mask with
        # per-shard scales, then the vector dtype
        scales = None
        if mat_dtype == "auto":
            if vdt.itemsize > 2 and all(lossless_cast(s, torch.bfloat16)
                                        for s in stacks):
                mdt = torch.bfloat16
            else:
                scales = [two_value_scales(s) for s in stacks]
                if any(sc is None for sc in scales):
                    scales = None
                mdt = torch.int8 if scales is not None else tdt
        else:
            mdt = resolve_mat_dtype(np.concatenate(
                [s.reshape(-1) for s in stacks]), mat_dtype, vdt)
        ops = []
        for i, (p, st, d) in enumerate(zip(ps.parts, stacks, devs)):
            bands = torch.from_numpy(
                (st != 0).astype(np.int8) if scales is not None else st)
            ops.append(DeviceDia.from_bands(
                bands.to(mdt).to(d),
                None if scales is None else torch.from_numpy(scales[i]),
                tuple(int(o) for o in offs[:D]) if len(offs) else (0,),
                p.nown, p.nown, p.A_local.nnz, vdt.name))
        return ops, mdt
    # padded ELL: values narrow only when the local AND the interface
    # values all narrow losslessly
    Es = [EllMatrix.from_csr(p.A_local) for p in ps.parts]
    mdt = resolve_mat_dtype(np.concatenate(
        [E.vals.reshape(-1) for E in Es]
        + [p.A_iface.vals for p in ps.parts]), mat_dtype, vdt)
    return [DeviceEll.from_ell(E, dtype=vdt,
                               mat_dtype=None if mdt == tdt else mdt,
                               device=d, timings=timings)
            for E, d in zip(Es, devs)], mdt


def border_rows(A_iface):
    """(rows, B): the local rows of ``A_iface`` holding an entry, and
    ``A_iface`` cut to those rows (same entries, in order)."""
    from acg_torch.sparse.csr import CsrMatrix

    lens = A_iface.rowlens
    rows = np.flatnonzero(lens)
    rowptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens[rows], out=rowptr[1:])
    return rows, CsrMatrix(len(rows), A_iface.ncols, rowptr,
                           A_iface.colidx, A_iface.vals)


def _iface_operators(ps, devs, vdt, mat_dtype, mdt=None,
                     timings=None) -> list:
    """Per shard (op, rows): the interface operator over its ghost slots,
    cut to its border rows (``rows``, int64), as the sliced layout of its
    padded ELL (``op``), or None for a shard without ghosts.  Values
    narrow by their own lossless test (``mdt`` forces the local tier's
    choice); slicing checks every column below the shard's ghost count,
    once (ERR_INDEX_OUT_OF_BOUNDS); ``timings`` gathers the seconds of
    step ``"slice"``."""
    if mdt is None:
        allv = np.concatenate([p.A_iface.vals for p in ps.parts]) \
            if ps.parts else np.empty(0)
        mdt = resolve_mat_dtype(allv, mat_dtype, vdt)
    out = []
    for p, d in zip(ps.parts, devs):
        if p.nghost == 0:
            out.append(None)
            continue
        rows, B = border_rows(p.A_iface)
        E = EllMatrix.from_csr(B, row_align=1)
        vals = torch.from_numpy(np.ascontiguousarray(
            E.vals.astype(vdt))).to(mdt).to(d)
        cols = torch.from_numpy(np.ascontiguousarray(
            E.colidx, dtype=np.int32)).to(d)
        with host_step(timings, "slice"):
            op = slice_ell(vals, cols, p.nghost)
        out.append((op, torch.from_numpy(rows).to(d)))
    return out
