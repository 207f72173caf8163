"""Deep ghost zones: one exchange a block for the s-step basis and the
deep-pipelined fill chain (the matrix-powers data layer of
Demmel/Hoemmen/Carson).

The port of ``acg_tpu/parallel/deep.py``.  The distributed SpMV exchanges
the distance-1 ghosts at every application, so 2s applications of an
s-step block would pay 2s exchanges.  Instead each shard receives, once,
every value within graph distance ``depth`` of its owned rows, and runs
the applications redundantly in that skin: after j applications the
values are right on the owned rows and on the ghosts within distance
``depth - j``.  A shard therefore needs the rows of every ghost within
distance ``depth - 1`` (the ghost interior):

- owned rows go through the shard's own local tier (stencil, DIA, sgell
  or ELL) plus the deep interface: the shard's ``A_iface`` entries with
  their columns moved from the distance-1 ghost slots to the deep ghost
  slots, a rectangular ELL over the shard's border rows;
- ghost-interior rows go through the skin: their rows of the operator
  over the extended vector [owned | deep ghosts], a rectangular ELL over
  those rows;
- the exchange is the ordinary halo of ``parallel/halo.py`` on the deep
  pattern: :func:`build_deep` writes it as the (ghosts, owners, send
  lists) of a partition and hands it to ``build_halo_tables``, so
  ``halo_ppermute`` and ``halo_allgather`` move it unchanged (the
  edge-coloured rounds now count the partners at distance ``depth``:
  the diagonal block of a 2 x 2 grid partition joins at depth 2).

:func:`build_deep` is host NumPy and takes each ghost's row from the part
that owns it, so no global matrix is assembled.  :func:`build_deep_device`
uploads a :class:`DeepDevice` for one system and depth, cached on the
system; its :meth:`DeepDevice.ext_shifted` is the extended SpMV of one
shard, both products through the ``ell_spmv`` kernel on CUDA shards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_torch.config import HaloMethod
from acg_torch.ops.dia import resolve_mat_dtype
from acg_torch.ops.sliced import slice_ell
from acg_torch.ops.spmv import ell_spmv
from acg_torch.parallel.halo import (HaloTables, ShardTables,
                                     build_halo_tables, halo_allgather,
                                     halo_ppermute, on_device, shard_tables)
from acg_torch.partition.graph import LocalPartition, PartitionedSystem
from acg_torch.sparse.csr import CsrMatrix, coo_to_csr
from acg_torch.sparse.ell import EllMatrix
from acg_torch.utils.timing import host_step


def _pad8(n: int) -> int:
    return max(-(-n // 8) * 8, 8)


def _csr_rows(M: CsrMatrix, rows: np.ndarray):
    """(position in ``rows``, column, value) of every entry of the given
    rows of ``M``, row by row."""
    start = M.rowptr[rows].astype(np.int64)
    lens = M.rowptr[rows + 1].astype(np.int64) - start
    tot = int(lens.sum())
    flat = np.repeat(start - np.r_[0, np.cumsum(lens)[:-1]],
                     lens) + np.arange(tot)
    # gather first, then widen: the rows are a surface of the part
    return (np.repeat(np.arange(len(rows)), lens),
            M.colidx[flat].astype(np.int64), M.vals[flat])


class _PartRows:
    """Rows of the global operator in global ids, each read from the part
    that owns it (A_local with owned columns, A_iface with ghost
    columns): every row lies whole in its owner, so the deep layer reads
    the few rows it needs without assembling a global matrix."""

    def __init__(self, ps: PartitionedSystem):
        self.ps = ps
        self.owner = np.asarray(ps.part, dtype=np.int64)
        self.pos = np.empty(ps.nrows, dtype=np.int64)
        for q in ps.parts:
            self.pos[q.owned_global] = np.arange(q.nown)

    def rows(self, gids: np.ndarray):
        """(position in ``gids``, global column, value) of every entry of
        the rows ``gids``."""
        idx, cols, vals = [], [], []
        own = self.owner[gids]
        for q in self.ps.parts:
            at = np.flatnonzero(own == q.part)
            if not at.size:
                continue
            loc = self.pos[gids[at]]
            for M, glob in ((q.A_local, q.owned_global),
                            (q.A_iface, q.ghost_global)):
                if not M.nnz:
                    continue
                r, c, v = _csr_rows(M, loc)
                idx.append(at[r])
                cols.append(glob[c])
                vals.append(v)
        if not idx:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty(0))
        return (np.concatenate(idx), np.concatenate(cols),
                np.concatenate(vals))


def _bfs_levels(rows: _PartRows, p: LocalPartition, depth: int):
    """The ghosts of part ``p`` within graph distance ``depth`` of its
    owned rows, by level: (ghosts, levels), the level sets concatenated,
    each sorted by global id.  Level 1 is the part's own ghosts (the
    columns of its owned rows it does not own); each further level the
    unseen neighbours of the last."""
    seen = np.zeros(rows.ps.nrows, dtype=bool)
    seen[p.owned_global] = True
    frontier = np.sort(p.ghost_global.astype(np.int64))
    ghosts, levels = [], []
    for lvl in range(1, depth + 1):
        if frontier.size == 0:
            break
        seen[frontier] = True
        ghosts.append(frontier)
        levels.append(np.full(len(frontier), lvl, dtype=np.int32))
        if lvl < depth:
            nb = np.unique(rows.rows(frontier)[1])
            frontier = nb[~seen[nb]]
    if ghosts:
        return np.concatenate(ghosts), np.concatenate(levels)
    return np.empty(0, np.int64), np.empty(0, np.int32)


@dataclasses.dataclass(frozen=True)
class DeepHost:
    """The host-built deep layer of one (partition, depth).  Per part:
    ``ghosts`` in (owner, global id) order, the order the exchange
    delivers them in, and their distance ``levels``; ``iface`` (owned
    rows x deep ghost slots: A_iface with its columns remapped); ``skin``
    (deep ghost slots x [owned | deep ghosts], the rows of the ghost
    interior, other rows empty; owned slot i is column i, ghost slot j
    column ``nown_pad[part] + j``).  ``tables`` is the exchange on the
    deep pattern padded to ``gdeep`` ghost slots, ``pattern`` that
    pattern as a partition (what ``shard_tables`` uploads)."""

    depth: int
    gdeep: int
    tables: HaloTables
    pattern: PartitionedSystem
    ghosts: tuple
    levels: tuple
    iface: tuple
    skin: tuple
    nown_pad: tuple
    max_ghost: int


def build_deep(ps: PartitionedSystem, depth: int, nown_pad: tuple,
               timings: dict | None = None) -> DeepHost:
    """The deep layer of ``ps`` at ``depth`` (``acg_tpu.parallel.deep``
    ``build_deep``): each part's ghosts by level, the exchange tables
    (``build_halo_tables`` on the deep pattern), the remapped interface
    and the skin.  ``nown_pad`` is, part by part, the length the owned
    part of the shard's extended vector takes (its padded length).
    ``timings`` gathers the host seconds of ``deep_bfs``,
    ``deep_tables`` and ``deep_operators``."""
    pads = tuple(int(v) for v in nown_pad)
    with host_step(timings, "deep_bfs"):
        rows = _PartRows(ps)
        part = rows.owner
        deep_ghosts, deep_levels = [], []
        for p in ps.parts:
            g, lv = _bfs_levels(rows, p, depth)
            order = np.lexsort((g, part[g]))    # (owner, gid): halo order
            deep_ghosts.append(g[order])
            deep_levels.append(lv[order])
    with host_step(timings, "deep_tables"):
        pattern, tables = _deep_pattern(ps, rows, deep_ghosts)
    with host_step(timings, "deep_operators"):
        ifaces, skins = _deep_operators(ps, rows, depth, pads, deep_ghosts,
                                        deep_levels)
    return DeepHost(depth=depth, gdeep=tables.nghost_max, tables=tables,
                    pattern=pattern, ghosts=tuple(deep_ghosts),
                    levels=tuple(deep_levels), iface=ifaces, skin=skins,
                    nown_pad=pads,
                    max_ghost=max((len(g) for g in deep_ghosts), default=0))


def _deep_pattern(ps: PartitionedSystem, rows: _PartRows, deep_ghosts):
    """(pattern, tables): the deep exchange as partition parts and its
    halo tables, padded to ``_pad8`` of the most deep ghosts."""
    P = ps.nparts
    part = rows.owner
    gdeep = _pad8(max([len(g) for g in deep_ghosts] + [1]))

    # the exchange pattern as partition parts (the shape build_halo_tables
    # takes); distance is symmetric, so the neighbour sets agree
    send_map: list = [dict() for _ in range(P)]
    nbr_sets: list = [set() for _ in range(P)]
    for p in ps.parts:
        dg = deep_ghosts[p.part]
        owner = part[dg]
        for q in np.unique(owner):
            send_map[int(q)][p.part] = rows.pos[dg[owner == q]]
            nbr_sets[int(q)].add(p.part)
            nbr_sets[p.part].add(int(q))
    fake = []
    for p in ps.parts:
        i = p.part
        dg = deep_ghosts[i]
        owner = part[dg].astype(np.int32)
        nbrs = np.array(sorted(nbr_sets[i]), dtype=np.int32)
        chunks = [send_map[i].get(int(q), np.empty(0, np.int64))
                  for q in nbrs]
        fake.append(LocalPartition(
            part=i, owned_global=p.owned_global, ninterior=p.ninterior,
            ghost_global=dg, ghost_owner=owner, A_local=p.A_local,
            A_iface=p.A_iface, neighbors=nbrs,
            send_counts=np.array([len(c) for c in chunks], dtype=np.int64),
            send_idx=(np.concatenate(chunks) if chunks
                      else np.empty(0, np.int64)),
            recv_counts=np.array([int(np.count_nonzero(owner == q))
                                  for q in nbrs], dtype=np.int64)))
    pattern = PartitionedSystem(nrows=ps.nrows, nparts=P, part=ps.part,
                                parts=fake)
    return pattern, build_halo_tables(pattern, nghost_max=gdeep)


def _deep_operators(ps: PartitionedSystem, rows: _PartRows, depth: int,
                    pads, deep_ghosts, deep_levels):
    """(interfaces, skins): per part the CSR of its deep interface and of
    its skin (see :class:`DeepHost`)."""
    part = rows.owner
    n1 = np.int64(ps.nrows + 1)
    ifaces, skins = [], []
    for p in ps.parts:
        i = p.part
        dg, lv = deep_ghosts[i], deep_levels[i]
        # the interface: A_iface's entries, columns moved from the
        # distance-1 ghost slots to the deep ones
        dgkey = part[dg] * n1 + dg
        okey = part[p.ghost_global] * n1 + p.ghost_global
        colmap = np.searchsorted(dgkey, okey)
        if len(okey) and (colmap.max() >= len(dgkey)
                          or not np.array_equal(dgkey[colmap], okey)):
            raise AssertionError("the distance-1 ghosts must be deep ghosts")
        ifaces.append(CsrMatrix(p.nown, len(dg), p.A_iface.rowptr,
                                colmap[p.A_iface.colidx].astype(np.int32)
                                if p.A_iface.nnz else p.A_iface.colidx,
                                p.A_iface.vals))
        # the skin: the ghost interior's rows over [owned | deep ghosts]
        ext = np.full(ps.nrows, -1, dtype=np.int64)
        ext[p.owned_global] = np.arange(p.nown)
        ext[dg] = pads[i] + np.arange(len(dg))
        interior = np.flatnonzero(lv <= depth - 1)
        r, c, v = rows.rows(dg[interior])
        ec = ext[c]
        if np.any(ec < 0):
            raise AssertionError("a ghost-interior row reaches outside the "
                                 "deep skin")
        skins.append(coo_to_csr(interior[r], ec, v, len(dg),
                                pads[i] + len(dg)))
    return tuple(ifaces), tuple(skins)


def _ell_rows(M: CsrMatrix, vdt, mdt, dev):
    """(op, rows): ``M`` cut to its rows with an entry, as the sliced
    layout of their padded ELL on ``dev``, and those rows (int64); None
    without an entry."""
    from acg_torch.parallel.sharded import border_rows

    if not M.nnz:
        return None
    rows, B = border_rows(M)
    E = EllMatrix.from_csr(B, row_align=1)
    vals = torch.from_numpy(np.ascontiguousarray(
        E.vals.astype(vdt))).to(mdt).to(dev)
    cols = torch.from_numpy(np.ascontiguousarray(
        E.colidx, dtype=np.int32)).to(dev)
    return slice_ell(vals, cols, M.ncols), torch.from_numpy(rows).to(dev)


def _product(opr, v: torch.Tensor):
    """(rows, A v) of an (op, rows) pair for one system or, row by row,
    a (B, m) batch: one ``ell_spmv`` a system."""
    op, rows = opr
    if v.dim() == 2:
        return rows, torch.stack([ell_spmv(op, u) for u in v])
    return rows, ell_spmv(op, v)


@dataclasses.dataclass
class DeepDevice:
    """The deep layer of one system and depth on the shards' devices:
    the exchange tables of each shard (``tables``; ``nrounds`` rounds),
    its deep interface and skin as (sliced ELL, rows) pairs (None where
    a shard has no entry), its owned length (the local operator's padded
    length) and deep ghost count; ``host`` keeps the host layer."""

    depth: int
    host: DeepHost
    tables: ShardTables
    nrounds: int
    iface: tuple
    skin: tuple
    nown: tuple
    nghost: tuple

    def exchange(self, ss, xs, wire: str = "f32") -> list:
        """The deep ghosts of every shard, ([L,] nghost) from owned
        vectors ([L,] nown), through the system's halo (ppermute or
        allgather) in ``wire``'s encoding.  A (2, B, n) stack goes as
        (2B, n) and comes back (2, B, nghost), as the JAX package
        flattens it for its allgather tier."""
        lead = xs[0].shape[:-1]
        flat = [x.reshape(-1, x.shape[-1]) if x.dim() > 2 else x
                for x in xs]
        if ss.method == HaloMethod.ALLGATHER:
            out = halo_allgather(flat, self.tables, wire)
        elif ss.method == HaloMethod.PPERMUTE:
            out = halo_ppermute(flat, self.tables, wire)
        else:
            raise ValueError(f"deep exchange through {ss.method}")
        return [g.reshape(lead + g.shape[-1:]) for g in out]

    def ext_shifted(self, ss, i: int, ve: torch.Tensor, out: torch.Tensor,
                    shift=None, minuend=None) -> torch.Tensor:
        """One extended SpMV of shard ``i``: A_ext ve - shift ve into
        ``out`` (both ([B,] nown + nghost), ``shift`` a 0-d or (B, 1)
        scalar), or with ``minuend`` m (same shape) m - A_ext ve.  Owned
        rows: the local tier (the SpMV kernel without the dot) plus the
        deep interface on the border rows; ghost rows: the skin on the
        ghost interior, 0 beyond it."""
        n = self.nown[i]
        vo, vg = ve[..., :n], ve[..., n:]
        yo = ss.local_ops[i].matvec(vo if vo.is_contiguous()
                                    else vo.contiguous())
        if self.iface[i] is not None:
            yo.index_add_(yo.dim() - 1, *_product(self.iface[i], vg))
        yg = torch.zeros_like(vg)
        if self.skin[i] is not None:
            yg.index_copy_(yg.dim() - 1, *_product(self.skin[i], ve))
        if minuend is not None:
            torch.sub(minuend[..., :n], yo, out=out[..., :n])
            torch.sub(minuend[..., n:], yg, out=out[..., n:])
        else:
            sh = on_device(shift, ve.device)
            torch.addcmul(yo, sh, vo, value=-1, out=out[..., :n])
            torch.addcmul(yg, sh, vg, value=-1, out=out[..., n:])
        return out


def build_deep_device(ss, depth: int, timings: dict | None = None):
    """The :class:`DeepDevice` of the sharded system ``ss`` at ``depth``,
    built once and cached on ``ss`` (``acg_tpu.parallel.deep``
    ``build_deep_device``).  Interface and skin values are stored in
    bf16 where that is exact, else at the vector dtype.  ``timings``
    gathers the host seconds of :func:`build_deep`'s steps and of
    ``deep_upload`` (the tables and the sliced operators onto the
    devices)."""
    cache = ss.deep_cache
    if depth in cache:
        return cache[depth]
    nown = tuple(op.nrows_padded for op in ss.local_ops)
    host = build_deep(ss.ps, depth, nown, timings)
    with host_step(timings, "deep_upload"):
        tables = shard_tables(host.tables, host.pattern, ss.devices)
        vdt = np.dtype(ss.vec_dtype)
        vals = [M.vals for M in host.iface + host.skin]
        mdt = resolve_mat_dtype(np.concatenate(vals) if vals
                                else np.empty(0), "auto", vdt)
        iface = tuple(_ell_rows(M, vdt, mdt, d)
                      for M, d in zip(host.iface, ss.devices))
        skin = tuple(_ell_rows(M, vdt, mdt, d)
                     for M, d in zip(host.skin, ss.devices))
        if any(d.type == "cuda" for d in ss.devices):
            torch.cuda.synchronize()
    dev = DeepDevice(depth=depth, host=host, tables=tables,
                     nrounds=host.tables.nrounds, iface=iface, skin=skin,
                     nown=nown, nghost=tuple(len(g) for g in host.ghosts))
    cache[depth] = dev
    return dev

