"""Partitioned system: the per-part local views of a row partition.

The port's copy of ``acg_tpu/partition/graph.py`` (the reference's data
layer, acg/graph.h:199-328 and acg/symcsrmatrix.h:249-292):

- each part owns some rows; under ``local_order="band"`` they are
  numbered in ascending global id, under ``"interior"`` interior rows
  (no cross-part edge) first, then border rows;
- ``A_local`` (owned rows × owned columns) and ``A_iface`` (owned rows ×
  ghost slots) split the part's rows, so an SpMV is ``A_local x_own``
  (independent of the halo) plus ``A_iface ghosts``;
- ghosts (off-part columns of owned rows) are sorted by (owner part,
  global id), and each part's send list to a neighbour by global id, so
  send order and the receiver's ghost order agree by construction.

Host NumPy only; ``acg_torch/parallel/`` makes the device form.  The
host oracles :meth:`PartitionedSystem.exchange_halo` and
:meth:`PartitionedSystem.matvec` check the device exchange and operator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from acg_torch.errors import AcgError, Status
from acg_torch.sparse.csr import CsrMatrix, coo_to_csr


@dataclasses.dataclass
class LocalPartition:
    """One part's local view (ref acg/graph.h:199-328 with
    acg/symcsrmatrix.h:62-292)."""

    part: int
    owned_global: np.ndarray    # local -> global id of the owned rows
    ninterior: int
    ghost_global: np.ndarray    # sorted by (owner part, global id)
    ghost_owner: np.ndarray
    A_local: CsrMatrix          # nown x nown
    A_iface: CsrMatrix          # nown x nghost (columns are ghost slots)
    neighbors: np.ndarray       # neighbour part ids, sorted
    send_counts: np.ndarray     # per neighbour
    send_idx: np.ndarray        # owned local indices, by neighbour
    recv_counts: np.ndarray     # per neighbour (ghost ranges contiguous)

    @property
    def nown(self) -> int:
        return len(self.owned_global)

    @property
    def nborder(self) -> int:
        return self.nown - self.ninterior

    @property
    def nghost(self) -> int:
        return len(self.ghost_global)

    @property
    def nlocal(self) -> int:
        """Owned + ghost: the length of the local vector."""
        return self.nown + self.nghost

    @property
    def send_displs(self) -> np.ndarray:
        d = np.zeros(len(self.neighbors) + 1, dtype=np.int64)
        np.cumsum(self.send_counts, out=d[1:])
        return d

    @property
    def recv_displs(self) -> np.ndarray:
        d = np.zeros(len(self.neighbors) + 1, dtype=np.int64)
        np.cumsum(self.recv_counts, out=d[1:])
        return d


@dataclasses.dataclass
class PartitionedSystem:
    """All parts of a row partition of a symmetric operator."""

    nrows: int
    nparts: int
    part: np.ndarray                  # global part vector
    parts: list
    # the local orderings came from a per-part RCM relabel (rcm_localize)
    rcm_localized: bool = False

    def scatter_vector(self, x: np.ndarray) -> list:
        """Global vector -> per-part owned vectors (ref acgvector
        scatter, acg/vector.c:1045+)."""
        return [np.asarray(x)[p.owned_global] for p in self.parts]

    def gather_vector(self, locs: list) -> np.ndarray:
        """Per-part owned vectors -> global vector."""
        out = np.zeros(self.nrows, dtype=np.asarray(locs[0]).dtype)
        for p, xl in zip(self.parts, locs):
            out[p.owned_global] = np.asarray(xl)[: p.nown]
        return out

    def exchange_halo(self, locs: list) -> list:
        """Host halo exchange: per-part vectors of length nlocal with the
        ghost slots filled (ref acghalo_exchange, acg/halo.c:687-769)."""
        out = []
        for p, xl in zip(self.parts, locs):
            full = np.zeros(p.nlocal, dtype=np.asarray(xl).dtype)
            full[: p.nown] = np.asarray(xl)[: p.nown]
            out.append(full)
        for p, full in zip(self.parts, out):
            rd = p.recv_displs
            for qi, q in enumerate(p.neighbors):
                lq = self.parts[int(q)]
                sd = lq.send_displs
                pi = int(np.searchsorted(lq.neighbors, p.part))
                sidx = lq.send_idx[sd[pi]: sd[pi + 1]]
                full[p.nown + rd[qi]: p.nown + rd[qi + 1]] = out[int(q)][sidx]
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host SpMV through the local/interface split and the host halo
        (ref acgsymcsrmatrix_dsymvmpi, acg/symcsrmatrix.c:1353)."""
        full = self.exchange_halo(self.scatter_vector(x))
        ys = []
        for p, xf in zip(self.parts, full):
            y = p.A_local.matvec(xf[: p.nown])
            if p.nghost:
                y = y + p.A_iface.matvec(xf[p.nown:])
            ys.append(y)
        return self.gather_vector(ys)


# row windows of the streamed assembly hold about this many entries
_ASSEMBLY_WINDOW_NNZ = 2_000_000


def _cat(pieces: list, dtype) -> np.ndarray:
    if not pieces:
        return np.empty(0, dtype=dtype)
    out = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
    pieces.clear()
    return out


def _assemble_part(A: CsrMatrix, part: np.ndarray, p: int,
                   owned_global: np.ndarray, owned_local: np.ndarray,
                   ninterior: int, local_order: str) -> LocalPartition:
    """One part's LocalPartition, streamed from bounded row windows of
    the global CSR."""
    n = A.nrows
    nown = len(owned_global)
    lens = (A.rowptr[owned_global + 1]
            - A.rowptr[owned_global]).astype(np.int64)
    cum = np.cumsum(lens)
    tot = int(cum[-1]) if nown else 0
    cuts = np.searchsorted(cum, np.arange(_ASSEMBLY_WINDOW_NNZ, tot,
                                          _ASSEMBLY_WINDOW_NNZ)) + 1
    bounds = np.r_[0, cuts, nown] if nown else np.array([0, 0])

    lcnt = np.zeros(nown, dtype=np.int64)
    lcol_p, lval_p, lrow_p = [], [], []
    gcol_p, grow_p, ival_p = [], [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a >= b:
            continue
        lens_w = lens[a:b]
        tot_w = int(lens_w.sum())
        flat = np.repeat(A.rowptr[owned_global[a:b]].astype(np.int64)
                         - np.r_[0, np.cumsum(lens_w)[:-1]],
                         lens_w) + np.arange(tot_w)
        ec = A.colidx[flat]
        er = np.repeat(np.arange(a, b, dtype=np.int64), lens_w)
        m = part[ec] == p
        mi = ~m
        ev = A.vals[flat]
        lcnt[a:b] += np.bincount(er[m] - a, minlength=b - a)
        lcol_p.append(owned_local[ec[m]])
        lval_p.append(ev[m])
        if local_order != "band":
            lrow_p.append(er[m])
        gcol_p.append(ec[mi].astype(np.int64))
        grow_p.append(er[mi])
        ival_p.append(ev[mi])
        del flat, ec, er, m, mi, ev

    lcol = _cat(lcol_p, np.int64)
    lval = _cat(lval_p, A.vals.dtype)
    ghost_cols = _cat(gcol_p, np.int64)
    grow = _cat(grow_p, np.int64)
    ival = _cat(ival_p, A.vals.dtype)

    gids_sorted = np.unique(ghost_cols)
    owner_sorted = part[gids_sorted]
    order = np.lexsort((gids_sorted, owner_sorted))
    ghost_global = gids_sorted[order]
    ghost_owner = owner_sorted[order]
    nghost = len(ghost_global)
    g2l_ghost = np.empty(max(nghost, 1), dtype=np.int64)
    g2l_ghost[order] = np.arange(nghost)

    rowptr = np.zeros(nown + 1, dtype=np.int64)
    np.cumsum(lcnt, out=rowptr[1:])
    if local_order == "band":
        # ascending global ids: rows and in-row columns arrive sorted
        A_local = CsrMatrix(nown, nown, rowptr, lcol.astype(A.colidx.dtype),
                            lval)
    else:
        lrow = _cat(lrow_p, np.int64)
        lorder = np.lexsort((lcol, lrow))
        A_local = CsrMatrix(nown, nown, rowptr,
                            lcol[lorder].astype(np.int32), lval[lorder])
    gcol = g2l_ghost[np.searchsorted(gids_sorted, ghost_cols)]
    iorder = np.lexsort((gcol, grow))
    irowptr = np.zeros(nown + 1, dtype=np.int64)
    np.cumsum(lens - lcnt, out=irowptr[1:])
    A_iface = CsrMatrix(nown, max(nghost, 1), irowptr,
                        gcol[iorder].astype(np.int32), ival[iorder])

    # neighbours are the ghost owners; the send list to each is the
    # unique owned rows with an edge into it, ascending global id
    neighbors, recv_counts = np.unique(ghost_owner, return_counts=True)
    gowner_e = part[ghost_cols].astype(np.int64)
    pair = np.unique(gowner_e * np.int64(n + 1) + owned_global[grow])
    pown = pair // (n + 1)
    send_idx = owned_local[pair % (n + 1)]
    send_counts = np.bincount(np.searchsorted(neighbors, pown),
                              minlength=len(neighbors)).astype(np.int64)
    return LocalPartition(
        part=p, owned_global=owned_global, ninterior=ninterior,
        ghost_global=ghost_global, ghost_owner=ghost_owner,
        A_local=A_local, A_iface=A_iface,
        neighbors=neighbors.astype(np.int32),
        send_counts=send_counts, send_idx=send_idx,
        recv_counts=recv_counts.astype(np.int64))


def partition_system(A: CsrMatrix, part: np.ndarray,
                     local_order: str = "interior") -> PartitionedSystem:
    """Split a symmetric CSR operator by a part vector (ref
    acgsymcsrmatrix_partition, acg/symcsrmatrix.c:685-758).
    ``local_order`` numbers each part's owned rows: ``"interior"``
    interior rows first, then border rows (the reference's order);
    ``"band"`` ascending global id, which keeps each local block of a
    banded operator banded with the global diagonal offsets (what the
    distributed solver's DIA and stencil tiers need).  Border detection
    and each part's split walk bounded row windows of the global matrix,
    so the transient memory does not grow with nnz."""
    part = np.asarray(part, dtype=np.int32)
    if part.shape[0] != A.nrows:
        raise AcgError(Status.ERR_INVALID_VALUE, "part vector length mismatch")
    if local_order not in ("band", "interior"):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"unknown local_order {local_order!r}")
    nparts = int(part.max()) + 1 if part.size else 1
    n = A.nrows

    border_mask = np.zeros(n, dtype=bool)
    rowlens = A.rowlens
    wb = np.r_[0, np.searchsorted(A.rowptr,
                                  np.arange(_ASSEMBLY_WINDOW_NNZ, A.nnz,
                                            _ASSEMBLY_WINDOW_NNZ)), n]
    for a, b in zip(wb[:-1], wb[1:]):
        if a >= b:
            continue
        rw = np.repeat(np.arange(a, b, dtype=np.int64), rowlens[a:b])
        cw = A.colidx[A.rowptr[a]: A.rowptr[b]]
        cross_w = part[rw] != part[cw]
        border_mask[rw[cross_w]] = True
        del rw, cw, cross_w

    # one owned-local numbering for the whole system: nodes grouped by
    # part (border after interior under "interior"), ascending global id
    # inside each group
    okey = (part.astype(np.int64) if local_order == "band"
            else part.astype(np.int64) * 2 + border_mask)
    norder = np.argsort(okey, kind="stable")
    del okey
    pstart = np.searchsorted(part[norder], np.arange(nparts + 1))
    owned_local = np.empty(n, dtype=np.int64)
    owned_local[norder] = np.arange(n) - np.repeat(
        pstart[:-1], np.diff(pstart))
    ninterior_of = np.bincount(part[~border_mask], minlength=nparts)
    del border_mask
    parts = [_assemble_part(A, part, p, norder[pstart[p]: pstart[p + 1]],
                            owned_local, int(ninterior_of[p]), local_order)
             for p in range(nparts)]
    return PartitionedSystem(nrows=n, nparts=nparts, part=part, parts=parts)


def relabel_part(lp: LocalPartition, perm: np.ndarray) -> LocalPartition:
    """Renumber one part's owned rows by ``perm`` (new_to_old local ids):
    A_local rows and columns, A_iface rows and the send_idx values
    follow; the ORDER of send_idx is kept, so send order still matches
    the receivers' ghost order."""
    from acg_torch.sparse.rcm import permute_symmetric

    nown = lp.nown
    old_to_new = np.empty(nown, dtype=np.int64)
    old_to_new[perm] = np.arange(nown)
    r, c, v = lp.A_iface.to_coo()
    A_iface = coo_to_csr(old_to_new[r], c, v, nown, lp.A_iface.ncols)
    return LocalPartition(
        part=lp.part, owned_global=lp.owned_global[perm],
        ninterior=lp.ninterior,
        ghost_global=lp.ghost_global, ghost_owner=lp.ghost_owner,
        A_local=permute_symmetric(lp.A_local, perm), A_iface=A_iface,
        neighbors=lp.neighbors, send_counts=lp.send_counts,
        send_idx=old_to_new[lp.send_idx], recv_counts=lp.recv_counts)


def rcm_localize(ps: PartitionedSystem) -> PartitionedSystem:
    """Per-part RCM renumbering of every local block: recovers a banded
    local operator from a scattered ordering, and the locality the sgell
    pack needs."""
    from acg_torch.sparse.rcm import rcm_order

    parts = [relabel_part(p, rcm_order(p.A_local)) for p in ps.parts]
    return PartitionedSystem(nrows=ps.nrows, nparts=ps.nparts,
                             part=ps.part, parts=parts, rcm_localized=True)


def comm_matrix(ps: PartitionedSystem) -> np.ndarray:
    """Part-to-part communication volume in values sent (ref
    --output-comm-matrix, cuda/acg-cuda.c:1712-1772)."""
    M = np.zeros((ps.nparts, ps.nparts), dtype=np.int64)
    for p in ps.parts:
        for q, c in zip(p.neighbors, p.send_counts):
            M[p.part, int(q)] = int(c)
    return M
