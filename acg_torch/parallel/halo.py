"""Halo exchange: the static schedule, and its ppermute and allgather
transports between shard tensors.

The port of ``acg_tpu/parallel/halo.py``.  The pattern is frozen at set-up
(the reference's ``acghaloexchange_init``): :func:`build_halo_tables`
edge-colours the neighbour graph into rounds, each a matching, and pads
each part's per-round send and receive index lists into (P, R, S)
tables; the allgather tables give each part's packed border values and,
per ghost, its owner and position in the owner's pack.  The arrays equal
the JAX package's.

The JAX package moves the values with XLA collectives (``ppermute``,
``all_gather``); here the shards are tensors, each on its own device, and
the same movement is torch indexing and copies: :func:`halo_ppermute`
copies, round by round, each part's gathered send list into its partner's
ghost slots; :func:`halo_allgather` replicates every part's pack on each
device and gathers the ghosts from it.  Neither is a TPU kernel, so
neither has one here; the device-initiated transport is
``acg_torch/parallel/rdma_halo.py``.  Only the full-width wire is
ported (``wire="f32"``: values go out at the vector dtype).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.partition.graph import PartitionedSystem


def edge_color(ps: PartitionedSystem) -> tuple:
    """Greedy edge colouring of the neighbour graph: (nrounds,
    partner[P, max(nrounds, 1)]) with partner[p, r] the part p exchanges
    with in round r, or -1.  Each round is a matching."""
    P = ps.nparts
    edges = sorted({(p.part, int(q)) for p in ps.parts
                    for q in p.neighbors if p.part < int(q)})
    colors: dict = {}
    used: list = [set() for _ in range(P)]
    for e in edges:
        c = 0
        while c in used[e[0]] or c in used[e[1]]:
            c += 1
        colors[e] = c
        used[e[0]].add(c)
        used[e[1]].add(c)
    nrounds = max(colors.values()) + 1 if colors else 0
    partner = np.full((P, max(nrounds, 1)), -1, dtype=np.int32)
    for (a, b), c in colors.items():
        partner[a, c] = b
        partner[b, c] = a
    return nrounds, partner


@dataclasses.dataclass(frozen=True)
class HaloTables:
    """Padded halo schedule (host-built, static per matrix).  P parts, R
    rounds, S = most values in one message, B = largest pack, G = ghost
    slots.  Padding: -1 in the send and pack tables, G in ``recv_idx``,
    0 in the allgather ghost tables."""

    nrounds: int
    perms: tuple                  # per round: the (src, dst) pairs
    partner: np.ndarray           # (P, R) partner per round, -1 none
    send_idx: np.ndarray          # (P, R, S) into the owned vector
    recv_idx: np.ndarray          # (P, R, S) into the ghost vector
    pack_idx: np.ndarray          # (P, B) into the owned vector
    ghost_src_part: np.ndarray    # (P, G) owner part of each ghost
    ghost_src_pos: np.ndarray     # (P, G) its position in the owner's pack
    nghost_max: int
    total_send_values: int        # values sent per exchange, all parts

    @property
    def max_msg(self) -> int:
        return self.send_idx.shape[2]


def build_halo_tables(ps: PartitionedSystem,
                      nghost_max: int | None = None) -> HaloTables:
    P = ps.nparts
    nrounds, partner = edge_color(ps)
    R = max(nrounds, 1)
    S = 1
    for p in ps.parts:
        if len(p.send_counts):
            S = max(S, int(p.send_counts.max()))
    G = nghost_max if nghost_max is not None else max(
        max((p.nghost for p in ps.parts), default=1), 1)
    send_idx = np.full((P, R, S), -1, dtype=np.int32)
    recv_idx = np.full((P, R, S), G, dtype=np.int32)
    for p in ps.parts:
        sd, rd = p.send_displs, p.recv_displs
        for qi, q in enumerate(p.neighbors):
            r = int(np.nonzero(partner[p.part] == int(q))[0][0])
            cnt = int(p.send_counts[qi])
            send_idx[p.part, r, :cnt] = p.send_idx[sd[qi]: sd[qi + 1]]
            rcnt = int(p.recv_counts[qi])
            recv_idx[p.part, r, :rcnt] = np.arange(rd[qi], rd[qi + 1])

    # allgather pack: each part's border rows, deduplicated, by local id
    B = 1
    packs = []
    for p in ps.parts:
        uniq = np.unique(p.send_idx) if len(p.send_idx) else np.empty(
            0, dtype=np.int64)
        packs.append(uniq)
        B = max(B, len(uniq))
    pack_idx = np.full((P, B), -1, dtype=np.int32)
    for p, u in zip(ps.parts, packs):
        pack_idx[p.part, : len(u)] = u

    # each ghost's position in its owner's pack, through one global
    # id -> pack position map
    ghost_src_part = np.zeros((P, G), dtype=np.int32)
    ghost_src_pos = np.zeros((P, G), dtype=np.int32)
    pack_pos = np.zeros(ps.nrows, dtype=np.int32)
    for q, u in zip(ps.parts, packs):
        if len(u):
            pack_pos[q.owned_global[u]] = np.arange(len(u), dtype=np.int32)
    for p in ps.parts:
        if p.nghost == 0:
            continue
        ghost_src_part[p.part, : p.nghost] = p.ghost_owner
        ghost_src_pos[p.part, : p.nghost] = pack_pos[p.ghost_global]

    perms = tuple(tuple((a, int(partner[a, r])) for a in range(P)
                        if partner[a, r] >= 0) for r in range(R))
    total = sum(int(p.send_counts.sum()) for p in ps.parts)
    return HaloTables(nrounds=nrounds, perms=perms, partner=partner[:, :R],
                      send_idx=send_idx, recv_idx=recv_idx,
                      pack_idx=pack_idx, ghost_src_part=ghost_src_part,
                      ghost_src_pos=ghost_src_pos, nghost_max=G,
                      total_send_values=total)


def check_wire(wire: str) -> None:
    """Only the full-width wire is ported; the compressed ones raise."""
    if wire != "f32":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"halo wire {wire!r}: not yet ported (f32 is)")


@dataclasses.dataclass(frozen=True)
class ShardTables:
    """The tables of :class:`HaloTables` cut to each shard's real
    entries, as int64 tensors on the shard's device: ``send_rows[p][r]``
    and ``recv_rows[p][r]`` (None where part p has no partner in round
    r), ``pack_rows[p]``, ``ghost_part[p]``/``ghost_pos[p]`` (length
    ``nghost[p]``), and ``pack_width`` = B.  For the put+signal transport
    (``rdma_halo.py``): ``send_full[p]``, the whole (R, S) send table
    flattened with its pads at row 0, and ``ghost_src[p]``, the flat
    (slot, position) each ghost arrives at, ``max_msg`` = S."""

    partner: np.ndarray
    send_rows: tuple
    recv_rows: tuple
    pack_rows: tuple
    ghost_part: tuple
    ghost_pos: tuple
    nghost: tuple
    pack_width: int
    send_full: tuple
    ghost_src: tuple
    max_msg: int


def shard_tables(tables: HaloTables, ps: PartitionedSystem,
                 devices) -> ShardTables:
    """Upload each shard's slice of ``tables`` to its device."""
    G = tables.nghost_max

    def up(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)
                                ).to(dev)

    S = tables.max_msg
    send_rows, recv_rows, pack_rows, gpart, gpos = [], [], [], [], []
    send_full, ghost_src = [], []
    for p, dev in zip(ps.parts, devices):
        i = p.part
        send_full.append(up(np.maximum(tables.send_idx[i], 0).reshape(-1),
                            dev))
        # each ghost slot arrives in exactly one (round, position)
        src = np.full(p.nghost, -1, dtype=np.int64)
        rr, jj = np.nonzero(tables.recv_idx[i] < G)
        src[tables.recv_idx[i][rr, jj]] = rr * S + jj
        if np.any(src < 0):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"halo tables: part {i} has ghosts no round "
                           "delivers")
        ghost_src.append(up(src, dev))
        srow, rrow = [], []
        for r in range(tables.partner.shape[1]):
            if tables.partner[i, r] < 0:
                srow.append(None)
                rrow.append(None)
                continue
            s = tables.send_idx[i, r]
            t = tables.recv_idx[i, r]
            srow.append(up(s[s >= 0], dev))
            rrow.append(up(t[t < G], dev))
        send_rows.append(tuple(srow))
        recv_rows.append(tuple(rrow))
        pk = tables.pack_idx[i]
        pack_rows.append(up(pk[pk >= 0], dev))
        gpart.append(up(tables.ghost_src_part[i, : p.nghost], dev))
        gpos.append(up(tables.ghost_src_pos[i, : p.nghost], dev))
    return ShardTables(partner=tables.partner, send_rows=tuple(send_rows),
                       recv_rows=tuple(recv_rows),
                       pack_rows=tuple(pack_rows), ghost_part=tuple(gpart),
                       ghost_pos=tuple(gpos),
                       nghost=tuple(p.nghost for p in ps.parts),
                       pack_width=tables.pack_idx.shape[1],
                       send_full=tuple(send_full),
                       ghost_src=tuple(ghost_src), max_msg=S)


def on_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, copied only when it lies elsewhere."""
    return t if t.device == dev else t.to(dev)


def halo_ppermute(xs, st: ShardTables, wire: str = "f32") -> list:
    """Ghost vectors of every shard through the edge-coloured rounds: in
    round r, part q's ghost slots ``recv_rows[q][r]`` get the values its
    partner a = partner[q, r] gathers by ``send_rows[a][r]`` (the colouring
    is symmetric, so a's slot r pairs with q's).  ``xs[p]`` is shard p's
    owned vector; ghosts come back in slot order, one tensor a shard."""
    check_wire(wire)
    ghosts = [torch.zeros(g, dtype=x.dtype, device=x.device)
              for x, g in zip(xs, st.nghost)]
    for r in range(st.partner.shape[1]):
        for q, gq in enumerate(ghosts):
            a = int(st.partner[q, r])
            if a < 0:
                continue
            gq[st.recv_rows[q][r]] = on_device(xs[a][st.send_rows[a][r]],
                                         gq.device)
    return ghosts


def halo_allgather(xs, st: ShardTables, wire: str = "f32") -> list:
    """Ghost vectors of every shard through one gather of all packs: each
    part packs its border values, every device holds the (P, B) stack of
    packs, and each ghost is read at (owner, position)."""
    check_wire(wire)
    packs = [x[rows] for x, rows in zip(xs, st.pack_rows)]
    stacks = {}
    for x in xs:
        if x.device not in stacks:
            full = torch.zeros((len(xs), st.pack_width), dtype=x.dtype,
                               device=x.device)
            for p, pk in enumerate(packs):
                full[p, : pk.shape[0]] = on_device(pk, x.device)
            stacks[x.device] = full
    return [stacks[x.device][gp, gq]
            for x, gp, gq in zip(xs, st.ghost_part, st.ghost_pos)]
