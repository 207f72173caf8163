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
``acg_torch/parallel/rdma_halo.py``.  A shard vector may be one
system, (n,), or a batch, (B, n): a batch moves (B, S) message blocks in
the same rounds, one gather and one copy per (round, shard pair) for all
B systems.  The wire (:func:`wire_encode` / :func:`wire_decode`, the JAX
package's codec) sends each message at the vector dtype ("f32"), as bf16
bit patterns or as int16 deltas with a per-message (offset, scale)
header; the values are decoded to the vector dtype before anything adds
them.
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


# exchanges so far, for the counted CommAudit (``acg_torch/obs/audit.py``):
# the ppermute transport's rounds (one a round with a partner, as the JAX
# package compiles one collective-permute a round) and allgathers, and the
# bytes their messages carry at the wire's itemsize.  The loops' graph
# runner replays them with the launch counters (``solvers/graphs.py``).
ppermute_rounds = 0
ppermute_bytes = 0
allgathers = 0
allgather_bytes = 0


#: Wire encodings of a halo message: "f32" sends the values at the vector
#: dtype; the compressed formats send two bytes a value and decode to the
#: vector dtype before any arithmetic (``acg_tpu/parallel/halo.py``).
HALO_WIRES = ("f32", "bf16", "int16-delta")

# int16-delta puts a 4-value int16 header in front of each message: the
# bitcast (offset, scale) f32 pair the receiver decodes with
_I16_HDR = 4


def check_wire(wire: str) -> None:
    """Raise ``ERR_INVALID_VALUE`` for a wire that is not in
    :data:`HALO_WIRES`."""
    if wire not in HALO_WIRES:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"unknown halo wire {wire!r} "
                       f"({'|'.join(HALO_WIRES)})")


def wire_itemsize(wire: str, vec_dtype) -> int:
    """Bytes a value takes on the wire: the vector dtype's width for
    "f32", 2 for the compressed formats (int16-delta's 8-byte header a
    message not counted)."""
    check_wire(wire)
    if wire == "f32":
        return int(np.dtype(vec_dtype).itemsize)
    return 2


def wire_encode(buf: torch.Tensor, wire: str) -> torch.Tensor:
    """Encode one halo message, ``buf`` ([B,] m) at the vector dtype:
    "f32" is the identity, "bf16" the bf16 bit pattern as int16,
    "int16-delta" ([B,] 4 + m) int16 with one (offset, scale) pair a
    system along the last axis (offset the midpoint of the message's
    range, scale the range over 65534 but at least 1.2e-38, the deltas
    rounded half to even and saturated to int16, as XLA converts)."""
    check_wire(wire)
    if wire == "f32":
        return buf
    # every step below rounds the same way on every device: an f64
    # message reaches bf16 through f32 (as XLA converts it), and the
    # scale divides by a tensor (a CUDA division by a Python scalar
    # multiplies by its rounded reciprocal instead)
    b32 = buf.to(torch.float32)
    if wire == "bf16":
        return b32.to(torch.bfloat16).view(torch.int16)
    lo = b32.amin(dim=-1, keepdim=True)
    hi = b32.amax(dim=-1, keepdim=True)
    off = 0.5 * (hi + lo)
    # the smallest-normal floor: a constant message decodes to itself
    scale = torch.clamp((hi - lo) / torch.full_like(hi, 65534.0),
                        min=1.2e-38)
    q = torch.round((b32 - off) / scale).clamp_(-32768, 32767)
    hdr = torch.cat([off, scale], dim=-1).view(torch.int16)
    return torch.cat([hdr, q.to(torch.int16)], dim=-1)


def wire_decode(buf: torch.Tensor, wire: str,
                dtype: torch.dtype) -> torch.Tensor:
    """Decode one received message to ``dtype``: the inverse of
    :func:`wire_encode` up to its rounding.  For int16-delta, delta ·
    scale + offset rounded once to f32, as the fused multiply-add XLA
    makes of the JAX package's decode in its compiled halo: the product
    of an int16 and an f32 is exact in f64, and the f64 sum rounded to
    f32 is that result on every device (short of a double rounding, which
    needs the exact sum to lie within 2^-53 of an f32 tie)."""
    check_wire(wire)
    if wire == "f32":
        return buf
    if wire == "bf16":
        return buf.view(torch.bfloat16).to(dtype)
    hdr = buf[..., :_I16_HDR].contiguous().view(torch.float32).double()
    body = buf[..., _I16_HDR:].double()
    return (body * hdr[..., 1:2] + hdr[..., :1]).float().to(dtype)


@dataclasses.dataclass(frozen=True)
class ShardTables:
    """The tables of :class:`HaloTables` cut to each shard's real
    entries, as int64 tensors on the shard's device: ``send_rows[p][r]``
    and ``recv_rows[p][r]`` (None where part p has no partner in round
    r), ``pack_rows[p]``, ``ghost_part[p]``/``ghost_pos[p]`` (length
    ``nghost[p]``), and ``pack_width`` = B.  ``send_full[p]``, the whole
    (R, S) send table flattened with its pads at row 0, and
    ``pack_full[p]``, the whole (B,) pack row padded the same way: the
    messages as the JAX package's clipped gathers form them, which a
    compressed wire encodes pads and all, and the put+signal transport
    (``rdma_halo.py``) sends; ``ghost_src[p]``, the flat (slot, position)
    each ghost arrives at, ``max_msg`` = S."""

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
    pack_full: tuple


def shard_tables(tables: HaloTables, ps: PartitionedSystem,
                 devices) -> ShardTables:
    """Upload each shard's slice of ``tables`` to its device."""
    G = tables.nghost_max

    def up(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)
                                ).to(dev)

    S = tables.max_msg
    send_rows, recv_rows, pack_rows, gpart, gpos = [], [], [], [], []
    send_full, ghost_src, pack_full = [], [], []
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
        pack_full.append(up(np.maximum(pk, 0), dev))
        gpart.append(up(tables.ghost_src_part[i, : p.nghost], dev))
        gpos.append(up(tables.ghost_src_pos[i, : p.nghost], dev))
    return ShardTables(partner=tables.partner, send_rows=tuple(send_rows),
                       recv_rows=tuple(recv_rows),
                       pack_rows=tuple(pack_rows), ghost_part=tuple(gpart),
                       ghost_pos=tuple(gpos),
                       nghost=tuple(p.nghost for p in ps.parts),
                       pack_width=tables.pack_idx.shape[1],
                       send_full=tuple(send_full),
                       ghost_src=tuple(ghost_src), max_msg=S,
                       pack_full=tuple(pack_full))


def on_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, copied only when it lies elsewhere."""
    return t if t.device == dev else t.to(dev)


def halo_ppermute(xs, st: ShardTables, wire: str = "f32") -> list:
    """Ghost vectors of every shard through the edge-coloured rounds: in
    round r, part q's ghost slots ``recv_rows[q][r]`` get the values its
    partner a = partner[q, r] gathers by ``send_rows[a][r]`` (the colouring
    is symmetric, so a's slot r pairs with q's).  ``xs[p]`` is shard p's
    owned vector, (n,) or a (B, n) batch whose B systems move in the same
    gather and copy; ghosts come back in slot order, one ([B,] nghost)
    tensor a shard.  A compressed ``wire`` encodes a's whole S-wide message
    (``send_full``, pads and all, as the JAX package's clipped gather
    forms it) once a round, moves the encoding, and decodes it on q's
    device."""
    global ppermute_rounds, ppermute_bytes
    check_wire(wire)
    R, S = st.partner.shape[1], st.max_msg
    ppermute_rounds += int((st.partner >= 0).any(axis=0).sum())
    ghosts = [torch.zeros(x.shape[:-1] + (g,), dtype=x.dtype,
                          device=x.device)
              for x, g in zip(xs, st.nghost)]
    for r in range(R):
        for q, gq in enumerate(ghosts):
            a = int(st.partner[q, r])
            if a < 0:
                continue
            rows = st.recv_rows[q][r]
            if wire == "f32":
                msg = xs[a][..., st.send_rows[a][r]]
                ppermute_bytes += msg.nbytes
            else:
                full = st.send_full[a][r * S: (r + 1) * S]
                enc = wire_encode(xs[a][..., full], wire)
                ppermute_bytes += enc.nbytes
                msg = wire_decode(on_device(enc, gq.device), wire,
                                  gq.dtype)[..., : rows.shape[0]]
            gq[..., rows] = on_device(msg, gq.device)
    return ghosts


def halo_allgather(xs, st: ShardTables, wire: str = "f32") -> list:
    """Ghost vectors of every shard through one gather of all packs: each
    part packs its border values, every device holds the ([B,] P, width)
    stack of packs, and each ghost is read at (owner, position).  A
    compressed ``wire`` encodes each part's whole pack row
    (``pack_full``) once and decodes it once on every device that holds
    shards."""
    global allgathers, allgather_bytes
    check_wire(wire)
    if wire == "f32":
        packs = [x[..., rows] for x, rows in zip(xs, st.pack_rows)]
    else:
        packs = [wire_encode(x[..., rows], wire)
                 for x, rows in zip(xs, st.pack_full)]
    allgathers += 1
    allgather_bytes += sum(pk.nbytes for pk in packs)
    stacks = {}
    for x in xs:
        if x.device in stacks:
            continue
        full = torch.zeros(x.shape[:-1] + (len(xs), st.pack_width),
                           dtype=x.dtype, device=x.device)
        for p, pk in enumerate(packs):
            pk = on_device(pk, x.device)
            if wire != "f32":
                pk = wire_decode(pk, wire, x.dtype)
            full[..., p, : pk.shape[-1]] = pk
        stacks[x.device] = full
    return [stacks[x.device][..., gp, gq]
            for x, gp, gq in zip(xs, st.ghost_part, st.ghost_pos)]
