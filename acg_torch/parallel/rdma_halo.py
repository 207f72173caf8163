"""Device-initiated halo exchange: put+signal between shard buffers.

The port of ``acg_tpu/parallel/rdma_halo.py`` and of its TPU kernel
``rdma_exchange`` (``_rdma_kernel``), the analog of the reference's
NVSHMEM put+signal (acg/cg-kernels-cuda.cu:734-746, 876-887).  Each
shard's (R, S) message blocks use the edge-coloured slots of
``acg_torch/parallel/halo.py``: slot r of shard p is delivered into slot
r of shard ``partner[p, r]``, or into p's own when it has no partner in
that round (its payload is then never read).

On CUDA tensors both entry points launch the hand-written kernel of
``acg_torch/csrc/rdma_halo.cu``, once per device that holds shards: its
blocks store their slots straight into the partners' receive buffers,
signal a flag there, and wait on their own flags.  :func:`halo_rdma`
(the halo of ``cg_dist``'s ``--halo rdma``) gathers the send words from
each shard's owned vector and writes the delivered words to its ghosts
in the same launch, through the maps an :class:`RdmaState` builds once
from the halo tables; :func:`rdma_exchange` runs the same kernel on
(R, S) blocks.  The buffers, flags and epochs live in the state, made
once per system.  On CPU tensors they run :func:`halo_rdma_plain` and
:func:`rdma_exchange_plain`, the same delivery by indexing.  There is no
fallback between the two: a CUDA call that cannot launch raises, and a
wait that outlasts ``TIMEOUT_S`` ends the kernel with an error word set,
which :meth:`RdmaState.check` turns into an error, so a partner that
never puts cannot hang the caller.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.parallel.halo import on_device
from acg_torch.utils.backend import kernel_device

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

# words a block moves at least: a slot is cut into chunks of this size,
# one block each, as far as the grid stays co-resident (a sweep of 256 to
# 2048 on the card: the largest was as fast or faster, the kernel's time
# being its flag round trip, PERF.md)
MIN_CHUNK = 2048

# seconds a block waits for its partner's put before it gives up
TIMEOUT_S = 10.0

# shards one launch serves (kMaxLocal in csrc/rdma_halo.cu)
MAX_LOCAL = 64

_GROUP = 16             # bytes of one store into a receive buffer

_lib = None


def rdma_exchange_plain(sendbufs, partner: np.ndarray) -> list:
    """The plain PyTorch version: ``out[p][r] = sendbufs[partner[p, r]][r]``
    (``sendbufs[p][r]`` where partner is -1), the delivery of the kernel
    for a symmetric colouring, each result on its shard's device."""
    out = []
    for p, sb in enumerate(sendbufs):
        rows = []
        for r in range(partner.shape[1]):
            q = int(partner[p, r])
            src = sendbufs[q] if q >= 0 else sb
            rows.append(on_device(src[r], sb.device))
        out.append(torch.stack(rows))
    return out


def ghost_slots(ghost_src: torch.Tensor, nslots: int) -> torch.Tensor:
    """The inverse of a shard's ``ghost_src``: for each flat (slot,
    position) of its R x S receive blocks, the ghost that position fills,
    or -1 for a pad (int64, on ``ghost_src``'s device).  The kernel's
    unpack map."""
    out = torch.full((nslots,), -1, dtype=torch.int64,
                     device=ghost_src.device)
    out[ghost_src] = torch.arange(ghost_src.numel(), device=ghost_src.device)
    return out


def halo_rdma_plain(xs, st) -> list:
    """The plain PyTorch version of the fused halo: each shard gathers its
    (R, S) send blocks from its owned vector by ``st.send_full`` (pads
    read row 0, as the JAX package's clipped gather does), the blocks are
    delivered by :func:`rdma_exchange_plain`, and every delivered word is
    written to its ghost through :func:`ghost_slots` (the kernel's
    unpack).  The same contract as ``halo_ppermute``."""
    R, S = st.partner.shape[1], st.max_msg
    outs = rdma_exchange_plain([x[idx].view(R, S)
                                for x, idx in zip(xs, st.send_full)],
                               st.partner)
    ghosts = []
    for x, out, src, g in zip(xs, outs, st.ghost_src, st.nghost):
        slot = ghost_slots(src, R * S)
        gh = torch.zeros(g, dtype=x.dtype, device=x.device)
        gh[slot[slot >= 0]] = out.reshape(-1)[slot >= 0]
        ghosts.append(gh)
    return ghosts


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("rdma_halo")
        lib.acg_rdma_exchange.restype = ctypes.c_int
        lib.acg_rdma_exchange.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p]
        lib.acg_rdma_enable_peer.restype = ctypes.c_int
        lib.acg_rdma_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.acg_rdma_capacity.restype = ctypes.c_int
        lib.acg_rdma_capacity.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


def _raise(what: str, rc: int):
    raise AcgError(Status.ERR_NOT_SUPPORTED,
                   f"rdma_exchange: {what} failed (CUDA error {rc})")


class _Launch:
    """One device's launch: its shards, the device tables every exchange
    reuses, the scope its partners' placement fixes (``sys``: a partner
    on another card) and the host arrays of the launch's parameters."""

    def __init__(self, device, local, shards, partner, sys: bool):
        self.device, self.local = device, tuple(local)
        self.shards, self.partner, self.sys = shards, partner, sys
        n = len(self.local)
        self.c_local = (ctypes.c_int32 * n)(*self.local)
        self.c_src = (ctypes.c_uint64 * n)()
        self.c_dst = (ctypes.c_uint64 * n)()


class RdmaState:
    """What the kernel's exchanges on one set of shards reuse: per shard
    an output block (R, S), two receive blocks (one per parity, each row
    padded to 16 bytes), R·C arrival flags and epochs (int32, zero at the
    start) and an error word, all on the shard's device; per launching
    device a table of every shard's pointers, the partner table and its
    scope.  Peer access is enabled between every two distinct devices.

    ``devices`` are ``make_mesh``'s: CUDA devices with their index.
    ``tables`` (the system's ``ShardTables``) makes the state serve
    :func:`halo_rdma` on them: per shard its pack map (``send_full``) and
    unpack map (:func:`ghost_slots` of ``ghost_src``), int32, and its
    ghost vector, which the halo overwrites.  ``C`` (chunks a slot) is the
    largest count that keeps chunks of at least ``MIN_CHUNK`` words and
    the busiest device's grid within the blocks it can hold at once;
    every device's grid is checked against its capacity here, before any
    launch, so no exchange starts on one card and fails on the next for
    want of room.  A launch synchronises at system scope when one of its
    shards has a partner on another device, else at GPU scope.  The
    output blocks and ghosts are overwritten by the next exchange.
    ``TIMEOUT_S``, read here, bounds every wait of the kernel."""

    def __init__(self, partner: np.ndarray, S: int, dtype: torch.dtype,
                 devices, tables=None):
        self.given_partner = partner
        self.partner = np.ascontiguousarray(partner, dtype=np.int32)
        P, R = self.partner.shape
        devices = [torch.device(d) for d in devices]
        if len(devices) != P:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"rdma: {len(devices)} devices for {P} shards")
        if any(d.type != "cuda" or d.index is None for d in devices):
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "rdma: the put+signal kernel needs every shard "
                           "on a CUDA device given with its index "
                           f"(make_mesh's devices), not {devices}")
        word = torch.empty((), dtype=dtype).element_size()
        if word not in (4, 8):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"rdma: the kernel moves 4- or 8-byte words, "
                           f"not {dtype}")
        uniq = list(dict.fromkeys(devices))
        if max(devices.count(d) for d in uniq) > MAX_LOCAL:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           f"rdma: more than {MAX_LOCAL} shards on one "
                           "device")
        if tables is not None and (
                tables.max_msg != S
                or not np.array_equal(tables.partner, self.partner)):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "rdma: the halo tables' partners or message "
                           "length differ from the state's")
        lib = _load()
        for a in uniq:
            for b in uniq:
                if a != b:
                    rc = lib.acg_rdma_enable_peer(a.index, b.index)
                    if rc != 0:
                        _raise(f"peer access {a} -> {b}", rc)
        caps = {}
        for d in uniq:
            sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
            rc = lib.acg_rdma_capacity(d.index, word, ctypes.byref(sms),
                                       ctypes.byref(per_sm))
            if rc != 0:
                _raise("capacity query", rc)
            caps[d] = sms.value * per_sm.value
        busiest = max(devices.count(d) for d in uniq)
        vw = _GROUP // word
        C = max(1, min(-(-S // MIN_CHUNK), min(caps.values())
                       // (busiest * R)))
        per = -(-S // C)                # words a chunk, rounded up to
        self.chunk = -(-per // vw) * vw  # whole 16-byte groups
        self.C = -(-S // self.chunk)
        for d in uniq:
            grid = devices.count(d) * R * self.C
            if grid > caps[d]:
                raise AcgError(Status.ERR_NOT_SUPPORTED,
                               f"rdma: {grid} blocks on {d} cannot be "
                               f"resident at once (it holds {caps[d]})")
        self.R, self.S, self.word, self.devices = R, S, word, devices
        self.Sp = -(-S // vw) * vw
        self.dtype, self.tables = dtype, tables
        self.timeout_ns = int(TIMEOUT_S * 1e9)
        self.spoilt = False
        self.out = [torch.zeros((R, S), dtype=dtype, device=d)
                    for d in devices]
        self.recv = [torch.zeros((2, R, self.Sp), dtype=dtype, device=d)
                     for d in devices]
        self.flags = [torch.zeros(R * self.C, dtype=torch.int32, device=d)
                      for d in devices]
        self.epoch = [torch.zeros(R * self.C, dtype=torch.int32, device=d)
                      for d in devices]
        self.err = [torch.zeros(1, dtype=torch.int32, device=d)
                    for d in devices]
        self.pack, self.unpack, self.ghosts, self.need = [], [], [], []
        if tables is not None:
            for p, d in enumerate(devices):
                idx, src = tables.send_full[p], tables.ghost_src[p]
                slot = ghost_slots(src, R * S)
                if int((slot >= 0).sum()) != src.numel():
                    raise AcgError(Status.ERR_INVALID_VALUE,
                                   f"rdma: two ghosts of part {p} arrive "
                                   "at one slot position")
                self.pack.append(idx.to(device=d, dtype=torch.int32))
                self.unpack.append(slot.to(device=d, dtype=torch.int32))
                self.ghosts.append(torch.zeros(tables.nghost[p],
                                               dtype=dtype, device=d))
                self.need.append(int(idx.max()) + 1)
        table = np.array(
            [[self.recv[p].data_ptr(), self.flags[p].data_ptr(),
              self.epoch[p].data_ptr(), self.err[p].data_ptr(),
              self.pack[p].data_ptr() if tables is not None else 0,
              self.unpack[p].data_ptr() if tables is not None else 0]
             for p in range(P)], dtype=np.int64)
        self.launch_tables = []
        for d in uniq:
            local = [p for p, dp in enumerate(devices) if dp == d]
            cross = any(devices[int(q)] != d for p in local
                        for q in self.partner[p] if q >= 0)
            self.launch_tables.append(_Launch(
                d, local, torch.from_numpy(table).to(d),
                torch.from_numpy(self.partner).to(d), cross))

    @property
    def scope(self) -> str:
        """"sys" when a launch has a partner on another card, else
        "gpu"."""
        return "sys" if any(lt.sys for lt in self.launch_tables) else "gpu"

    def check(self) -> None:
        """Raise if an exchange on this state failed: a launch error, or
        a wait that timed out on the card (which this reads, after the
        work queued so far).  A failed state stays failed."""
        if not self.spoilt and any(int(e.item()) for e in self.err):
            self.spoilt = True
        if self.spoilt:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "rdma_exchange: an exchange failed (a launch "
                           "error, or a partner's put did not arrive "
                           f"within {self.timeout_ns / 1e9} s); this "
                           "state's flags are spoilt")

    def _launch(self, src, dst, halo: bool) -> None:
        """One launch a device: ``src[p]`` and ``dst[p]`` are shard p's
        vectors (halo: owned vector and ghosts; else the (R, S) send and
        output blocks)."""
        global launches
        if self.spoilt:
            self.check()
        lib = _load()
        for lt in self.launch_tables:
            for k, p in enumerate(lt.local):
                lt.c_src[k] = src[p].data_ptr()
                lt.c_dst[k] = dst[p].data_ptr()
            with kernel_device(lt.shards):
                rc = lib.acg_rdma_exchange(
                    lt.shards.data_ptr(), lt.partner.data_ptr(),
                    len(lt.local), lt.c_local, lt.c_src, lt.c_dst,
                    int(halo), int(lt.sys), self.R, self.C, self.S,
                    self.Sp, self.chunk, self.word, self.timeout_ns,
                    torch.cuda.current_stream(lt.device).cuda_stream)
            if rc != 0:
                # grids launched on other cards give up at their timeout
                self.spoilt = True
                _raise("kernel launch", rc)
            launches += 1


def rdma_exchange(sendbufs, partner: np.ndarray, state: RdmaState | None = None
                  ) -> list:
    """Deliver every shard's (R, S) message blocks: slot r of shard p goes
    into slot r of shard ``partner[p, r]`` (its own when -1).  Returns the
    delivered blocks, one (R, S) tensor a shard.

    CPU tensors take :func:`rdma_exchange_plain`.  CUDA tensors launch the
    kernel once per device that holds shards, on that device's current
    stream, with ``state``'s buffers (required): it reads the send blocks
    where they lie and the result is ``state.out``, valid until the next
    exchange.  The partner table is compared with the state's unless it
    is the table the state was made from.  Raises on send blocks of
    another shape, dtype or device, a launch error, a grid that cannot be
    co-resident, or a state that failed before; a wait that times out
    sets the state's error word, which :meth:`RdmaState.check` reads."""
    if all(sb.device.type == "cpu" for sb in sendbufs):
        return rdma_exchange_plain(sendbufs, partner)
    if state is None:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "rdma_exchange: CUDA shards need an RdmaState")
    if partner is not state.given_partner and not np.array_equal(
            np.asarray(partner), state.partner):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "rdma_exchange: partner table differs from the "
                       "state's")
    for sb, mine in zip(sendbufs, state.out):
        if (sb.shape != mine.shape or sb.dtype != mine.dtype
                or sb.device != mine.device or not sb.is_contiguous()):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"rdma_exchange: send block {tuple(sb.shape)} "
                           f"{sb.dtype} on {sb.device}, the state holds "
                           f"contiguous {tuple(mine.shape)} {mine.dtype} "
                           f"on {mine.device}")
    state._launch(sendbufs, state.out, halo=False)
    return state.out


def halo_rdma(xs, st, state: RdmaState | None = None) -> list:
    """Ghost vectors of every shard through the put+signal kernel: each
    shard's send words are gathered from its owned vector by
    ``st.send_full``, delivered, and written to its ghosts through the
    inverse of ``st.ghost_src``, in one launch a device.  The same
    contract as ``halo_ppermute``.  CPU tensors take
    :func:`halo_rdma_plain`; CUDA tensors need the :class:`RdmaState`
    made with these tables, and return ``state.ghosts``, valid until the
    next exchange."""
    if all(x.device.type == "cpu" for x in xs):
        return halo_rdma_plain(xs, st)
    if state is None or state.tables is not st:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "halo_rdma: CUDA shards need the RdmaState made "
                       "with these halo tables")
    for x, d, need in zip(xs, state.devices, state.need):
        if (x.dtype != state.dtype or x.device != d or x.dim() != 1
                or x.numel() < need or not x.is_contiguous()):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"halo_rdma: owned vector {tuple(x.shape)} "
                           f"{x.dtype} on {x.device}: want a contiguous "
                           f"vector of at least {need} {state.dtype} on "
                           f"{d}")
    state._launch(xs, state.ghosts, halo=True)
    return state.ghosts
