"""Device-initiated halo exchange: put+signal between shard buffers.

The port of ``acg_tpu/parallel/rdma_halo.py`` and of its TPU kernel
``rdma_exchange`` (``_rdma_kernel``), the analog of the reference's
NVSHMEM put+signal (acg/cg-kernels-cuda.cu:734-746, 876-887).  Each
shard's (R, S) message blocks use the edge-coloured slots of
``acg_torch/parallel/halo.py``: slot r of shard p is delivered into slot
r of shard ``partner[p, r]``, or into p's own when it has no partner in
that round (its payload is then never read).

On CUDA tensors :func:`rdma_exchange` launches the hand-written kernel of
``acg_torch/csrc/rdma_halo.cu``, once per device that holds shards: its
blocks store their slots straight into the partners' receive buffers,
signal a flag there, and wait on their own flags.  The buffers, flags
and epochs it needs live in an :class:`RdmaState`, made once per system.
On CPU tensors it runs :func:`rdma_exchange_plain`, the same delivery by
indexing.  There is no fallback between the two: a CUDA call that cannot
launch raises, and a wait that outlasts ``TIMEOUT_S`` ends the
kernel with an error word set, which :meth:`RdmaState.check` turns into
an error, so a partner that never puts cannot hang the caller.  The gather of the send blocks from the owned vector and
the gather of the ghosts from the delivered blocks stay torch ops
(:func:`halo_rdma`), as they stay XLA in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.parallel.halo import on_device

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

# words a block moves at least: a slot is cut into chunks of this size,
# one block each, as far as the grid stays co-resident
MIN_CHUNK = 2048

# seconds a block waits for its partner's put before it gives up
TIMEOUT_S = 10.0

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


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("rdma_halo")
        lib.acg_rdma_exchange.restype = ctypes.c_int
        lib.acg_rdma_exchange.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p]
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


class RdmaState:
    """What the kernel's exchanges on one set of shards reuse: per shard
    a send block and an output block (R, S), two receive blocks (one per
    parity), R·C arrival flags and epochs (int32, zero at the start) and
    an error word, all on the shard's device; per launching device a
    table of every shard's six pointers, its local shard ids and the
    partner table.  Peer access is enabled between every two distinct
    devices.

    ``devices`` are ``make_mesh``'s: CUDA devices with their index.
    ``C`` (chunks a slot) is the largest count that keeps chunks of at
    least ``MIN_CHUNK`` words and the busiest device's grid within the
    blocks it can hold at once; every device's grid is checked against
    its capacity here, before any launch, so no exchange starts on one
    card and fails on the next for want of room.  The output blocks are
    overwritten by the next exchange.  ``TIMEOUT_S``, read here, bounds
    every wait of the kernel."""

    def __init__(self, partner: np.ndarray, S: int, dtype: torch.dtype,
                 devices):
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
        lib = _load()
        uniq = list(dict.fromkeys(devices))
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
        C = max(1, min(-(-S // MIN_CHUNK), min(caps.values())
                       // (busiest * R)))
        self.chunk = -(-S // C)
        self.C = -(-S // self.chunk)
        for d in uniq:
            grid = devices.count(d) * R * self.C
            if grid > caps[d]:
                raise AcgError(Status.ERR_NOT_SUPPORTED,
                               f"rdma: {grid} blocks on {d} cannot be "
                               f"resident at once (it holds {caps[d]})")
        self.R, self.S, self.word, self.devices = R, S, word, devices
        self.timeout_ns = int(TIMEOUT_S * 1e9)
        self.spoilt = False
        self.send = [torch.zeros((R, S), dtype=dtype, device=d)
                     for d in devices]
        self.out = [torch.zeros((R, S), dtype=dtype, device=d)
                    for d in devices]
        self.recv = [torch.zeros((2, R, S), dtype=dtype, device=d)
                     for d in devices]
        self.flags = [torch.zeros(R * self.C, dtype=torch.int32, device=d)
                      for d in devices]
        self.epoch = [torch.zeros(R * self.C, dtype=torch.int32, device=d)
                      for d in devices]
        self.err = [torch.zeros(1, dtype=torch.int32, device=d)
                    for d in devices]
        table = np.array([[t.data_ptr() for t in ptrs]
                          for ptrs in zip(self.recv, self.flags, self.send,
                                          self.out, self.epoch, self.err)],
                         dtype=np.int64)
        self.launch_tables = []
        for d in uniq:
            local = [p for p, dp in enumerate(devices) if dp == d]
            self.launch_tables.append((
                d, len(local), torch.from_numpy(table).to(d),
                torch.tensor(local, dtype=torch.int32, device=d),
                torch.from_numpy(self.partner).to(d)))

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


def rdma_exchange(sendbufs, partner: np.ndarray, state: RdmaState | None = None
                  ) -> list:
    """Deliver every shard's (R, S) message blocks: slot r of shard p goes
    into slot r of shard ``partner[p, r]`` (its own when -1).  Returns the
    delivered blocks, one (R, S) tensor a shard.

    CPU tensors take :func:`rdma_exchange_plain`.  CUDA tensors launch the
    kernel once per device that holds shards, on that device's current
    stream, with ``state``'s buffers (required); send blocks that are not
    ``state.send`` are copied in first, and the result is ``state.out``,
    valid until the next exchange.  Raises on a dtype the kernel does not
    move, a launch error, a grid that cannot be co-resident, or a state
    that failed before; a wait that times out sets the state's error
    word, which :meth:`RdmaState.check` reads."""
    global launches
    if all(sb.device.type == "cpu" for sb in sendbufs):
        return rdma_exchange_plain(sendbufs, partner)
    if state is None:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "rdma_exchange: CUDA shards need an RdmaState")
    if state.spoilt:
        state.check()
    if not np.array_equal(np.asarray(partner), state.partner):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "rdma_exchange: partner table differs from the "
                       "state's")
    for sb, mine in zip(sendbufs, state.send):
        if sb.shape != mine.shape or sb.dtype != mine.dtype \
                or sb.device != mine.device:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"rdma_exchange: send block {tuple(sb.shape)} "
                           f"{sb.dtype} on {sb.device}, the state holds "
                           f"{tuple(mine.shape)} {mine.dtype} on "
                           f"{mine.device}")
        if sb.data_ptr() != mine.data_ptr():
            mine.copy_(sb)
    lib = _load()
    for dev, nlocal, shards, local, part in state.launch_tables:
        with torch.cuda.device(dev):
            rc = lib.acg_rdma_exchange(
                shards.data_ptr(), local.data_ptr(), nlocal,
                part.data_ptr(), state.R, state.C, state.S, state.chunk,
                state.word, state.timeout_ns,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            # grids launched on other cards give up at their timeout
            state.spoilt = True
            _raise("kernel launch", rc)
        launches += 1
    return state.out


def halo_rdma(xs, st, state: RdmaState | None = None) -> list:
    """Ghost vectors of every shard through :func:`rdma_exchange`: each
    shard gathers its (R, S) send blocks by ``st.send_full`` (pads read
    row 0, as the JAX package's clipped gather does), the blocks are
    delivered, and each ghost is read from its slot by ``st.ghost_src``.
    The same contract as ``halo_ppermute``."""
    R, S = st.partner.shape[1], st.max_msg
    if state is None:
        sendbufs = [x[idx].view(R, S) for x, idx in zip(xs, st.send_full)]
    else:
        sendbufs = [torch.index_select(x, 0, idx, out=buf.view(-1)
                                       ).view(R, S)
                    for x, idx, buf in zip(xs, st.send_full, state.send)]
    outs = rdma_exchange(sendbufs, st.partner, state)
    return [out.view(-1)[g] for out, g in zip(outs, st.ghost_src)]
