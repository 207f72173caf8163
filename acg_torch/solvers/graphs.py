"""The device-resident loop: a CG loop's blocks captured as CUDA graphs.

The JAX package runs a whole solve as one compiled ``lax.while_loop``.
The port's loops (``acg_torch.solvers.loops``) are Python, and they run
in BLOCKS: the iterations between two points at which the host reads
the device (the ``check_every`` points, segment ends, ``maxits``, the
``replace_every`` schedule).  Inside a block nothing depends on the
host, so a block is a fixed sequence of kernel launches over tensors
that stay put: the loop's carried state lives in static buffers that
the block reads at its start and writes at its end.

:class:`BlockRunner` runs those blocks.  Open, it calls a block as
Python (every kernel launched from the host, as before).  As graphs, it
runs the first block of each distinct shape eagerly on its capture
stream (which fills the kernel wrappers' per-stream scratch and the
cuBLAS handles), captures the block the next time that shape comes,
and replays the capture from then on: one host launch a block.  What
the host decides between blocks (the exit test, pipelined
certification, the restart) runs eagerly between replays, exactly as in
the open loop, so a graph solve gives the open loop's bits.

A failed capture raises; no path drops to the open loop on its own.
The kernels' launch counters are Python integers that a replay does not
move: the runner records each counter's change during a capture, puts
the counters back (a capture launches nothing) and adds the change on
every replay.  The host seconds of the captures go into
``SolveStats.tcapture``; ``tsolve`` includes them.
"""

from __future__ import annotations

import gc
import importlib
import time

import torch

from acg_torch.errors import AcgError, Status

# every kernel wrapper's launch counter, (module, attribute)
COUNTERS = (
    ("acg_torch.ops.dia_kernels", "launches"),
    ("acg_torch.ops.dia_kernels", "pipe_launches"),
    ("acg_torch.ops.dia_kernels", "batched_launches"),
    ("acg_torch.ops.dia_kernels", "ring_launches"),
    ("acg_torch.ops.dia_kernels", "windows_launches"),
    ("acg_torch.ops.stencil", "launches"),
    ("acg_torch.ops.stencil", "pipe_launches"),
    ("acg_torch.ops.stencil", "batched_launches"),
    ("acg_torch.ops.spmv", "launches"),
    ("acg_torch.ops.sgell", "launches"),
    ("acg_torch.parallel.rdma_halo", "launches"),
    ("acg_torch.ops.cg_update", "launches"),
)

# one capture stream a device, shared by every solve on it, so the
# wrappers' scratch made for it is made once
_STREAMS: dict = {}

# one graph memory pool a device, shared by every solve's captures: a
# block's intermediates die inside its capture and replays run one at a
# time on one stream, so the captures can share memory; a pool a solve
# would leave each solve's memory reserved until the allocator, out of
# room, frees it all at once.  The anchor, a capture of one small fill
# kept for the process, holds the pool open between solves.
_POOLS: dict = {}


def _pool(idx: int, stream):
    got = _POOLS.get(idx)
    if got is None:
        handle = torch.cuda.graph_pool_handle()
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            anchor.capture_begin(pool=handle)
            torch.zeros(1, device=torch.device("cuda", idx))
            anchor.capture_end()
        got = _POOLS[idx] = (handle, anchor)
    return got[0]


def counts() -> list:
    """Every launch counter's value, in ``COUNTERS`` order."""
    return [getattr(importlib.import_module(m), a) for m, a in COUNTERS]


def _set(values) -> None:
    for (m, a), v in zip(COUNTERS, values):
        setattr(importlib.import_module(m), a, v)


def _add(deltas) -> None:
    for (m, a), d in zip(COUNTERS, deltas):
        if d:
            mod = importlib.import_module(m)
            setattr(mod, a, getattr(mod, a) + d)


class BlockRunner:
    """Runs one solve's blocks: open (``graph=False``: each block called
    as Python) or as CUDA graphs on ``device`` (``graph=True``; a CUDA
    device, else ``ERR_INVALID_VALUE``).

    :meth:`run` takes a block's ``key`` (what fixes its launch sequence:
    its length, whether it ends at a check point or a replacement, the
    pipelined kernels' buffer parity) and the block itself, a function of
    no arguments that reads and writes the loop's static buffers.  It
    counts what it does: ``ncaptures``, ``nreplays``, ``nopen`` (blocks
    run as Python, warm-up blocks included), ``tcapture`` (host seconds
    of the captures), and adds ``tcapture`` and the counts to ``stats``
    (a ``SolveStats``) when given."""

    def __init__(self, device, graph: bool = False, stats=None):
        self.device = torch.device(device)
        self.graph = bool(graph)
        if self.graph and self.device.type != "cuda":
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "the graph loop captures CUDA graphs: it needs "
                           f"a CUDA device, not {self.device}")
        self.stats = stats
        self.ncaptures = self.nreplays = self.nopen = 0
        self.tcapture = 0.0
        self._graphs: dict = {}
        self._warm: set = set()
        if self.graph:
            idx = self.device.index
            if idx is None:
                idx = torch.cuda.current_device()
                self.device = torch.device("cuda", idx)
            if idx not in _STREAMS:
                _STREAMS[idx] = torch.cuda.Stream(self.device)
            self._stream = _STREAMS[idx]
            self._pool = _pool(idx, self._stream)

    def run(self, key, block) -> None:
        """Run ``block`` once: as Python when open; else by replaying the
        capture made for ``key`` (capturing it first, or, the first time
        ``key`` comes, running it eagerly on the capture stream)."""
        if not self.graph:
            block()
            self.nopen += 1
            self._count("nloopopen", 1)
            return
        got = self._graphs.get(key)
        if got is None:
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            if key not in self._warm:
                with torch.cuda.stream(self._stream):
                    block()
                cur.wait_stream(self._stream)
                self._warm.add(key)
                self.nopen += 1
                self._count("nloopopen", 1)
                return
            got = self._capture(block)
            self._graphs[key] = got
        graph, delta = got
        graph.replay()
        _add(delta)
        self.nreplays += 1
        self._count("nreplays", 1)

    def _capture(self, block):
        t0 = time.perf_counter()
        before = counts()
        graph = torch.cuda.CUDAGraph()
        # capture_begin / capture_end, not torch.cuda.graph: that one
        # also synchronises, collects garbage and empties the allocator's
        # cache on every capture, host seconds a solve would pay for; the
        # collector is held off instead, so no collection stalls a capture
        err = None
        held = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool)
                try:
                    block()
                except Exception as e:
                    err = e
                try:
                    graph.capture_end()
                except Exception as e:
                    err = err or e
        finally:
            if held:
                gc.enable()
        if err is not None:
            _set(before)
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           f"CUDA graph capture of a loop block failed: "
                           f"{type(err).__name__}: {err}") from err
        delta = [a - b for a, b in zip(counts(), before)]
        _set(before)
        dt = time.perf_counter() - t0
        self.ncaptures += 1
        self.tcapture += dt
        self._count("ncaptures", 1)
        self._count("tcapture", dt)
        return graph, delta

    def _count(self, name: str, v) -> None:
        if self.stats is not None:
            setattr(self.stats, name, getattr(self.stats, name) + v)
