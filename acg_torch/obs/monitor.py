"""Throttled live convergence monitoring of the CG loops.

The port of ``acg_tpu.obs.monitor``.  The reference solver's verbose
mode prints ``iteration k: rnrm2 ...`` per iteration from its host loop
(ref acg/cg.c verbose path).  Here the loops keep, on the device, the
scalar each iteration would report (:class:`LoopMonitor`: |r|² for
classic CG, the recurred or certified gamma for pipelined CG, a batch's
worst system) and hand them to the host at the points where the loop
reads the device anyway: the check points, segment and block ends, the
s-step block boundaries, the deep pipeline's flag reads.  They travel in
the same copy as the flag the host reads there, so the monitor adds no
device-to-host copy of its own to an iteration.  Lines therefore trail
the device by up to a block and MUST NOT be used for timing; the
authoritative trajectory is ``SolveResult.residual_history``.

The host side fans each (k, rr) out to registered SINKS
(:func:`add_monitor_sink`): the stderr printer is the default.
``muted()`` suppresses only the printer; other sinks still receive every
line (a warmup solve should still reach them).
"""

from __future__ import annotations

import contextlib
import math
import sys

import torch

_MUTED = False


def _print_sink(k, rr) -> None:
    """Default sink: one ``iteration k: rnrm2 ...`` line on stderr.

    ``rr`` is the squared residual norm carried by the loop (the monitor
    reports sqrt, matching the reference's printed rnrm2); NaN/negative
    drift values are printed as-is rather than crashing the sink.
    Honors :func:`muted`, the only sink that does."""
    if _MUTED:
        return
    rr = float(rr)
    rnrm2 = math.sqrt(rr) if rr >= 0.0 else float("nan")
    print(f"iteration {int(k)}: rnrm2 {rnrm2:.8e}",
          file=sys.stderr, flush=True)


_SINKS = [_print_sink]


def add_monitor_sink(fn) -> None:
    """Register a host-side sink ``fn(k, rr)``.  Idempotent per function
    object.  Sinks run in registration order; they must be cheap, and an
    exception one raises is swallowed so it cannot take down the printer
    or the solve."""
    if fn not in _SINKS:
        _SINKS.append(fn)


def remove_monitor_sink(fn) -> None:
    """Detach a sink registered with :func:`add_monitor_sink`.  The
    default stderr printer can be removed too (and re-added)."""
    try:
        _SINKS.remove(fn)
    except ValueError:
        pass


def monitor_sinks() -> tuple:
    """The currently-registered sinks, in dispatch order (a copy)."""
    return tuple(_SINKS)


@contextlib.contextmanager
def muted():
    """Suppress the printer for the duration of the block (warmup
    solves); every other sink still receives each line.  Emission is
    synchronous with the loop's reads, so nothing emitted inside the
    block leaks a line after it."""
    global _MUTED
    prev = _MUTED
    _MUTED = True
    try:
        yield
    finally:
        _MUTED = prev


def emit_residual_line(k, rr) -> None:
    """Fan one ``(k, rr)`` out to every registered sink (the stderr
    printer by default)."""
    for sink in tuple(_SINKS):
        try:
            sink(k, rr)
        except Exception:
            pass


class LoopMonitor:
    """The loop side of ``monitor_every``: a device buffer of the scalar
    each live iteration reports, written through a device index (so a
    CUDA graph of a block can write it), and the host's cursor of what
    was emitted.

    ``put(k, value, live)`` stores ``value`` at iteration ``k`` (0-d
    device integer) when ``live`` (0-d bool, or True), else into a slot
    nothing reads; the last live ``k`` is kept on the device.  The live
    iterations of every loop form a prefix (a loop that stops going never
    starts again), so that index is their count.  :meth:`read` is the
    host's read at a read point: ``pred`` (the flag the loop reads there)
    and every value not yet emitted up to iteration ``hi`` come back in
    one copy, and the lines with ``k % every == 0`` are emitted."""

    def __init__(self, every: int, maxits: int, dtype, device):
        self.every = int(every)
        self.vals = torch.full((maxits + 2,), float("nan"), dtype=dtype,
                               device=device)
        self.last = torch.zeros((), dtype=torch.int64, device=device)
        self._dump = torch.full((), maxits + 1, dtype=torch.int64,
                                device=device)
        self.emitted = 0
        self.read_hi = 0

    def reset(self) -> None:
        """Back to a new solve's state (a loop that runs solve after
        solve keeps one monitor)."""
        self.vals.fill_(float("nan"))
        self.last.zero_()
        self.emitted = self.read_hi = 0

    def put(self, k, value, live=True) -> None:
        k = k.long()
        if live is True:
            idx = k
            self.last.copy_(k)
        else:
            idx = torch.where(live, k, self._dump)
            torch.where(live, k, self.last, out=self.last)
        self.vals.index_copy_(0, idx.reshape(1),
                              value.reshape(1).to(self.vals.dtype))

    def read(self, pred=None, hi: int | None = None):
        """``bool(pred)`` (None: nothing but the monitor is read), with
        the values of iterations ``emitted+1 .. hi`` in the same copy,
        the live ones emitted.  ``hi`` None: every value written so
        far."""
        lo = self.emitted + 1
        hi = self.vals.shape[0] - 2 if hi is None else int(hi)
        parts = [self.last.reshape(1).double()]
        if pred is not None:
            parts.append(pred.reshape(1).double())
        if hi >= lo:
            parts.append(self.vals[lo: hi + 1].double())
        host = torch.cat(parts).cpu().numpy()
        last = int(host[0])
        vals = host[2 if pred is not None else 1:]
        top = min(hi, last)
        for j in range(lo, top + 1):
            if j % self.every == 0:
                emit_residual_line(j, vals[j - lo])
        self.emitted = max(self.emitted, top)
        self.read_hi = max(self.read_hi, hi)
        return None if pred is None else bool(host[1])

    def flush(self, hi: int) -> None:
        """Emit what iterations up to ``hi`` left, unless a read already
        covered them: the loop's end."""
        if hi > self.read_hi:
            self.read(None, hi)
