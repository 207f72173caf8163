"""Host-side phase-span tracing (the port of ``acg_tpu.obs.trace``).

A tiny wall-clock span tracer for the solve pipeline's host phases (read,
partition, operator-build, compile, solve: the names the serve layer's
``Session.stats()["walls"]`` reads).  Spans are context managers,
nestable, and each span also enters ``torch.profiler.record_function``
so the host timeline lines up with a ``torch.profiler`` trace of the
card (a no-op when no profiler is active; a failure there degrades to
wall-clock-only spans: the tracer must never take down the solve it
observes).

The reference program interleaves ``acgtime_gettime`` pairs around each
pipeline stage and prints deltas (ref cuda/acg-cuda.c:1296-2261); here
the same timeline is recorded structurally.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class Span:
    """One completed (or in-flight) phase span.

    ``start`` is seconds since the tracer's epoch; ``duration`` is NaN
    while the span is still open.  ``depth`` is the nesting level at
    entry (0 = top-level phase)."""

    name: str
    start: float
    duration: float = float("nan")
    depth: int = 0

    def as_dict(self) -> dict:
        return {"name": self.name, "start": self.start,
                "duration": self.duration, "depth": self.depth}


class SpanTracer:
    """Nestable wall-clock spans with optional live logging.

    ``log``, when given, is called with one formatted line as each span
    closes (the CLI routes this through its ``-v`` logger, replacing the
    ad-hoc timestamp prints).  Spans are recorded in COMPLETION order in
    ``spans``; :meth:`as_dicts` returns them sorted by start time, the
    order a timeline reader expects.
    """

    def __init__(self, log=None, clock=time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self._log = log
        self._stack: list[Span] = []
        self.spans: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str):
        sp = Span(name=name, start=self._clock() - self._epoch,
                  depth=len(self._stack))
        self._stack.append(sp)
        try:
            with _trace_annotation(name):
                yield sp
        finally:
            sp.duration = (self._clock() - self._epoch) - sp.start
            self._stack.pop()
            self.spans.append(sp)
            if self._log is not None:
                self._log(f"{'  ' * sp.depth}[{sp.name}] "
                          f"{sp.duration:.3f}s")

    def as_dicts(self) -> list[dict]:
        """Completed spans as JSON-ready dicts, sorted by start time."""
        return [s.as_dict() for s in sorted(self.spans,
                                            key=lambda s: s.start)]

    @property
    def epoch(self) -> float:
        """The clock reading the spans' starts count from."""
        return self._epoch

    def as_chrome_trace(self, pid: int = 0, tid: int = 0) -> list[dict]:
        """Completed spans as Chrome trace-event "X" (complete) events,
        microseconds from the epoch (``acg_torch.obs.events``
        ``chrome_trace`` assembles the document)."""
        out = []
        for s in sorted(self.spans, key=lambda s: s.start):
            dur = 0.0 if s.duration != s.duration else s.duration
            out.append({"name": s.name, "ph": "X", "pid": pid,
                        "tid": tid, "ts": s.start * 1e6,
                        "dur": dur * 1e6, "cat": "phase",
                        "args": {"depth": s.depth}})
        return out

    def total(self, name: str) -> float:
        """Summed duration of completed spans with this name — the
        aggregate the serve layer's ``session.stats()`` reports (e.g.
        total compile wall across all cache misses)."""
        return float(sum(s.duration for s in self.spans
                         if s.name == name and s.duration == s.duration))


def _trace_annotation(name: str):
    """``torch.profiler.record_function`` (a range in a profiler trace),
    else a null context: span timing must survive a broken backend."""
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()
