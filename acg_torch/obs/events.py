"""Per-request tracing: trace IDs, the flight recorder, Chrome traces
(the port of ``acg_tpu.obs.events``).

The metrics registry (:mod:`acg_torch.obs.metrics`) aggregates; this
module keeps the INDIVIDUAL request observable:

- **trace IDs** — a 16-hex-digit ID minted at ``submit()`` and threaded
  through the whole request path (admission → coalescing queue →
  dispatch → demux → response), cross-linked into the request's audit
  document (``session.trace_id`` / ``admission.trace_id``);
- **the flight recorder** — :class:`FlightRecorder`, a bounded ring
  buffer of the last N request event timelines (each itself bounded to
  ``max_events`` entries, so memory is O(N · max_events) forever),
  dumpable on demand (the serve REPL's ``flightrec`` command).

Everything here is host-side wall-clock bookkeeping: no device code.
With no recorder attached (the default for a bare
:class:`~acg_torch.serve.queue.CoalescingQueue`) the serve stack pays
only ``None`` checks.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

__all__ = ["new_trace_id", "RequestTimeline", "FlightRecorder"]


def new_trace_id() -> str:
    """A 64-bit random trace ID as 16 lowercase hex digits (the W3C
    trace-context parent-id width) — collision-safe at flight-recorder
    scale, cheap enough to mint per request."""
    return os.urandom(8).hex()


class RequestTimeline:
    """One request's ordered event list: ``(t, name, attrs)`` with
    ``t`` seconds since the owning recorder's epoch.  Event count is
    bounded — past ``max_events`` the timeline records one final
    ``truncated`` marker and drops the rest (bounded memory beats a
    complete log, flight-recorder rule one)."""

    def __init__(self, recorder: "FlightRecorder", request_id,
                 trace_id: str, max_events: int):
        self._recorder = recorder
        self.request_id = request_id
        self.trace_id = trace_id
        self.max_events = int(max_events)
        self.events: list[tuple[float, str, dict]] = []
        self._lock = threading.Lock()
        self.event("submit")

    def event(self, name: str, **attrs) -> None:
        t = self._recorder.now()
        with self._lock:
            n = len(self.events)
            if n >= self.max_events:
                return
            if n == self.max_events - 1 and name != "truncated":
                self.events.append((t, "truncated", {}))
                return
            self.events.append((t, name, attrs))

    def as_dict(self) -> dict:
        with self._lock:
            events = list(self.events)
        return {"trace_id": self.trace_id,
                "request_id": (None if self.request_id is None
                               else str(self.request_id)),
                "events": [{"t": round(t, 6), "event": name, **attrs}
                           for t, name, attrs in events]}


class FlightRecorder:
    """Bounded ring buffer of request timelines (newest-last).  A
    timeline enters the ring at :meth:`begin` — the deque's ``maxlen``
    evicts the oldest as traffic flows, so the recorder always holds
    the LAST ``capacity`` requests with zero maintenance."""

    def __init__(self, capacity: int = 256, max_events: int = 64,
                 clock=time.perf_counter):
        self.capacity = int(capacity)
        self.max_events = int(max_events)
        self._clock = clock
        self.epoch = clock()
        self._ring: deque[RequestTimeline] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def now(self) -> float:
        return self._clock() - self.epoch

    def begin(self, request_id=None,
              trace_id: str | None = None) -> RequestTimeline:
        tl = RequestTimeline(self, request_id,
                             trace_id if trace_id is not None
                             else new_trace_id(),
                             self.max_events)
        with self._lock:
            self._ring.append(tl)
        return tl

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def timelines(self) -> list[RequestTimeline]:
        with self._lock:
            return list(self._ring)

    def dump(self) -> list[dict]:
        """Every held timeline, oldest first, JSON-ready — the
        ``flightrec`` REPL command's payload."""
        return [tl.as_dict() for tl in self.timelines()]

    def find(self, trace_id: str) -> dict | None:
        for tl in self.timelines():
            if tl.trace_id == trace_id:
                return tl.as_dict()
        return None
