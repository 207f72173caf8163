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
  dumpable on demand (the serve REPL's ``flightrec`` command);
- **Chrome traces** — :func:`chrome_trace` / :func:`write_chrome_trace`,
  the host phase spans and the request timelines as one trace-event
  document (``--trace-json``; Perfetto, chrome://tracing), and
  :func:`merge_recorder_dumps`, several recorders on one timebase.

Everything here is host-side wall-clock bookkeeping: no device code.
With no recorder attached (the default for a bare
:class:`~acg_torch.serve.queue.CoalescingQueue`) the serve stack pays
only ``None`` checks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = ["new_trace_id", "RequestTimeline", "FlightRecorder",
           "merge_recorder_dumps", "chrome_trace", "write_chrome_trace"]


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


def merge_recorder_dumps(recorders) -> list[dict]:
    """Several recorders' timeline dumps on ONE timebase (the earliest
    recorder epoch), ordered by each timeline's first event: a request
    seen by two recorders reads as one story under one trace ID."""
    recorders = [r for r in recorders if r is not None]
    if not recorders:
        return []
    epoch0 = min(r.epoch for r in recorders)
    out = []
    for r in recorders:
        off = r.epoch - epoch0
        for d in r.dump():
            d["events"] = [{**ev, "t": round(ev["t"] + off, 6)}
                           for ev in d["events"]]
            out.append(d)
    out.sort(key=lambda d: d["events"][0]["t"] if d["events"] else 0.0)
    return out


def chrome_trace(tracer=None, recorder=None) -> dict:
    """One Trace Event JSON document from a
    :class:`~acg_torch.obs.trace.SpanTracer` (pid 0, "host phases") and/or
    a :class:`FlightRecorder` (pid 1, one tid lane a request).  With both,
    the recorder's timestamps are shifted onto the tracer's epoch (both
    clocks are ``perf_counter`` seconds) so phases and requests line up."""
    events: list[dict] = []
    offset = 0.0
    if tracer is not None and recorder is not None:
        offset = recorder.epoch - tracer.epoch
    if tracer is not None:
        events.append({"name": "process_name", "ph": "M", "pid": 0,
                       "tid": 0, "args": {"name": "host phases"}})
        events.extend(tracer.as_chrome_trace(pid=0, tid=0))
    if recorder is not None:
        events.append({"name": "process_name", "ph": "M", "pid": 1,
                       "tid": 0, "args": {"name": "requests"}})
        for lane, tl in enumerate(recorder.timelines()):
            d = tl.as_dict()
            if not d["events"]:
                continue
            t0 = d["events"][0]["t"] + offset
            t1 = d["events"][-1]["t"] + offset
            name = d["request_id"] or d["trace_id"]
            events.append({
                "name": f"request {name}", "ph": "X", "pid": 1,
                "tid": lane, "ts": t0 * 1e6,
                "dur": max((t1 - t0) * 1e6, 1.0), "cat": "request",
                "args": {"trace_id": d["trace_id"],
                         "request_id": d["request_id"]}})
            for ev in d["events"]:
                args = {k: v for k, v in ev.items()
                        if k not in ("t", "event")}
                args["trace_id"] = d["trace_id"]
                events.append({
                    "name": ev["event"], "ph": "i", "s": "t", "pid": 1,
                    "tid": lane, "ts": (ev["t"] + offset) * 1e6,
                    "cat": "request", "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer=None, recorder=None) -> dict:
    """Write :func:`chrome_trace` to ``path``; returns the document."""
    doc = chrome_trace(tracer=tracer, recorder=recorder)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc
