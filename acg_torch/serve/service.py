"""Per-request supervision over a Session + CoalescingQueue (the port of
``acg_tpu.serve.service``).

:class:`SolverService` is the request-facing face of the serve layer:
``submit(b)`` admits a right-hand side into the coalescing queue and
returns a :class:`Request`; ``request.response()`` yields a
:class:`ServeResponse` carrying

- the demuxed per-request :class:`~acg_torch.solvers.base.SolveResult`
  (or the failure classification),
- the **audit record**: one stats document a request, the port's one
  schema (``acg_torch/obs/export.py``, ``acg-torch-stats/1``, checked by
  its validator; the ``introspection`` members, ``resilience``,
  ``contract`` and ``fleet`` null), with the per-request ``session`` block (cache hit/miss counters, queue wait,
  batch occupancy, request and trace id) and the ``admission`` block
  (deadline budget, retries used, breaker state, shed/degraded flags):
  failed, shed and timed-out requests get one too;
- queue/batch metadata (wait, bucket, occupancy, whether the dispatch
  hit the resident-solve cache).

The **admission-robustness layer** (acg_torch/serve/admission.py) wraps
every request: per-request deadlines (in-queue expiry sheds with
``ERR_TIMEOUT``; ``response()`` is a classified terminal response at the
deadline, never an exception or a hang, with late results re-pollable
via :meth:`Request.repoll`), bounded seeded-backoff retries for
TRANSIENT failures, a per-``(solver, bucket, dtype)`` circuit breaker
with an audited OPEN/HALF_OPEN/CLOSED lifecycle, bounded-depth load
shedding (``ERR_OVERLOADED``), and graceful degradation of pipelined
traffic onto classic CG while its breaker is open.  All of it defaults
OFF: a default :class:`AdmissionPolicy` leaves the dispatched solves and
per-request results bit-identical to the plain serve layer.

Refused here, with ``ERR_NOT_SUPPORTED``: ``resilient=True`` (the
self-healing supervisor, ``robust/supervisor.py``), ``warm_start=True``
(the recycle state's donors), ``inject_fault`` (``robust/faults.py``)
and fleet membership (``replica_id``, ``fleet_meta``: ``serve/fleet.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.obs import metrics as _metrics
from acg_torch.obs.events import FlightRecorder, new_trace_id
from acg_torch.obs.export import build_stats_document, capability_info
from acg_torch.serve.admission import (HALF_OPEN, OPEN, AdmissionPolicy,
                                       AdmissionRecord, BreakerBoard,
                                       RollingWindow, classify_failure)
from acg_torch.serve.queue import CoalescingQueue, QueuePolicy, Ticket
from acg_torch.serve.session import Session, _normalize_solver
from acg_torch.solvers.base import SolveResult, SolveStats

# runtime telemetry (acg_torch/obs/metrics.py; no-ops until
# enable_metrics()): request outcomes and end-to-end latency, recorded
# host-side at response classification
_M_REQUESTS = _metrics.counter(
    "acg_serve_requests_total",
    "Classified request responses by outcome status", ("status",))
_M_E2E = _metrics.histogram(
    "acg_serve_request_seconds",
    "End-to-end request latency, submit to classified response")
_M_SHED = _metrics.counter(
    "acg_serve_shed_total", "Requests shed (admission or queue)")
_M_RETRIES = _metrics.counter(
    "acg_serve_retries_total", "Admission-layer retry attempts")
_M_DEGRADED = _metrics.counter(
    "acg_serve_degraded_total",
    "Requests served by the degradation ladder")
_M_TIMEOUTS = _metrics.counter(
    "acg_serve_timeouts_total", "Requests classified ERR_TIMEOUT")

# the per-request audit's metrics block, memoized: the snapshot is a
# PROCESS-global walk of every family (O(registry) dicts), identical
# across the requests of any instant — rebuilding it per classified
# response would tax the service exactly when it is busiest.  A short
# TTL keeps audits fresh without the per-request cost; the benign race
# (two threads rebuild, one wins) is harmless.
_SNAPSHOT_TTL_S = 0.25
_snapshot_cache = {"t": float("-inf"), "snap": None}


def _metrics_block() -> dict | None:
    """None when the registry is disabled (the default); else a
    recent-within-TTL ``MetricsRegistry.snapshot()``."""
    if not _metrics.metrics_enabled():
        return None
    now = time.monotonic()
    if _snapshot_cache["snap"] is None \
            or now - _snapshot_cache["t"] > _SNAPSHOT_TTL_S:
        _snapshot_cache["snap"] = _metrics.registry().snapshot()
        _snapshot_cache["t"] = now
    return _snapshot_cache["snap"]




@dataclasses.dataclass
class ServeResponse:
    """One request's complete outcome."""

    request_id: str
    ok: bool
    status: str
    result: object | None          # per-request SolveResult (or None)
    error: str | None
    audit: dict | None             # the audit document
    queue_wait: float
    batch_size: int                # real requests coalesced together
    bucket: int                    # padded batch size dispatched
    occupancy: float
    cache_hit: bool                # executable cache hit at dispatch
    wall: float                    # dispatch wall (shared by the batch)
    recovered: bool = False        # a resilient escalation rescued it
    shed: bool = False             # never dispatched (deadline/overload)
    degraded: bool = False         # served by the degradation ladder
    degraded_from: str | None = None   # the solver it degraded FROM
    retries: int = 0               # admission retries consumed

    def summary(self) -> dict:
        """The one-line JSON the CLI serve REPL prints per request."""
        r = self.result
        d = {
            "request": self.request_id, "ok": self.ok,
            "status": self.status,
            "iterations": None if r is None else int(r.niterations),
            "relative_residual": (None if r is None
                                  else float(r.relative_residual)),
            "batched": self.batch_size, "bucket": self.bucket,
            "queue_wait_ms": round(self.queue_wait * 1e3, 3),
            "cache_hit": self.cache_hit,
            "wall_ms": round(self.wall * 1e3, 3),
            "recovered": self.recovered,
        }
        # admission outcomes ride the line only when they happened, so
        # default-policy REPL output stays byte-compatible
        if self.shed:
            d["shed"] = True
        if self.degraded:
            d["degraded"] = True
            d["degraded_from"] = self.degraded_from
        if self.retries:
            d["retries"] = self.retries
        return d


class Request:
    """Handle for a submitted request (wraps the queue ticket).

    ``response(timeout)`` NEVER raises on expiry: a caller timeout or a
    deadline expiry yields a classified ``ERR_TIMEOUT``
    :class:`ServeResponse`.  A deadline expiry is terminal (cached); a
    bare caller timeout is provisional — calling ``response()`` again
    resumes waiting.  Either way the underlying ticket stays live, so a
    late batch completion is recoverable through :meth:`repoll` with no
    double-dispatch (the queue completes each ticket exactly once)."""

    def __init__(self, service: "SolverService", ticket: Ticket | None,
                 record: AdmissionRecord | None = None,
                 request_id: str | None = None,
                 response: ServeResponse | None = None):
        self._service = service
        self._ticket = ticket
        self._record = record
        self._rid = (request_id if request_id is not None
                     else ticket.request_id if ticket is not None
                     else None)
        self._response = response
        self._final = response is not None
        self._lock = threading.Lock()

    @property
    def request_id(self) -> str:
        return self._rid

    def response(self, timeout: float | None = None) -> ServeResponse:
        with self._lock:
            if not self._final:
                resp, final = self._service._finish_request(
                    self._ticket, timeout, self._record)
                self._response, self._final = resp, final
            return self._response

    def repoll(self) -> ServeResponse:
        """Late-result path: if the batch completed AFTER a terminal
        ``ERR_TIMEOUT`` response was issued, upgrade to the real
        outcome (the ticket was completed exactly once by its dispatch;
        this merely reads it)."""
        with self._lock:
            late = (self._final and self._response is not None
                    and self._response.status == "ERR_TIMEOUT"
                    and self._ticket is not None
                    and not self._ticket.shed and self._ticket.done)
            if late:
                # the terminal timeout was already counted in the
                # service stats/health window; this late read must not
                # count the same request twice
                resp, final = self._service._finish_request(
                    self._ticket, 0.0, self._record, count=False)
                if final:
                    self._response = resp
                return self._response
        return self.response(timeout=0.0)


class SolverService:
    """The admission front of one :class:`Session` (one operator, one
    solver configuration — requests differing only in their right-hand
    side coalesce; a different solver/options needs its own service).
    ``resilient``, ``warm_start`` and ``replica_id`` other than their
    defaults raise ``ERR_NOT_SUPPORTED`` (module docstring)."""

    def __init__(self, session: Session, *, solver: str = "cg",
                 options: SolverOptions | None = None,
                 max_batch: int = 8, max_wait_ms: float = 0.0,
                 buckets=(), resilient: bool = False,
                 admission: AdmissionPolicy | None = None,
                 flightrec_capacity: int = 256,
                 replica_id: str | None = None,
                 warm_start: bool = False):
        if resilient:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "resilient=True (solve_resilient, "
                           "robust/supervisor.py) is not ported")
        if warm_start:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "warm_start=True (the RecycleState's donors) is "
                           "not ported")
        if replica_id is not None:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "fleet membership (replica_id, serve/fleet.py) "
                           "is not ported")
        self.session = session
        # the flight recorder (acg_torch/obs/events.py): the last N
        # request timelines, bounded memory, always on — per-request
        # trace IDs are minted here at submit and cross-linked into the
        # audit documents (session/admission trace_id)
        self.flightrec = FlightRecorder(capacity=flightrec_capacity)
        # the capability matrix of the audit documents, probed once
        self._capabilities = None
        self.solver = _normalize_solver(solver)
        self.options = (options if options is not None
                        else session.default_options)
        self.admission = (admission if admission is not None
                          else AdmissionPolicy())
        self.queue = CoalescingQueue(
            self._dispatch,
            QueuePolicy(max_batch=max_batch,
                        max_wait=max_wait_ms / 1e3,
                        buckets=tuple(buckets)))
        self._ids = itertools.count()
        self._nfailed = 0
        self._nshed = 0
        self._ndegraded = 0
        self._nretries = 0
        self._ntimeouts = 0
        self._board = (BreakerBoard(self.admission)
                       if self.admission.breaker_threshold > 0 else None)
        self._rng = np.random.default_rng(self.admission.seed)
        self._window = RollingWindow(self.admission.window)

    def inject_fault(self, spec) -> None:
        """Fault injection: not ported (``robust/faults.py``)."""
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "inject_fault (robust/faults.py) is not ported")

    # -- dispatch (called by the queue, under its dispatch lock) --------

    def _route(self):
        """The dispatch-time breaker decision: ``(solver,
        degraded_from)`` — or ``(None, None)`` meaning fast-fail the
        batch with ERR_OVERLOADED (breaker open, no degradation
        available)."""
        if self._board is None:
            return self.solver, None
        admit, state, sig = self._board.admit(self.solver,
                                              self.session.dtype)
        if admit:
            return self.solver, None
        if self.admission.degrade and self.solver != "cg":
            ok2, _, _ = self._board.admit("cg", self.session.dtype)
            if ok2:
                return "cg", self.solver
        return None, None

    def _dispatch(self, bb, x0=None):
        nrhs = bb.shape[0] if bb.ndim == 2 else 1
        solver, degraded_from = self._route()
        meta = {"solver": solver, "degraded_from": degraded_from}
        if solver is None:
            e = AcgError(Status.ERR_OVERLOADED,
                         "circuit breaker open: request fast-failed at "
                         "dispatch (no degradation target)")
            e.dispatch_meta = meta
            raise e
        meta["cache_hit"] = self.session.has_executable(
            solver, nrhs, self.options, has_x0=x0 is not None)
        ok = False
        try:
            res = self.session.solve(bb, solver=solver,
                                     options=self.options, x0=x0)
            ok = bool(res.converged)
            return res, meta
        except AcgError as e:
            e.dispatch_meta = meta
            raise
        finally:
            if self._board is not None:
                self._board.record(solver, nrhs, self.session.dtype, ok)

    # -- submission -----------------------------------------------------

    def submit(self, b, request_id: str | None = None, *,
               x0=None, trace_id: str | None = None,
               fleet_meta: dict | None = None) -> Request:
        """Admit one right-hand side.  ``x0`` is an optional client
        initial guess (it rides the coalesced batch as an operand and
        only ever changes iteration counts, never the certified
        answer).  ``trace_id`` pins the request's trace ID instead of
        minting a fresh one.  ``fleet_meta`` (failover provenance)
        raises ``ERR_NOT_SUPPORTED``."""
        if fleet_meta is not None:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "fleet_meta (serve/fleet.py failover) is not "
                           "ported")
        b = np.asarray(b)
        if b.ndim != 1:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "submit() admits ONE right-hand side per "
                           "request (the queue builds the batch)")
        if b.shape[0] != self.session.nrows:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"right-hand side has {b.shape[0]} entries, "
                           f"operator has {self.session.nrows} rows")
        if not np.all(np.isfinite(b)):
            # reject the poison at the door: a NaN/Inf RHS would ride
            # the coalesced batch into the SHARED device loop and
            # contaminate every batch-mate's reductions
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "right-hand side contains non-finite values "
                           "(rejected at admission: a NaN/Inf system "
                           "would poison its coalesced batch-mates)")
        x0_meta = None
        if x0 is not None:
            x0 = np.asarray(x0)
            if x0.shape != b.shape:
                raise AcgError(Status.ERR_INVALID_VALUE,
                               f"x0 shape {x0.shape} does not match the "
                               f"right-hand side {b.shape}")
            if not np.all(np.isfinite(x0)):
                raise AcgError(Status.ERR_INVALID_VALUE,
                               "x0 contains non-finite values (rejected "
                               "at admission: a NaN/Inf guess would "
                               "poison its coalesced batch-mates)")
            x0_meta = {"source": "client", "sketch_distance": None}
        if request_id is None:
            request_id = f"req-{next(self._ids)}"
        self.session.counters["requests"] += 1
        pol = self.admission
        now = time.perf_counter()
        # per-request trace: one ID for the whole submit -> coalesce ->
        # dispatch -> demux -> response path, one flight-recorder
        # timeline
        trace = self.flightrec.begin(
            request_id, trace_id if trace_id is not None
            else new_trace_id())
        rec = AdmissionRecord(
            policy=pol, admitted_at=now, trace_id=trace.trace_id,
            deadline_s=(None if pol.deadline_s is None
                        else now + pol.deadline_s),
            queue_deadline_s=(None if pol.queue_deadline_s is None
                              else now + pol.queue_deadline_s))
        # load shedding: a bounded backlog rejects NOW instead of
        # queueing work whose deadline will have died of old age
        if pol.max_queue_depth > 0 \
                and self.queue.depth >= pol.max_queue_depth:
            return self._preset(request_id, b, rec, Status.ERR_OVERLOADED,
                                f"queue depth {self.queue.depth} >= "
                                f"bound {pol.max_queue_depth} "
                                "(request shed at admission)",
                                trace=trace)
        if self._board is not None:
            admit, state, sig = self._board.peek(self.solver,
                                                 self.session.dtype)
            rec.breaker_state = state
            rec.breaker_signature = sig
            if not admit and not (pol.degrade and self.solver != "cg"):
                return self._preset(
                    request_id, b, rec, Status.ERR_OVERLOADED,
                    f"circuit breaker {state} for {sig} "
                    "(fast-fail; no degradation target)", trace=trace)
        try:
            ticket = self.queue.submit(
                b, request_id, queue_deadline=rec.queue_deadline_s,
                trace=trace, x0=x0, x0_meta=x0_meta)
        except AcgError as e:
            if e.status == Status.ERR_OVERLOADED:
                # closed queue (drain/shutdown): a classified terminal
                # response, like any other admission refusal
                return self._preset(request_id, b, rec,
                                    Status.ERR_OVERLOADED, str(e),
                                    trace=trace)
            raise
        return Request(self, ticket, rec)

    def _preset(self, request_id: str, b, rec: AdmissionRecord,
                status: Status, msg: str, trace=None) -> Request:
        """A request refused at admission: a complete, classified,
        audit-carrying terminal response without ever touching the
        queue."""
        rec.shed = True
        self._nshed += 1
        self._nfailed += 1
        self._window.record(False)      # failure; no latency sample
        if trace is not None:
            trace.event("shed", status=status.name, where="admission")
            trace.event("response", status=status.name, ok=False)
        _M_REQUESTS.labels(status=status.name).inc()
        _M_SHED.inc()
        audit = self._stub_audit(b, request_id, status, rec,
                                 trace_id=rec.trace_id)
        resp = ServeResponse(
            request_id=request_id, ok=False, status=status.name,
            result=None, error=msg, audit=audit, queue_wait=0.0,
            batch_size=0, bucket=0, occupancy=0.0, cache_hit=False,
            wall=0.0, shed=True, retries=0)
        return Request(self, None, rec, request_id=request_id,
                       response=resp)

    def solve(self, b, request_id: str | None = None,
              timeout: float | None = None) -> ServeResponse:
        """Synchronous convenience: submit + wait."""
        return self.submit(b, request_id).response(timeout)

    def flush(self) -> None:
        self.queue.flush()

    def close(self, drain: bool = True,
              shed_status: Status = Status.ERR_OVERLOADED) -> None:
        """Graceful shutdown (idempotent): the queue rejects new
        submits with classified ``ERR_OVERLOADED`` responses, the
        backlog is deterministically drained (``drain=True``) or shed
        with ``shed_status``, and every waiter wakes with a terminal
        outcome.  The session is NOT closed here — it may back other
        services."""
        self.queue.close(drain=drain, shed_status=shed_status)

    # -- response assembly ----------------------------------------------

    def _finish_request(self, ticket: Ticket, timeout,
                        record: AdmissionRecord | None,
                        count: bool = True
                        ) -> tuple[ServeResponse, bool]:
        """Wait, classify, retry, audit.  ``count=False`` is the repoll
        path: the request was already counted into the failure/shed/
        window stats when its terminal timeout was issued."""
        rec = (record if record is not None
               else AdmissionRecord(policy=self.admission))
        # the caller's timeout never waits past the request deadline
        eff = timeout
        rem = rec.remaining_s()
        if rem is not None:
            eff = rem if eff is None else min(eff, rem)
        res, err = None, None
        try:
            res = ticket.result(None if eff is None
                                else max(eff, 0.0))
        except TimeoutError:
            rem = rec.remaining_s()
            if rem is None or rem > 0:
                # bare caller timeout: provisional — response() again
                # resumes the wait, the ticket stays completable
                return self._timeout_response(ticket, rec,
                                              terminal=False), False
            # deadline expired: shed from the queue if still pending
            rec.expired = True
            if not ticket.done:
                self.queue.cancel(ticket, AcgError(
                    Status.ERR_TIMEOUT,
                    f"deadline ({self.admission.deadline_ms:.0f} ms) "
                    "expired before a result was produced"))
            if not ticket.done:
                # dispatched but unfinished: the device work cannot be
                # preempted — classify NOW (the client contract), leave
                # the late result re-pollable; no latency samples
                if count:
                    self._ntimeouts += 1
                    self._nfailed += 1
                    self._window.record(False)
                    _M_REQUESTS.labels(status="ERR_TIMEOUT").inc()
                    _M_TIMEOUTS.inc()
                    _M_E2E.observe(time.perf_counter()
                                   - ticket.enqueue_t)
                if ticket.trace is not None:
                    ticket.trace.event("response", status="ERR_TIMEOUT",
                                       ok=False, terminal=True)
                return self._timeout_response(ticket, rec,
                                              terminal=True), True
            try:
                res = ticket.result(0.0)
            except AcgError as e:
                err = e
                res = getattr(e, "result", None)
        except AcgError as e:
            err = e
            res = getattr(e, "result", None)
        # the authoritative per-dispatch bit, recorded by _dispatch
        # BEFORE the solve (a cold signature builds its state = a miss)
        exec_hit = bool(ticket.dispatch_meta.get("cache_hit", False))
        solver_used = ticket.dispatch_meta.get("solver", self.solver)
        rec.degraded_from = ticket.dispatch_meta.get("degraded_from")
        rec.degraded = rec.degraded_from is not None
        if ticket.shed or (err is not None and getattr(err, "status",
                           None) == Status.ERR_OVERLOADED):
            rec.shed = True
        if err is not None and getattr(err, "status", None) \
                == Status.ERR_TIMEOUT:
            rec.expired = True
        # bounded retry: transient failures re-run ALONE with seeded
        # backoff (deterministic failures fall straight through)
        if err is not None and self._can_retry(err):
            res, err = self._retry(ticket, res, err, rec,
                                   solver_used or self.solver)
        ok = err is None and res is not None and bool(res.converged)
        ws = getattr(ticket, "x0_meta", None)
        warmstart = None
        if count and ws is not None:
            # a client x0 is provenance only: nothing donated, nothing
            # to certify or reject
            warmstart = {"enabled": False, "source": ws.get("source"),
                         "sketch_distance": ws.get("sketch_distance"),
                         "iterations_saved": None, "rejected": False}
        if count:
            if not ok:
                self._nfailed += 1
            if rec.shed:
                self._nshed += 1
            if rec.degraded:
                self._ndegraded += 1
            if err is not None and getattr(err, "status", None) \
                    == Status.ERR_TIMEOUT:
                self._ntimeouts += 1
            # latency samples only for requests that actually RAN
            ran = bool(ticket.bucket) and not rec.shed
            self._window.record(
                ok,
                ticket.queue_wait if ran else None,
                ticket.dispatch_wall if ran else None)
        status = (getattr(getattr(res, "status", None), "name", None)
                  or (err.status.name if err is not None
                      and hasattr(err, "status") else "SUCCESS"))
        if ticket.trace is not None:
            ticket.trace.event("response", status=status, ok=ok)
        if count:
            _M_REQUESTS.labels(status=status).inc()
            _M_E2E.observe(time.perf_counter() - ticket.enqueue_t)
            if rec.shed:
                _M_SHED.inc()
            if rec.degraded:
                _M_DEGRADED.inc()
            if status == "ERR_TIMEOUT":
                _M_TIMEOUTS.inc()
        audit = self._audit_document(ticket, res, exec_hit, rec, status,
                                     solver=solver_used or self.solver,
                                     warmstart=warmstart)
        return ServeResponse(
            request_id=ticket.request_id, ok=ok, status=status,
            result=res, error=None if err is None else str(err),
            audit=audit, queue_wait=ticket.queue_wait,
            batch_size=ticket.batch_size, bucket=ticket.bucket,
            occupancy=ticket.occupancy, cache_hit=exec_hit,
            wall=ticket.dispatch_wall, shed=rec.shed,
            degraded=rec.degraded, degraded_from=rec.degraded_from,
            retries=rec.retries_used), True

    def _timeout_response(self, ticket: Ticket, rec: AdmissionRecord,
                          terminal: bool) -> ServeResponse:
        """Classified ERR_TIMEOUT response, with its stub audit."""
        wait = time.perf_counter() - ticket.enqueue_t \
            if not ticket.done else ticket.queue_wait
        audit = self._stub_audit(ticket.b, ticket.request_id,
                                 Status.ERR_TIMEOUT, rec)
        kind = ("deadline expired" if terminal
                else "response(timeout) elapsed (provisional; call "
                     "response() again to resume waiting)")
        return ServeResponse(
            request_id=ticket.request_id, ok=False,
            status=Status.ERR_TIMEOUT.name, result=None,
            error=f"request timed out: {kind}", audit=audit,
            queue_wait=wait, batch_size=ticket.batch_size,
            bucket=ticket.bucket, occupancy=ticket.occupancy,
            cache_hit=False, wall=ticket.dispatch_wall,
            retries=rec.retries_used)

    def _can_retry(self, err) -> bool:
        return (self.admission.max_retries > 0
                and hasattr(err, "status")
                and classify_failure(err.status) == "transient")

    def _retry(self, ticket: Ticket, res, err, rec: AdmissionRecord,
               solver: str):
        """Bounded seeded-backoff retry of a TRANSIENT failure: the
        request re-runs ALONE (bucket-1 signature) against the warm
        session, up to ``max_retries`` times within its deadline."""
        for attempt in range(1, self.admission.max_retries + 1):
            delay = self.admission.backoff_s(attempt, self._rng)
            rem = rec.remaining_s()
            if rem is not None and rem <= delay:
                rec.expired = rem <= 0
                break       # no deadline budget for another attempt
            if delay > 0:
                time.sleep(delay)
            rec.retries_used = attempt
            rec.backoffs_ms.append(delay * 1e3)
            self._nretries += 1
            _M_RETRIES.inc()
            if ticket.trace is not None:
                ticket.trace.event("retry", attempt=attempt,
                                   backoff_ms=round(delay * 1e3, 3))
            ok = False
            try:
                with self.session.tracer.span("retry"):
                    res2 = self.session.solve(
                        ticket.b, solver=solver, options=self.options,
                        x0=getattr(ticket, "x0", None))
                ok = bool(res2.converged)
                if ok:
                    res, err = res2, None
                else:
                    res, err = res2, AcgError(res2.status)
            except AcgError as e2:
                res = getattr(e2, "result", res)
                err = e2
            finally:
                if self._board is not None:
                    self._board.record(solver, 1, self.session.dtype,
                                       ok)
            if err is None \
                    or classify_failure(err.status) != "transient":
                break
        return res, err

    # -- audit documents ------------------------------------------------

    def _admission_block(self, rec: AdmissionRecord) -> dict:
        trips = 0
        if self._board is not None:
            if rec.breaker_signature is not None:
                st = self._board.states().get(rec.breaker_signature)
                trips = st["trips"] if st else self._board.trips
            else:
                trips = self._board.trips
        return rec.as_dict(trips=trips)

    def _stub_result(self, b, status: Status) -> SolveResult:
        """A zero-work SolveResult for requests that never produced one
        (shed, overloaded, timed out): nothing ran, and the audit says
        exactly that."""
        bnrm = float(np.linalg.norm(np.asarray(b, np.float64)))
        return SolveResult(
            x=np.zeros(0), converged=False, niterations=0, bnrm2=bnrm,
            r0nrm2=bnrm, rnrm2=bnrm, stats=SolveStats(),
            status=status, residual_history=None)

    def _stub_audit(self, b, request_id: str, status: Status,
                    rec: AdmissionRecord,
                    trace_id: str | None = None) -> dict:
        stub = self._stub_result(b, status)
        t = _StubTicket(request_id, trace_id=(trace_id if trace_id
                                              is not None
                                              else rec.trace_id))
        return self._document(self.solver, stub, self.session_block(
            t, False), self._admission_block(rec))

    def _audit_document(self, ticket: Ticket, res, exec_hit: bool,
                        rec: AdmissionRecord, status: str,
                        solver: str | None = None,
                        warmstart: dict | None = None) -> dict:
        """The per-request audit record, for every response — success,
        failure, shed and timeout alike.  ``solver`` is the solver that
        actually RAN the dispatch (the degradation ladder may have routed
        a pipelined request onto classic CG — the document says so)."""
        if res is None or res.stats is None:
            res = self._stub_result(
                ticket.b, getattr(Status, status, Status.ERR_TIMEOUT))
        return self._document(
            solver if solver is not None else self.solver, res,
            self.session_block(ticket, exec_hit),
            self._admission_block(rec), warmstart)

    def _document(self, solver: str, res, session: dict, admission: dict,
                  warmstart: dict | None = None) -> dict:
        """One audit document (``obs/export.build_stats_document``)."""
        if self._capabilities is None:
            self._capabilities = capability_info()
        return build_stats_document(
            solver=solver, options=self.options, res=res, stats=res.stats,
            nunknowns=self.session.nrows, nparts=self.session.nparts,
            phases=self.session.tracer.as_dicts(),
            capabilities=self._capabilities, session=session,
            admission=admission, metrics=_metrics_block(),
            warmstart=warmstart)

    def session_block(self, ticket, exec_hit: bool) -> dict:
        """The audit's ``session`` block for one request (with the
        ``trace_id`` cross-link into the flight-recorder timeline)."""
        c = self.session.counters
        tr = getattr(ticket, "trace", None)
        return {
            "request_id": str(ticket.request_id),
            "trace_id": (tr.trace_id if tr is not None
                         else getattr(ticket, "trace_id", None)),
            "cache": {
                "executable_hit": bool(exec_hit),
                "executable": {
                    "hits": int(c["executable"]["hits"]),
                    "misses": int(c["executable"]["misses"]),
                },
                "prepared": {
                    "hits": int(c["prepared"]["hits"]),
                    "misses": int(c["prepared"]["misses"]),
                },
            },
            "queue": {
                # instantaneous backlog the dispatch left behind
                "wait_seconds": float(ticket.queue_wait),
                "depth": int(ticket.depth_at_dispatch),
            },
            "batch": {
                "size": int(max(ticket.batch_size, 1)),
                "bucket": int(max(ticket.bucket, 1)),
                "occupancy": float(ticket.occupancy),
            },
        }

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        """Merged session + queue + admission counters (the ``stats``
        REPL command reads this; the JAX package's keys)."""
        return {"session": self.session.stats(),
                "queue": self.queue.stats(),
                "requests_failed": self._nfailed,
                "requests_recovered": 0,
                "admission": {
                    "shed": self._nshed,
                    "degraded": self._ndegraded,
                    "retries": self._nretries,
                    "timeouts": self._ntimeouts,
                    "breaker_trips": (0 if self._board is None
                                      else self._board.trips),
                },
                "warmstart": {
                    "enabled": False,
                    "served": 0,
                    "rejected": 0,
                }}

    def health(self) -> dict:
        """The serving health snapshot (the REPL ``health`` command):
        rolling-window failure rate and p50/p99 queue-wait / dispatch-
        wall percentiles, per-signature breaker states, backlog depth,
        cumulative admission counters.  The top-level ``status``
        collapses it to one word: ``overloaded`` (some breaker OPEN),
        ``degraded`` (a breaker half-open, or failures in the window),
        else ``ok``."""
        w = self._window.summary()
        states = {} if self._board is None else self._board.states()
        any_open = any(v["state"] == OPEN for v in states.values())
        any_half = any(v["state"] == HALF_OPEN
                       for v in states.values())
        fr = w["failure_rate"] or 0.0
        status = ("overloaded" if any_open
                  else "degraded" if (any_half or fr > 0) else "ok")
        sld = self.queue.since_last_dispatch()
        return {
            "status": status,
            "ready": (not self.queue.closed
                      and not self.session.dead),
            "inflight": int(self.queue.inflight),
            "since_last_dispatch_s": (None if sld is None
                                      else float(sld)),
            "depth": int(self.queue.depth),
            "window": w,
            "breakers": states,
            "breaker_transitions": (
                [] if self._board is None
                else list(self._board.transitions)),
            "requests": int(self.session.counters["requests"]),
            "failed": int(self._nfailed),
            "shed": int(self._nshed),
            "degraded": int(self._ndegraded),
            "retries": int(self._nretries),
            "timeouts": int(self._ntimeouts),
            "recovered": 0,
        }


class _StubTicket:
    """Session-block shape for a request that never had a queue ticket
    (refused at admission)."""

    def __init__(self, request_id: str, trace_id: str | None = None):
        self.request_id = request_id
        self.trace_id = trace_id
        self.trace = None
        self.queue_wait = 0.0
        self.depth_at_dispatch = 0
        self.batch_size = 0
        self.bucket = 0
        self.occupancy = 0.0
