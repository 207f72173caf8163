"""Admission queue: coalesce concurrent right-hand sides into one batch
(the port of ``acg_tpu.serve.queue``).

A (B, n) multi-RHS solve reads the operator once an iteration for all B
systems (the batched SpMV kernels, ``cuda-*-batched``); the way
production traffic actually acquires a B is an admission queue.
:class:`CoalescingQueue` implements the max-wait / max-batch policy:

- requests accumulate until either ``max_batch`` are pending (the
  submitting thread dispatches immediately) or the OLDEST request has
  waited ``max_wait`` seconds (the first waiter dispatches whatever is
  queued);
- the batch is padded up to a **bucket** size (default powers of two) by
  replicating the last request's b, bounding the resident-solve cache
  to ``len(buckets)`` signatures per solver kind — padding is cheap
  because a padded system is a duplicate of a real one (same
  trajectory, frozen on convergence), never a zero system (a zero RHS
  hits the p'Ap breakdown guard);
- per-request results demux from the batched ``SolveResult``'s
  per-system arrays (iterations/rnrm2/converged/history map 1:1 to
  requests).  Because the batched loop advances systems INDEPENDENTLY
  (per-system reductions, per-system convergence masks, carries frozen
  after each system's own exit), a request's demuxed result is
  bit-identical whatever else rode in its batch.

The queue is transport-agnostic: ``dispatch`` is any callable
``b_batch -> SolveResult`` (the service layer binds it to
``Session.solve``).  Dispatch runs under one lock — one device program
at a time, on the thread that dispatches; waiting threads block on the
condition variable and touch no device.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from acg_torch.errors import AcgError, Status
from acg_torch.obs import metrics as _metrics
from acg_torch.solvers.base import SolveResult, SolveStats

# runtime telemetry (acg_torch/obs/metrics.py; no-ops until
# enable_metrics()).  All host-side, all around the unchanged dispatch.
_M_DEPTH = _metrics.gauge(
    "acg_serve_queue_depth", "Pending requests in the coalescing queue")
_M_WAIT = _metrics.histogram(
    "acg_serve_queue_wait_seconds",
    "Per-request wait from submit to dispatch (dispatched only)")
_M_OCCUPANCY = _metrics.histogram(
    "acg_serve_batch_occupancy",
    "Real requests / padded bucket size per dispatched batch",
    buckets=_metrics.RATIO_BUCKETS)
_M_BATCHES = _metrics.counter(
    "acg_serve_batches_total", "Dispatched batches", ("bucket",))
_M_QSHED = _metrics.counter(
    "acg_serve_queue_shed_total",
    "Tickets shed from the queue before dispatch (deadline/cancel)")


@dataclasses.dataclass(frozen=True)
class QueuePolicy:
    """Coalescing knobs: ``max_batch`` caps one dispatch; ``max_wait``
    (seconds) bounds the oldest request's queue latency; ``buckets``
    are the admitted padded batch sizes (ascending; the largest must
    cover ``max_batch``)."""

    max_batch: int = 8
    max_wait: float = 0.0
    buckets: tuple = ()

    def __post_init__(self):
        if self.max_batch < 1:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "max_batch must be >= 1")
        if self.max_wait < 0:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "max_wait must be >= 0")
        buckets = self.buckets
        if not buckets:
            # powers of two up to max_batch (always including max_batch)
            buckets, bsz = [], 1
            while bsz < self.max_batch:
                buckets.append(bsz)
                bsz *= 2
            buckets.append(self.max_batch)
        buckets = tuple(sorted(set(int(v) for v in buckets)))
        if buckets[0] < 1 or buckets[-1] < self.max_batch:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"buckets {buckets} must be >= 1 and cover "
                           f"max_batch={self.max_batch}")
        object.__setattr__(self, "buckets", buckets)

    def bucket_for(self, nreal: int) -> int:
        """Smallest admitted batch size >= nreal."""
        for bsz in self.buckets:
            if bsz >= nreal:
                return bsz
        return self.buckets[-1]


class Ticket:
    """One admitted request: ``result()`` blocks until its batch has
    been dispatched (participating in the max-wait policy), then
    returns the demuxed per-request :class:`SolveResult` or raises the
    per-request :class:`AcgError` (with the partial result attached,
    exactly like the plain solvers)."""

    def __init__(self, queue: "CoalescingQueue", b, request_id,
                 queue_deadline: float | None = None, trace=None,
                 x0=None, x0_meta: dict | None = None):
        self._queue = queue
        self.b = np.asarray(b)
        # optional initial guess: rides the batch as an x0 operand; absent-x0 batch-mates pad with the
        # zero vector — exactly the donor a no-x0 solve starts from,
        # so coalescing stays bit-identical to sequential submission.
        # ``x0_meta`` is provenance for the audit's warmstart block
        # (donor source + sketch distance), None for a plain request.
        self.x0 = None if x0 is None else np.asarray(x0)
        self.x0_meta = x0_meta
        self.request_id = request_id
        # per-request event timeline (acg_torch/obs/events.py
        # RequestTimeline) threaded by the service layer; None for bare
        # queue users — every hook below is a None-check no-op then
        self.trace = trace
        self.enqueue_t = time.perf_counter()
        self.done = False
        self.result_value: SolveResult | None = None
        self.error: AcgError | None = None
        # admission layer (acg_torch/serve/admission.py): the absolute
        # perf_counter time after which this ticket may no longer be
        # DISPATCHED — an expired ticket is shed from the queue with a
        # classified ERR_TIMEOUT instead of riding a batch whose result
        # its client has already abandoned.  None = no queue deadline.
        self.queue_deadline = queue_deadline
        self.shed = False           # completed by shedding, not dispatch
        # batch metadata, filled at dispatch (the audit's session
        # block's queue/batch fields)
        self.queue_wait = 0.0
        self.batch_size = 0         # real requests in the batch
        self.bucket = 0             # padded batch size dispatched
        self.dispatch_wall = 0.0
        self.index = -1             # this request's system index
        self.depth_at_dispatch = 0  # backlog left behind at dispatch
        self.dispatch_meta: dict = {}   # dispatcher-provided metadata

    def result(self, timeout: float | None = None) -> SolveResult:
        self._queue._await(self, timeout)
        if self.error is not None:
            raise self.error
        return self.result_value

    @property
    def occupancy(self) -> float:
        return self.batch_size / self.bucket if self.bucket else 0.0


def demux_result(res: SolveResult, i: int, bnrm2: float) -> SolveResult:
    """System ``i`` of a batched result as a standalone single-system
    :class:`SolveResult` — the response a sequentially-submitted request
    would have received (bit-identical: the batched loop advances
    systems independently)."""
    if res.nrhs == 1:
        return res
    iters = int(res.iterations_per_system[i])
    hist = res.residual_history
    if hist is not None:
        hist = np.asarray(hist[i][: iters + 1], dtype=np.float64)
    x = np.asarray(res.x)[i]
    converged = bool(res.converged_per_system[i])
    rnrm2 = float(res.rnrm2_per_system[i])
    r0nrm2 = (float(res.r0nrm2_per_system[i])
              if res.r0nrm2_per_system is not None else res.r0nrm2)
    st = SolveStats(nsolves=1, ntotaliterations=iters, niterations=iters,
                    tsolve=(res.stats.tsolve if res.stats is not None
                            else 0.0))
    if res.stats is not None and res.stats.niterations > 0:
        # flops pro-rated by this system's share of the batch total
        st.nflops = res.stats.nflops * iters // max(
            int(np.sum(res.iterations_per_system)), 1)
    out = SolveResult(
        x=x, converged=converged, niterations=iters, bnrm2=float(bnrm2),
        r0nrm2=r0nrm2, rnrm2=rnrm2, stats=st,
        fpexcept=("none" if np.all(np.isfinite(x)) and np.isfinite(rnrm2)
                  else "non-finite values in solution or residual"),
        operator_format=res.operator_format, kernel=res.kernel,
        kernel_note=res.kernel_note, residual_history=hist, nrhs=1)
    # status: a converged system is a SUCCESS even when a batch-mate
    # failed; a non-converged one inherits the batch classification
    # (fault/breakdown/non-convergence) — honest per-request outcomes
    out.status = res.status if not converged else type(res.status).SUCCESS
    return out


class CoalescingQueue:
    """See module docstring.  ``dispatch`` is called with a 1-D ``(n,)``
    b for a bucket-1 batch (the bit-for-bit legacy path) or a stacked
    ``(bucket, n)`` batch otherwise."""

    def __init__(self, dispatch, policy: QueuePolicy = QueuePolicy()):
        self._dispatch = dispatch
        self.policy = policy
        self._cv = threading.Condition()
        self._dispatch_lock = threading.Lock()
        self._pending: list[Ticket] = []
        self._closed = False
        # live un-demuxed tickets (submitted, not yet completed or
        # shed) and the wall clock of the most recent dispatch — the
        # health fields
        self._inflight = 0
        self._last_dispatch_t: float | None = None
        self.counters = {"submitted": 0, "batches": 0, "padded": 0,
                         "shed": 0, "max_depth": 0, "total_wait": 0.0,
                         "total_occupancy": 0.0}

    # -- submission -----------------------------------------------------

    def submit(self, b, request_id=None,
               queue_deadline: float | None = None, trace=None,
               x0=None, x0_meta: dict | None = None) -> Ticket:
        t = Ticket(self, b, request_id, queue_deadline=queue_deadline,
                   trace=trace, x0=x0, x0_meta=x0_meta)
        drain = False
        with self._cv:
            if self._closed:
                # the close() contract: a closed queue REJECTS instead
                # of accepting work its dispatcher will never run —
                # classified, like any other admission refusal
                raise AcgError(
                    Status.ERR_OVERLOADED,
                    "queue is closed (draining/shut down); request "
                    "rejected at admission")
            self._pending.append(t)
            self.counters["submitted"] += 1
            self._inflight += 1
            self.counters["max_depth"] = max(self.counters["max_depth"],
                                             len(self._pending))
            _M_DEPTH.set(len(self._pending))
            drain = len(self._pending) >= self.policy.max_batch
            self._cv.notify_all()
        if drain:
            self._drain()
        return t

    def flush(self) -> None:
        """Dispatch everything pending now (batch-file / shutdown)."""
        self._drain()

    def close(self, drain: bool = True,
              shed_status: Status = Status.ERR_OVERLOADED) -> None:
        """Idempotent shutdown: reject new submits (``ERR_OVERLOADED``),
        then deterministically settle the backlog — ``drain=True``
        dispatches every pending ticket now, ``drain=False`` sheds it
        with a classified ``shed_status`` (``ERR_OVERLOADED`` for a
        graceful shutdown) — and wake every waiter.  The queue owns no threads
        (dispatch runs on submitter/waiter threads), so after the
        backlog settles there is nothing left to join: no ticket can be
        pending, no waiter can be asleep on one."""
        with self._cv:
            if self._closed and not self._pending:
                return
            self._closed = True
            if not drain:
                shed = list(self._pending)
                self._pending.clear()
                for t in shed:
                    self._shed_one(t, AcgError(
                        shed_status,
                        "queue closed before dispatch (backlog shed at "
                        "shutdown)"))
                _M_DEPTH.set(0)
            self._cv.notify_all()
        if drain:
            self._drain()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def inflight(self) -> int:
        """Live tickets: submitted and not yet demuxed/shed — the
        pending backlog PLUS anything currently riding a dispatch."""
        with self._cv:
            return self._inflight

    def since_last_dispatch(self) -> float | None:
        """Seconds since the most recent dispatch returned (None before
        the first one) — a stalled dispatcher shows up here long before
        a failure-rate window moves."""
        t = self._last_dispatch_t
        return None if t is None else time.perf_counter() - t

    # -- dispatch -------------------------------------------------------

    def _await(self, ticket: Ticket, timeout: float | None) -> None:
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            with self._cv:
                if ticket.done:
                    return
                now = time.perf_counter()
                # the max-wait policy: this waiter sleeps until the
                # ticket's admission window closes, collecting batch-
                # mates; then it becomes the dispatcher.  A queue
                # deadline closes the window early so the waiter wakes
                # exactly when its own shed is due (no leaked waiter
                # sleeping past its deadline).
                window = ticket.enqueue_t + self.policy.max_wait - now
                if ticket.queue_deadline is not None:
                    window = min(window, ticket.queue_deadline - now)
                if window > 0:
                    if deadline is not None:
                        window = min(window, deadline - now)
                        if window <= 0:
                            raise TimeoutError("queue wait timed out")
                    self._cv.wait(window)
                    continue
            # window closed: become the dispatcher — but NEVER block on
            # the dispatch lock past the caller's own deadline (another
            # thread mid-dispatch may hold it for a whole solve; the
            # timed-out caller must get its classified response, the
            # in-flight dispatch completes the ticket regardless)
            if deadline is None:
                self._drain()
            else:
                remaining = deadline - time.perf_counter()
                if remaining <= 0 \
                        or not self._dispatch_lock.acquire(
                            timeout=remaining):
                    raise TimeoutError("queue wait timed out")
                try:
                    if time.perf_counter() < deadline:
                        self._drain_locked()
                finally:
                    self._dispatch_lock.release()
            with self._cv:
                if ticket.done:
                    return
                if deadline is not None \
                        and time.perf_counter() >= deadline:
                    raise TimeoutError("queue wait timed out")
                # another thread is mid-dispatch with our ticket aboard:
                # wait for its completion broadcast
                self._cv.wait(0.05)

    def _shed_expired_locked(self) -> list[Ticket]:
        """Remove pending tickets whose queue deadline has passed
        (caller holds ``_cv``); returns them, still incomplete."""
        now = time.perf_counter()
        expired = [t for t in self._pending
                   if t.queue_deadline is not None
                   and now >= t.queue_deadline]
        if expired:
            self._pending = [t for t in self._pending
                             if t not in expired]
        return expired

    def _shed_one(self, t: Ticket, error: AcgError | None) -> None:
        """The ONE owner of shed-ticket completion (deadline expiry in
        _drain and request-layer cancel share it): classified error,
        shed flag, wait bookkeeping, counter.  The ticket terminates —
        no lost waiters — and the request layer turns the error into a
        terminal audit-carrying response."""
        t.shed = True
        t.queue_wait = time.perf_counter() - t.enqueue_t
        t.error = error if error is not None else AcgError(
            Status.ERR_TIMEOUT,
            f"queue deadline expired after "
            f"{t.queue_wait * 1e3:.1f} ms before dispatch "
            "(request shed from the admission queue)")
        t.done = True
        self.counters["shed"] += 1
        self._inflight -= 1
        _M_QSHED.inc()
        if t.trace is not None:
            t.trace.event("shed", status=t.error.status.name,
                          queue_wait_ms=round(t.queue_wait * 1e3, 3))

    def _complete_shed(self, tickets: list[Ticket]) -> None:
        for t in tickets:
            self._shed_one(t, None)

    def cancel(self, ticket: Ticket, error: AcgError) -> bool:
        """Complete a STILL-PENDING ticket with ``error`` (deadline
        enforcement from the request layer).  False if the ticket was
        already dispatched or done — the race loser; the dispatch's
        own completion stands, so there is never a double completion."""
        with self._cv:
            if ticket.done or ticket not in self._pending:
                return False
            self._pending.remove(ticket)
            _M_DEPTH.set(len(self._pending))
            self._shed_one(ticket, error)
            self._cv.notify_all()
            return True

    def _drain(self) -> None:
        with self._dispatch_lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        """Dispatch everything pending (caller holds ``_dispatch_lock``)."""
        while True:
            with self._cv:
                shed = self._shed_expired_locked()
                if shed:
                    self._complete_shed(shed)
                    _M_DEPTH.set(len(self._pending))
                    self._cv.notify_all()
                if not self._pending:
                    return
                batch = self._pending[: self.policy.max_batch]
                del self._pending[: len(batch)]
                left_behind = len(self._pending)
                _M_DEPTH.set(left_behind)
            self._run_batch(batch, left_behind)
            with self._cv:
                self._cv.notify_all()

    def _run_batch(self, batch: list[Ticket],
                   left_behind: int = 0) -> None:
        nreal = len(batch)
        bucket = self.policy.bucket_for(nreal)
        npad = bucket - nreal
        # initial guesses: a batch with ANY x0 aboard dispatches
        # with an x0 operand — absent-x0 mates ride the zero vector
        # (the exact donor a no-x0 solve starts from, so their demuxed
        # results stay bit-identical); padding replicates the LAST
        # ticket's effective x0, mirroring the b padding law.  A batch
        # with no x0 calls the one-argument dispatch exactly as before
        # (bare-queue users bind single-arg dispatchers).
        any_x0 = any(t.x0 is not None for t in batch)
        x0b = None
        if bucket == 1:
            bb = batch[0].b             # 1-D legacy path, bit-for-bit
            if any_x0:
                x0b = batch[0].x0
        else:
            # pad with REPLICAS of the last request (a duplicate system
            # follows an identical trajectory and freezes with its twin;
            # a zero system would trip the p'Ap breakdown guard)
            bb = np.stack([t.b for t in batch]
                          + [batch[-1].b] * npad)
            if any_x0:
                eff = [t.x0 if t.x0 is not None
                       else np.zeros_like(t.b) for t in batch]
                x0b = np.stack(eff + [eff[-1]] * npad)
        t0 = time.perf_counter()
        for i, t in enumerate(batch):
            if t.trace is not None:
                t.trace.event("coalesced", index=i, batch=nreal,
                              bucket=bucket)
        res, err, meta = None, None, {}
        try:
            res = (self._dispatch(bb) if x0b is None
                   else self._dispatch(bb, x0b))
            if isinstance(res, tuple):      # (SolveResult, meta) form
                res, meta = res
        except AcgError as e:
            res = getattr(e, "result", None)
            err = e
            meta = getattr(e, "dispatch_meta", {})
        except Exception as e:          # never strand waiting tickets
            err = AcgError(Status.ERR_INVALID_VALUE,
                           f"dispatch failed: {e}")
        wall = time.perf_counter() - t0
        self._last_dispatch_t = time.perf_counter()
        self.counters["batches"] += 1
        self.counters["padded"] += npad
        self.counters["total_occupancy"] += nreal / bucket
        _M_BATCHES.labels(bucket=bucket).inc()
        _M_OCCUPANCY.observe(nreal / bucket)
        for i, t in enumerate(batch):
            t.index = i
            t.batch_size = nreal
            t.bucket = bucket
            t.dispatch_wall = wall
            t.depth_at_dispatch = left_behind
            t.dispatch_meta = meta
            t.queue_wait = t0 - t.enqueue_t
            self.counters["total_wait"] += t.queue_wait
            _M_WAIT.observe(t.queue_wait)
            if t.trace is not None:
                t.trace.event(
                    "dispatch", wall_ms=round(wall * 1e3, 3),
                    solver=meta.get("solver"),
                    cache_hit=bool(meta.get("cache_hit", False)))
            if res is not None:
                my = demux_result(res, i,
                                  bnrm2=float(np.linalg.norm(t.b)))
                if my.converged or err is None:
                    t.result_value = my
                    t.error = None
                else:
                    # per-request error carrying the demuxed partial
                    # result, like the plain solvers' AcgError contract
                    e = AcgError(my.status)
                    e.result = my
                    t.error = e
            else:
                t.error = err
            t.done = True
            if t.trace is not None:
                st = (t.result_value.status.name
                      if t.result_value is not None
                      else getattr(getattr(t.error, "status", None),
                                   "name", "ERR"))
                t.trace.event("demux", index=i, status=st)
        with self._cv:
            self._inflight -= len(batch)

    def stats(self) -> dict:
        c = self.counters
        nb = max(c["batches"], 1)
        ns = max(c["submitted"], 1)
        return {"submitted": c["submitted"], "batches": c["batches"],
                "padded_systems": c["padded"],
                "shed": c["shed"],
                "max_depth": c["max_depth"],
                "mean_wait_seconds": c["total_wait"] / ns,
                "mean_occupancy": c["total_occupancy"] / nb,
                "depth": self.depth,
                "inflight": self.inflight,
                "closed": self._closed}
